"""Optimal intermediate-polynomial selection (branch-and-bound).

Drop-in replacement for the min-cut heuristic in `impols.py`, enabled with
`options={"optImPols": True}`.  Solves the same optimization the reference
ships as an offline z3 script (pil2-stark-js src/pil_info/imPolsCalculation/
calculateImPols.py:159-208: choose which shared sub-expressions to commit as
degree-1 "im" columns so every constraint-degree bound d in 2..maxDeg is met,
minimizing added base-field columns (d−1)·qDim + Σ dim(im); keep the best d).
z3 is not a dependency of this package, so the keep-set is found with an
exact hitting-set branch-and-bound instead of an SMT encoding:

- a "violation witness" is the set of exp-nodes along one maximal-degree
  path of the constraint DAG; any feasible keep-set must contain at least
  one of them (committing a node caps its subtree's degree at 1), so we
  branch on its members and prune by best-known weight;
- the search is seeded with the min-cut heuristic's solution, so the
  optimizer NEVER returns a worse selection than `impols.py` (asserted);
- a node budget bounds worst-case blowup; on exhaustion the incumbent
  (≥ heuristic quality) is returned.
"""
from __future__ import annotations

from . import impols

# Upper bound on branch-and-bound recursions per degree candidate.  The
# search space is 2^|shared exps|; real machines have tens of shared
# expressions and converge in far fewer nodes.
_NODE_BUDGET = 200_000


def _shared_exp_ids(expressions, c_exp_id):
    """Every expression id reachable from the constraint via `exp` nodes."""
    seen = set()
    stack = [expressions[c_exp_id]]
    while stack:
        e = stack.pop()
        op = e["op"]
        if op == "exp":
            i = e["id"]
            if i not in seen:
                seen.add(i)
                stack.append(expressions[i])
        elif op in ("add", "sub", "mul", "neg"):
            stack.extend(e["values"])
    return seen


def _degree(expressions, exp, keep, memo):
    """Degree of `exp` when every id in `keep` is committed (degree 1)."""
    op = exp["op"]
    if op == "exp":
        i = exp["id"]
        if i in keep:
            return 1
        if i in memo:
            return memo[i]
        d = _degree(expressions, expressions[i], keep, memo)
        memo[i] = d
        return d
    if op == "neg":
        return _degree(expressions, exp["values"][0], keep, memo)
    if op in ("add", "sub"):
        return max(_degree(expressions, v, keep, memo) for v in exp["values"])
    if op == "mul":
        a, b = exp["values"]
        return _degree(expressions, a, keep, memo) + _degree(
            expressions, b, keep, memo
        )
    return impols.calculate_exp_deg(expressions, exp)  # leaf


def _witness(expressions, exp, keep, bound, memo):
    """Exp-node ids along one degree-overflow path (the hitting-set row).
    Empty result ⇒ the overflow comes from leaves alone ⇒ infeasible."""
    op = exp["op"]
    if op == "exp":
        i = exp["id"]
        if i in keep:
            return []
        return [i] + _witness(expressions, expressions[i], keep, bound, memo)
    if op == "neg":
        return _witness(expressions, exp["values"][0], keep, bound, memo)
    if op in ("add", "sub"):
        worst = max(
            exp["values"], key=lambda v: _degree(expressions, v, keep, memo)
        )
        return _witness(expressions, worst, keep, bound, memo)
    if op == "mul":
        out = []
        for v in exp["values"]:
            out.extend(_witness(expressions, v, keep, bound, memo))
        return out
    return []


def _min_keep_set(expressions, c_exp_id, bound, seed):
    """Exact min-weight keep-set with deg(C) ≤ bound, or None if infeasible.
    `seed` (a feasible set or None) initializes the incumbent."""

    def weight(s):
        return sum(expressions[i]["dim"] for i in s)

    best = {"set": set(seed) if seed is not None else None}
    if best["set"] is not None:
        best["w"] = weight(best["set"])
    budget = {"n": _NODE_BUDGET}

    def violation(keep, memo):
        """A violated (sub)constraint's root, or None if keep is feasible.
        Each committed im body must itself respect the bound (its identity
        cm − expr becomes a constraint, imPolynomials.js:6-84)."""
        if _degree(expressions, expressions[c_exp_id], keep, memo) > bound:
            return expressions[c_exp_id]
        for i in keep:
            if _degree(expressions, expressions[i], keep, memo) > bound:
                return expressions[i]
        return None

    def search(keep):
        if budget["n"] <= 0:
            return
        budget["n"] -= 1
        w = weight(keep)
        if best["set"] is not None and w >= best["w"]:
            return  # dominated — any extension only adds weight
        memo = {}
        bad = violation(keep, memo)
        if bad is None:
            best["set"], best["w"] = set(keep), w
            return
        row = _witness(expressions, bad, keep, bound, memo)
        # dedupe; try cheap nodes first
        row = sorted(set(row) - keep, key=lambda i: expressions[i]["dim"])
        for cand in row:
            keep.add(cand)
            search(keep)
            keep.remove(cand)

    search(set())
    return best["set"]


def optimize_im_pols(expressions, c_exp_id, max_deg, q_dim):
    """Same contract as impols.calculate_intermediate_polynomials, with an
    exact search per candidate degree.  Never worse than the heuristic."""
    # incumbent from the heuristic (also validates feasibility of max_deg)
    heur = impols.calculate_intermediate_polynomials(
        expressions, c_exp_id, max_deg, q_dim
    )
    heur_added = heur["qDeg"] * q_dim + sum(
        expressions[i]["dim"] for i in heur["imExps"]
    )

    best = None
    for d in range(2, max_deg + 1):
        seed = heur["imExps"] if heur["qDeg"] + 1 <= d else None
        keep = _min_keep_set(expressions, c_exp_id, d, seed)
        if keep is None:
            continue
        # actual achieved degree can undershoot the bound; the im identities
        # cm − expr are constraints too, so they count toward it
        memo = {}
        achieved = _degree(expressions, expressions[c_exp_id], keep, memo)
        for i in keep:
            achieved = max(
                achieved, _degree(expressions, expressions[i], keep, memo)
            )
        q_deg = max(achieved, 2) - 1
        added = q_deg * q_dim + sum(expressions[i]["dim"] for i in keep)
        if best is None or added < best["added"]:
            best = {"imExps": sorted(keep), "qDeg": q_deg, "added": added}
        if not keep:
            break

    assert best is not None, "optimizer found no feasible degree"
    assert best["added"] <= heur_added, (
        f"optimizer regressed vs min-cut: {best['added']} > {heur_added}"
    )
    return {
        "newExpressions": expressions,
        "imExps": list(best["imExps"]),
        "qDeg": best["qDeg"],
    }
