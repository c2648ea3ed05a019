"""Intermediate-polynomial selection (degree bounding of the composite
constraint polynomial).

Mirrors pil2-stark-js src/pil_info/imPolsCalculation/imPolynomials.js:
a recursive min-cut over the multiplication structure of C chooses which
sub-expressions become committed "im" columns so deg(C) ≤ maxDeg, sweeping
candidate degrees 2..maxQDeg and picking the one that adds the fewest
base-field columns (qDeg·qDim + Σ dim(im)).  addIntermediatePolynomials then
rewrites C ← vc·C + (cm_im − expr) per im and divides by the everyRow
zerofier, appending the Q_i witness symbols.
"""
from __future__ import annotations

import json

from . import east
from .prepare_util import get_exp_dim_lazy


def calculate_exp_deg(expressions, exp, im_exps=None, cache_values=False):
    im_exps = im_exps or []
    if cache_values and exp.get("degree_") is not None:
        return exp["degree_"]
    op = exp["op"]
    if op == "exp":
        if exp["id"] in im_exps:
            return 1
        deg = calculate_exp_deg(expressions, expressions[exp["id"]], im_exps, cache_values)
        if cache_values:
            exp["degree_"] = deg
        return deg
    if op in ("x", "const", "cm") or (op == "Zi" and exp.get("boundary") != "everyRow"):
        return 1
    if op in ("number", "public", "challenge", "eval", "subproofValue") or (
        op == "Zi" and exp.get("boundary") == "everyRow"
    ):
        return 0
    if op == "neg":
        return calculate_exp_deg(expressions, exp["values"][0], im_exps, cache_values)
    if op in ("add", "sub", "mul"):
        lhs = calculate_exp_deg(expressions, exp["values"][0], im_exps, cache_values)
        rhs = calculate_exp_deg(expressions, exp["values"][1], im_exps, cache_values)
        deg = lhs + rhs if op == "mul" else max(lhs, rhs)
        if cache_values:
            exp["degree_"] = deg
        return deg
    raise ValueError(f"Exp op not defined: {op}")


def calculate_intermediate_polynomials(expressions, c_exp_id, max_q_deg, q_dim):
    """imPolynomials.js:86-109 — sweep degrees, keep the cheapest.

    A candidate degree can be infeasible (the min-cut returns False) when a
    product of LEAF columns alone exceeds it — e.g. the PlonK identity
    Qm·a·b at d=2: there is no expression node to cut.  Such degrees are
    skipped (the reference crashes on them; no test exercises that path)."""
    d = 2
    c_exp = expressions[c_exp_id]
    im_exps, q_deg = False, -1
    added = None
    while d <= max_q_deg:
        im_exps_p, q_deg_p = _calculate_im_pols(expressions, c_exp, d)
        d += 1
        if im_exps_p is False:
            continue
        new_added = _added_cols(expressions, im_exps_p, q_deg_p, q_dim)
        if added is None or new_added < added:
            added = new_added
            im_exps, q_deg = im_exps_p, q_deg_p
        if len(im_exps_p) == 0:
            break
    if im_exps is False:
        raise ValueError(
            f"Constraint degree cannot be bounded by maxDeg={max_q_deg}"
        )
    return {"newExpressions": expressions, "imExps": im_exps, "qDeg": q_deg}


def _added_cols(expressions, im_exps, q_deg, q_dim):
    return q_deg * q_dim + sum(expressions[i]["dim"] for i in im_exps)


def _calculate_im_pols(expressions, top_exp, max_deg):
    """imPolynomials.js:123-203 — recursive min-cut with memoization."""
    absolute_max = max_deg
    state = {"abs_max_d": 0}

    def rec(exp, im_pols, bound):
        if im_pols is False:
            return False, -1
        op = exp["op"]
        if op in ("add", "sub"):
            md = 0
            for v in exp["values"]:
                im_pols, d = rec(v, im_pols, bound)
                if d > md:
                    md = d
            return im_pols, md
        if op == "mul":
            eb, ed = False, -1
            v0, v1 = exp["values"]
            if v0["op"] not in ("add", "mul", "sub", "exp") and v0.get("expDeg") == 0:
                return rec(v1, im_pols, bound)
            if v1["op"] not in ("add", "mul", "sub", "exp") and v1.get("expDeg") == 0:
                return rec(v0, im_pols, bound)
            # wrapper nodes created after annotation (constraint·Zi) have no
            # expDeg; JS `undefined <= maxDeg` is false — recurse into them
            exp_deg = exp.get("expDeg")
            if exp_deg is not None and exp_deg <= bound:
                return im_pols, exp_deg
            for l in range(bound + 1):
                r = bound - l
                e1, d1 = rec(v0, im_pols, l)
                e2, d2 = rec(v1, e1, r)
                if e2 is not False and (eb is False or len(e2) < len(eb)):
                    eb, ed = e2, d1 + d2
                if eb is not False and len(eb) == len(im_pols):
                    return eb, ed  # cannot do better
            return eb, ed
        if op == "exp":
            if bound < 1:
                return False, -1
            if exp["id"] in im_pols:
                return im_pols, 1
            memo = exp.setdefault("res_", {}).setdefault(absolute_max, {})
            key = json.dumps(im_pols)
            if key in memo:
                e, d = memo[key]
            else:
                e, d = rec(expressions[exp["id"]], im_pols, absolute_max)
            if e is False:
                return False, -1
            if d > bound:
                if d > state["abs_max_d"]:
                    state["abs_max_d"] = d
                return [*e, exp["id"]], 1
            memo[key] = (e, d)
            return memo[key]
        # leaf
        if exp.get("expDeg") == 0:
            return im_pols, 0
        if bound < 1:
            return False, -1
        return im_pols, 1

    re_, rd = rec(top_exp, [], max_deg)
    return re_, max(rd, state["abs_max_d"]) - 1


def add_intermediate_polynomials(res, expressions, constraints, symbols, im_exps, q_deg, stark):
    """imPolynomials.js:6-84."""
    from .prepare import add_info_expressions

    res["qDeg"] = q_deg
    dim = 3 if stark else 1
    stage = res["nStages"] + 1

    vc = east.challenge("std_vc", stage, dim, 0, None)
    vc_id = sum(1 for s in symbols if s["type"] == "challenge" and s["stage"] < stage)
    vc["id"] = vc_id
    vc["expDeg"] = 0

    max_deg_expr = calculate_exp_deg(expressions, expressions[res["cExpId"]], im_exps)
    if max_deg_expr > q_deg + 1:
        raise ValueError(
            f"Constraint expression degree {max_deg_expr} exceeds allowed {q_deg + 1}"
        )
    for exp_id in im_exps:
        d = calculate_exp_deg(expressions, expressions[exp_id], im_exps)
        if d > q_deg + 1:
            raise ValueError(f"Intermediate polynomial {exp_id} degree {d} too high")

    for exp_id in im_exps:
        stage_im = expressions[exp_id]["stage"] if res["imPolsStages"] else res["nStages"]
        stage_id = sum(
            1 for s in symbols if s["type"] == "witness" and s["stage"] == stage_im
        )
        d = get_exp_dim_lazy(expressions, exp_id, stark)
        symbols.append(
            {
                "type": "witness",
                "name": f"{res['name']}.ImPol",
                "expId": exp_id,
                "polId": res["nCommitments"],
                "stage": stage_im,
                "stageId": stage_id,
                "dim": d,
                "imPol": True,
                "airId": res["airId"],
                "subproofId": res["subproofId"],
            }
        )
        res["nCommitments"] += 1

        expressions[exp_id]["imPol"] = True
        expressions[exp_id]["polId"] = res["nCommitments"] - 1
        expressions[exp_id]["stage"] = stage_im

        e = {
            "op": "sub",
            "values": [
                east.cm(res["nCommitments"] - 1, 0, stage_im, d),
                dict(expressions[exp_id]),
            ],
        }
        expressions.append(e)
        add_info_expressions(expressions, e, stark)

        constraints.append(
            {
                "e": len(expressions) - 1,
                "boundary": "everyRow",
                "filename": f"{res['name']}.ImPol",
                "stage": expressions[exp_id]["stage"],
            }
        )
        expressions[res["cExpId"]] = east.add(
            east.mul(vc, expressions[res["cExpId"]]), e
        )

    if stark:
        every_row = next(
            i for i, b in enumerate(res["boundaries"]) if b["name"] == "everyRow"
        )
        expressions[res["cExpId"]] = east.mul(
            expressions[res["cExpId"]], east.zi(every_row)
        )
    # fflonk mode: Q = C/Z_H is an exact coefficient division in the
    # prover (fflonk divZh) and the verifier multiplies by invZh, so the
    # constraint expression must NOT carry the Zi factor.  (The
    # reference's current pil_info would emit a Zi reference that neither
    # initProverFflonk nor fflonk_verify.js's executeCode can resolve —
    # bit-rotted fflonk path; we implement the consistent scheme.)
    expressions[res["cExpId"]]["stage"] = res["nStages"] + 1

    c_dim = get_exp_dim_lazy(expressions, res["cExpId"], stark)
    expressions[res["cExpId"]]["dim"] = c_dim
    res["qDim"] = c_dim

    if stark:
        for i in range(res["qDeg"]):
            index = res["nCommitments"]
            res["nCommitments"] += 1
            symbols.append(
                {
                    "type": "witness",
                    "name": f"Q{i}",
                    "polId": index,
                    "stage": stage,
                    "dim": res["qDim"],
                    "airId": res["airId"],
                    "subproofId": res["subproofId"],
                }
            )
