"""Composite constraint polynomial C and DEEP/FRI polynomial builders.

Mirrors pil2-stark-js src/pil_info/helpers/polynomials/
constraintPolynomial.js:5-57 and friPolinomial.js:6-58:

- C = Σ vc^k · constraint_k · Zi_boundary  with the verifier challenge
  std_vc at stage nStages+1; boundaries registered on res.boundaries.
- FRI/DEEP composition: per opening point, fold (pol_k − eval_k) with vf2,
  multiply by xDivXSubXi(opening), fold openings with vf1 (challenges
  std_vf1/std_vf2 at stage nStages+3, std_xi at nStages+2).
"""
from __future__ import annotations

from . import east
from .prepare_util import get_exp_dim_lazy
from .impols import calculate_exp_deg


def generate_constraint_polynomial(res, expressions, symbols, constraints, stark):
    dim = 3 if stark else 1
    stage = res["nStages"] + 1

    vc_id = sum(
        1 for s in symbols if s["type"] == "challenge" and s["stage"] < stage
    )
    symbols.append(
        {"type": "challenge", "name": "std_vc", "stage": stage, "dim": 3, "stageId": 0, "id": vc_id}
    )
    vc = east.challenge("std_vc", stage, dim, 0, vc_id)
    vc["expDeg"] = 0

    res["cExpId"] = len(expressions)

    for c in constraints:
        boundary = c["boundary"]
        if boundary not in ("everyRow", "firstRow", "lastRow", "everyFrame"):
            raise ValueError(f"Boundary {boundary} not supported")
        if not stark and boundary != "everyRow":
            raise NotImplementedError(
                "the fflonk tier divides by Z_H only; boundary "
                f"'{boundary}' constraints require the STARK tier"
            )
        e = east.exp(c["e"], 0, stage)
        if boundary == "everyFrame":
            bid = next(
                (
                    i
                    for i, b in enumerate(res["boundaries"])
                    if b["name"] == "everyFrame"
                    and b.get("offsetMin") == c["offsetMin"]
                    and b.get("offsetMax") == c["offsetMax"]
                ),
                -1,
            )
            if bid == -1:
                res["boundaries"].append(
                    {"name": "everyFrame", "offsetMin": c["offsetMin"], "offsetMax": c["offsetMax"]}
                )
                bid = len(res["boundaries"]) - 1
            e = east.mul(e, east.zi(bid))
        elif boundary != "everyRow":
            bid = next(
                (i for i, b in enumerate(res["boundaries"]) if b["name"] == boundary), -1
            )
            if bid == -1:
                res["boundaries"].append({"name": boundary})
                bid = len(res["boundaries"]) - 1
            e = east.mul(e, east.zi(bid))
        if len(expressions) == res["cExpId"]:
            expressions.append(e)
        else:
            expressions[res["cExpId"]] = east.add(
                east.mul(vc, expressions[res["cExpId"]]), e
            )

    res["qDim"] = get_exp_dim_lazy(expressions, res["cExpId"], stark)

    xi_id = sum(
        1 for s in symbols if s["type"] == "challenge" and s["stage"] < stage + 1
    )
    symbols.append(
        {"type": "challenge", "name": "std_xi", "stage": stage + 1, "dim": 3, "stageId": 0, "id": xi_id}
    )

    # informational: max degree before im-pols bounding
    calculate_exp_deg(expressions, expressions[res["cExpId"]], [], True)


def generate_fri_polynomial(res, symbols, expressions):
    """friPolinomial.js:6-58 — requires res.evMap (set by the verifier-code
    emitter) and registers std_vf1/std_vf2."""
    stage = res["nStages"] + 3

    vf1_id = sum(1 for s in symbols if s["type"] == "challenge" and s["stage"] < stage)
    vf2_id = vf1_id + 1
    vf1_symbol = {"type": "challenge", "name": "std_vf1", "stage": stage, "dim": 3, "stageId": 0, "id": vf1_id}
    vf2_symbol = {"type": "challenge", "name": "std_vf2", "stage": stage, "dim": 3, "stageId": 1, "id": vf2_id}
    symbols.append(vf1_symbol)
    symbols.append(vf2_symbol)
    _set_map(res["challengesMap"], vf1_id, {"name": "std_vf1", "stage": stage, "dim": 3, "stageId": 0})
    _set_map(res["challengesMap"], vf2_id, {"name": "std_vf2", "stage": stage, "dim": 3, "stageId": 1})

    vf1 = east.challenge("std_vf1", stage, 3, 0, vf1_id)
    vf2 = east.challenge("std_vf2", stage, 3, 1, vf2_id)

    fri_exps = {}
    for i, ev in enumerate(res["evMap"]):
        if ev["type"] == "const":
            symbol = next(
                s
                for s in symbols
                if s.get("polId") == ev["id"]
                and s["type"] == "fixed"
                and s["airId"] == res["airId"]
                and s["subproofId"] == res["subproofId"]
            )
        else:
            symbol = next(
                s
                for s in symbols
                if s.get("polId") == ev["id"]
                and s["type"] != "fixed"
                and s["airId"] == res["airId"]
                and s["subproofId"] == res["subproofId"]
            )
        e = east.by_type(ev["type"], ev["id"], 0, symbol["stage"], symbol["dim"])
        prime = ev["prime"]
        if prime in fri_exps:
            fri_exps[prime] = east.add(
                east.mul(fri_exps[prime], vf2), east.sub(e, east.eval_(i, 3))
            )
        else:
            fri_exps[prime] = east.sub(e, east.eval_(i, 3))

    fri_exp = None
    # JS object key order: non-negative integer keys ascending first, then
    # other (negative) keys in insertion order.
    keys = sorted([k for k in fri_exps if k >= 0]) + [
        k for k in fri_exps if k < 0
    ]
    for opening in keys:
        index = res["openingPoints"].index(opening)
        fri_exps[opening] = east.mul(
            fri_exps[opening], east.x_div_x_sub_xi(opening, index)
        )
        if fri_exp is not None:
            fri_exp = east.add(east.mul(vf1, fri_exp), fri_exps[opening])
        else:
            fri_exp = fri_exps[opening]

    res["friExpId"] = len(expressions)
    expressions.append(fri_exp)
    expressions[res["friExpId"]]["dim"] = get_exp_dim_lazy(
        expressions, res["friExpId"], True
    )
    expressions[res["friExpId"]]["stage"] = res["nStages"] + 2


def _set_map(lst, idx, value):
    while len(lst) <= idx:
        lst.append(None)
    lst[idx] = value
