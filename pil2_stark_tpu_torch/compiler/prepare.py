"""Expression annotation + PIL normalization (the preparePil step).

Semantics mirror pil2-stark-js src/pil_info/helpers/helpers.js
(addInfoExpressions, getExpDim, addInfoExpressionsSymbols) and
preparePil.js:9-120: normalize a PIL1 `pil` dict into
{expressions, symbols, constraints, hints}, annotate degrees/dims/stages/
row-offsets, then build the composite constraint polynomial.

Nodes are mutable dicts shared by reference, exactly like the JS objects, so
in-place annotation and memoization behave identically.
"""
from __future__ import annotations

import copy
import json

from . import east
from .pil1_libs import generate_pil1_polynomials
from .cpoly import generate_constraint_polynomial
from .prepare_util import get_exp_dim_lazy as get_exp_dim


def add_info_expressions(expressions, exp, stark):
    """Annotate expDeg/dim/stage/rowsOffsets in place (helpers.js:83-151)."""
    if "expDeg" in exp:
        return

    if "next" in exp:
        exp["rowOffset"] = 1 if exp["next"] else 0
        del exp["next"]

    op = exp["op"]
    if op == "exp":
        add_info_expressions(expressions, expressions[exp["id"]], stark)
        sub = expressions[exp["id"]]
        exp["expDeg"] = sub["expDeg"]
        exp["rowsOffsets"] = sub.get("rowsOffsets")
        if not exp.get("dim"):
            exp["dim"] = sub.get("dim")
        if not exp.get("stage"):
            exp["stage"] = sub.get("stage")
    elif op in ("x", "cm", "const") or (
        op == "Zi" and exp.get("boundary") != "everyRow"
    ):
        exp["expDeg"] = 1
        if not exp.get("stage") or op == "const":
            exp["stage"] = 1 if op == "cm" else 0
        if not exp.get("dim"):
            exp["dim"] = 1
        if "rowOffset" in exp:
            exp["rowsOffsets"] = [exp["rowOffset"]]
    elif op in ("challenge", "eval", "subproofValue"):
        exp["expDeg"] = 0
        exp["dim"] = 3 if stark else 1
    elif op == "public":
        exp["expDeg"] = 0
        exp["stage"] = 1
        if not exp.get("dim"):
            exp["dim"] = 1
    elif op == "number" or (op == "Zi" and exp.get("boundary") == "everyRow"):
        exp["expDeg"] = 0
        exp["stage"] = 0
        if not exp.get("dim"):
            exp["dim"] = 1
    elif op in ("add", "sub", "mul", "neg"):
        if op == "neg":
            exp["op"] = "mul"
            exp["values"] = [
                {"op": "number", "value": "-1", "expDeg": 0, "stage": 0, "dim": 1},
                exp["values"][0],
            ]
        lhs, rhs = exp["values"][0], exp["values"][1]
        if exp["op"] == "add" and lhs["op"] == "number" and int(lhs["value"]) == 0:
            exp["op"] = "mul"
            lhs["value"] = "1"
        if (
            exp["op"] in ("add", "sub")
            and rhs["op"] == "number"
            and int(rhs["value"]) == 0
        ):
            exp["op"] = "mul"
            rhs["value"] = "1"
        add_info_expressions(expressions, lhs, stark)
        add_info_expressions(expressions, rhs, stark)
        if exp["op"] == "mul":
            exp["expDeg"] = lhs["expDeg"] + rhs["expDeg"]
        else:
            exp["expDeg"] = max(lhs["expDeg"], rhs["expDeg"])
        exp["dim"] = max(lhs.get("dim") or 1, rhs.get("dim") or 1)
        exp["stage"] = max(lhs.get("stage") or 0, rhs.get("stage") or 0)
        lro = lhs.get("rowsOffsets") or [0]
        rro = rhs.get("rowsOffsets") or [0]
        exp["rowsOffsets"] = sorted(set(lro) | set(rro))
    else:
        raise ValueError(f"Exp op not defined: {op}")


def add_info_expressions_symbols(symbols, expressions, exp, stark):
    """Collect the used-symbols list per expression (helpers.js:153-224)."""
    if "symbols" in exp:
        return

    op = exp["op"]
    if op == "exp":
        add_info_expressions_symbols(symbols, expressions, expressions[exp["id"]], stark)
        exp["symbols"] = list(expressions[exp["id"]].get("symbols") or [])
        if expressions[exp["id"]].get("imPol"):
            exp_sym = next(
                s for s in symbols if s["type"] == "witness" and s.get("expId") == exp["id"]
            )
            if not any(
                s["op"] == "cm"
                and s["stage"] == exp_sym["stage"]
                and s.get("stageId") == exp_sym.get("stageId")
                and s["id"] == exp_sym["polId"]
                for s in exp["symbols"]
            ):
                exp["symbols"].append(
                    {
                        "op": "cm",
                        "stage": exp_sym["stage"],
                        "stageId": exp_sym.get("stageId"),
                        "id": exp_sym["polId"],
                    }
                )
    elif op in ("cm", "const") and not exp.get("symbols"):
        if op == "cm":
            if exp.get("stageId") is None:
                sym = next(
                    s for s in symbols if s["type"] == "witness" and s["polId"] == exp["id"]
                )
                exp["stageId"] = sym.get("stageId")
            exp["symbols"] = [
                {"op": "cm", "stage": exp["stage"], "stageId": exp["stageId"], "id": exp["id"]}
            ]
        else:
            exp["symbols"] = [{"op": op, "stage": exp["stage"], "id": exp["id"]}]
    elif op in ("add", "sub", "mul", "neg"):
        out = []
        for v in exp["values"]:
            add_info_expressions_symbols(symbols, expressions, v, stark)
            if v["op"] in ("cm", "challenge"):
                if v.get("stageId") is None:
                    sym = next(
                        s for s in symbols if s["type"] == "witness" and s["polId"] == v["id"]
                    )
                    v["stageId"] = sym.get("stageId")
                out.append(
                    {"op": v["op"], "stage": v["stage"], "stageId": v["stageId"], "id": v["id"]}
                )
            elif v["op"] in ("public", "subproofValue", "const"):
                out.append({"op": v["op"], "stage": v.get("stage"), "id": v["id"]})
            elif v.get("symbols"):
                out.extend(v["symbols"])
        uniq = {json.dumps(s, sort_keys=True): s for s in out}
        order_names = ("const", "subproofValue", "public")

        def key(s):
            return (
                s.get("stage") or 0,
                # JS: b.op.localeCompare(a.op) — descending op name
                tuple(-ord(c) for c in s["op"]),
                s["id"] if s["op"] in order_names else (s.get("stageId") or 0),
            )

        exp["symbols"] = sorted(uniq.values(), key=key)


def prepare_pil(pil, stark_struct, stark, options=None, pil2=False):
    """preparePil.js:9-120 — PIL1 path and PIL2 pilout path."""
    options = options or {}
    res = {
        "name": pil.get("name", "air"),
        "imPolsStages": options.get("imPolsStages", False),
        "cmPolsMap": [],
        "constPolsMap": [],
        "challengesMap": [],
        "publicsMap": [],
        "subproofValuesMap": [],
        "pil2": pil2,
        "mapSectionsN": {"const": 0},
    }

    pil = copy.deepcopy(pil)
    if pil2:
        from .pil2_frontend import get_pilout_info

        out = get_pilout_info(res, pil, stark)
    else:
        for e in pil["expressions"]:
            e["stage"] = 1
        out = generate_pil1_polynomials(res, pil, stark, options)
    symbols = out["symbols"]
    hints = out["hints"]
    expressions = out["expressions"]
    constraints = out["constraints"]

    for s in range(1, res["nStages"] + 2):
        res["mapSectionsN"][f"cm{s}"] = 0

    if stark:
        if not options.get("debug"):
            res["starkStruct"] = stark_struct
            if stark_struct["nBits"] != res["pilPower"]:
                raise ValueError(
                    f"starkStruct and pilfile have degree mismatch "
                    f"(starkStruct:{stark_struct['nBits']} pilfile:{res['pilPower']})"
                )
            if stark_struct["nBitsExt"] != stark_struct["steps"][0]["nBits"]:
                raise ValueError("nBitsExt and first step mismatch")
        else:
            res["starkStruct"] = {"nBits": res["pilPower"]}

    for c in constraints:
        add_info_expressions(expressions, expressions[c["e"]], stark)
        c["stage"] = expressions[c["e"]]["stage"]

    for e in expressions:
        if "symbols" not in e:
            add_info_expressions(expressions, e, stark)

    res["boundaries"] = [{"name": "everyRow"}]

    opening_points = {0}
    for c in constraints:
        opening_points.update(expressions[c["e"]].get("rowsOffsets") or [0])
    res["openingPoints"] = sorted(opening_points)

    generate_constraint_polynomial(res, expressions, symbols, constraints, stark)

    return {
        "res": res,
        "expressions": expressions,
        "constraints": constraints,
        "symbols": symbols,
        "hints": hints,
    }
