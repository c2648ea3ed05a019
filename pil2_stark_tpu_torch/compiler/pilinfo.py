"""Setup compiler top level: PIL → (starkInfo, expressionsInfo, verifierInfo).

Mirrors pil2-stark-js src/pil_info/pil_info.js:16-112 and
helpers/generatePilCode.js:6-36: preparePil → im-pols selection →
addIntermediatePolynomials → map → code generation (verifier evMap/qVerifier,
FRI polynomial + queryVerifier, im-pols per stage, committed expressions,
constraint debug code, hints info).
"""
from __future__ import annotations

from .prepare import prepare_pil, add_info_expressions_symbols
from .impols import calculate_intermediate_polynomials, add_intermediate_polynomials
from .mapping import map_info
from .cpoly import generate_fri_polynomial
from . import codegen


def generate_pil_code(res, symbols, constraints, expressions, hints, debug, stark):
    expressions_info = {}
    verifier_info = {}

    for e in expressions:
        add_info_expressions_symbols(symbols, expressions, e, stark)

    if not debug:
        codegen.generate_constraint_polynomial_verifier_code(
            res, verifier_info, symbols, expressions, stark
        )
        if stark:
            generate_fri_polynomial(res, symbols, expressions)
            add_info_expressions_symbols(
                symbols, expressions, expressions[res["friExpId"]], stark
            )
            codegen.generate_fri_verifier_code(res, verifier_info, symbols, expressions)

    expressions_info["imPolsCode"] = codegen.generate_im_polynomials_code(
        res, symbols, expressions, stark
    )
    expressions_info["expressionsCode"] = codegen.generate_expressions_code(
        res, symbols, expressions, stark
    )
    expressions_info["constraints"] = codegen.generate_constraints_debug_code(
        res, symbols, constraints, expressions, stark
    )
    expressions_info["hintsInfo"] = _add_hints_info(res, expressions, hints)

    return expressions_info, verifier_info


def _add_hints_info(res, expressions, hints):
    """generatePilCode.js:39-76."""
    hints_info = []
    for hint in hints:
        fields = []
        for field, value in hint.items():
            if field == "name":
                continue
            op = value["op"]
            if op == "exp":
                fields.append(
                    {
                        "name": field,
                        "op": "tmp",
                        "id": value["id"],
                        "dim": expressions[value["id"]].get("dim"),
                    }
                )
            elif op in ("cm", "challenge", "public", "subproofValue", "const"):
                fields.append({"name": field, "op": op, "id": value["id"]})
            elif op == "number":
                fields.append({"name": field, "op": "number", "value": value["value"]})
            else:
                raise ValueError(f"Invalid hint op: {op}")
        hints_info.append({"name": hint["name"], "fields": fields})
    res.pop("hints", None)
    return hints_info


def pil_info(pil, stark=True, stark_struct=None, options=None, pil2=False):
    """Main entry.  `pil` is the dict from the PIL1 front-end (or the
    flattened per-air pilout object from pil2_frontend.select_air)."""
    options = options or {}
    info = prepare_pil(pil, stark_struct, stark, options, pil2=pil2)
    expressions = info["expressions"]
    constraints = info["constraints"]
    hints = info["hints"]
    symbols = info["symbols"]
    res = info["res"]

    if stark:
        if options.get("debug"):
            # debug has no extension domain, so the bound is immaterial for
            # the constraint check — use a generous sweep so machines whose
            # leaf products exceed degree 2 (e.g. PlonK Qm·a·b) still get a
            # feasible im-pols selection.
            max_deg = 2 ** 3 + 1
        else:
            ss = res["starkStruct"]
            max_deg = (1 << (ss["nBitsExt"] - ss["nBits"])) + 1
    else:
        max_deg = 2 ** 3 + 1

    if not options.get("debug") or not options.get("skipImPols"):
        if options.get("optImPols"):
            from .impols_opt import optimize_im_pols

            im_info = optimize_im_pols(
                expressions, res["cExpId"], max_deg, res["qDim"]
            )
        else:
            im_info = calculate_intermediate_polynomials(
                expressions, res["cExpId"], max_deg, res["qDim"]
            )
        add_intermediate_polynomials(
            res,
            im_info["newExpressions"],
            constraints,
            symbols,
            im_info["imExps"],
            im_info["qDeg"],
            stark,
        )

    map_info(res, symbols, expressions, constraints, options)

    expressions_info, verifier_info = generate_pil_code(
        res, symbols, constraints, expressions, hints, options.get("debug"), stark
    )

    res.pop("nCommitments", None)
    res.pop("imPolsStages", None)
    if stark:
        # the fflonk tier sizes its domains from pilPower
        # (fflonk_shkey.js:19, fflonk_prover_helpers.js:35)
        res.pop("pilPower", None)

    return {
        "pilInfo": res,
        "expressionsInfo": expressions_info,
        "verifierInfo": verifier_info,
    }
