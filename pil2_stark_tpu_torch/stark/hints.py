"""Declarative witness-generation hints engine.

Mirrors pil2-stark-js src/prover/hints_helpers.js: resolves h1h2 (plookup
multiset halves), gprod (grand product), gsum (log-up grand sum) and
public/subproofValue hints once their inputs are ready, looping to fixpoint
inside each stage (prover.js:201-210).
"""
from __future__ import annotations

import numpy as np

from ..field import vf3
from ..ops import polutils
from . import expr_eval


def _field(hint, name):
    f = next((x for x in hint["fields"] if x["name"] == name), None)
    if f is None:
        raise ValueError(f"{name} field is missing")
    return f


def _get_value(ctx, hint, name):
    f = _field(hint, name)
    op = f["op"]
    if op == "const":
        return ctx.get_pol(f["id"], "n", is_fixed=True)
    if op == "cm":
        return ctx.get_pol(f["id"], "n")
    if op == "tmp":
        code = next(
            e for e in ctx.expressions_info["expressionsCode"] if e["expId"] == f["id"]
        )
        exec_fn = getattr(ctx, "exec_fn", None)
        if exec_fn is not None:  # field-specific executor (fflonk Fr ctx)
            return exec_fn(ctx, code["code"])
        return expr_eval.execute_code(ctx, code["code"], "n", ret=True)
    if op == "number":
        return int(f["value"])
    if op in ("subproofValue", "public"):
        return f
    raise ValueError("Case not considered")


def is_hint_resolved(ctx, hint) -> bool:
    name = _canon_name(hint["name"])
    if name in ("subproofValue", "public"):
        return ctx.is_symbol_calculated(_field(hint, "reference"))
    if name in ("gsum", "gprod"):
        return ctx.is_symbol_calculated(_field(hint, "reference"))
    if name == "h1h2":
        return ctx.is_symbol_calculated(
            _field(hint, "referenceH1")
        ) and ctx.is_symbol_calculated(_field(hint, "referenceH2"))
    raise ValueError(f"Unknown hint type {name}")


def _canon_name(name: str) -> str:
    return "subproofValue" if name.lower() == "subproofvalue" else name


def can_resolve_hint(ctx, hint, stage) -> bool:
    name = _canon_name(hint["name"])
    if name in ("subproofValue", "public"):
        expression = _field(hint, "expression")
        if expression["op"] == "cm" and not ctx.is_symbol_calculated(expression):
            return False
    elif name in ("gsum", "gprod"):
        for fname in ("numerator", "denominator"):
            f = _field(hint, fname)
            if f["op"] == "cm" and not ctx.is_symbol_calculated(f):
                return False
        ref = _field(hint, "reference")
        if ctx.pil_info["cmPolsMap"][ref["id"]]["stage"] != stage:
            return False
    elif name == "h1h2":
        for fname in ("f", "t"):
            f = _field(hint, fname)
            if f["op"] == "cm" and not ctx.is_symbol_calculated(f):
                return False
        h1 = _field(hint, "referenceH1")
        if ctx.pil_info["cmPolsMap"][h1["id"]]["stage"] != stage:
            return False
    else:
        raise ValueError(f"Unknown hint type {name}")
    return True


def resolve_hint(ctx, hint) -> None:
    name = _canon_name(hint["name"])
    if name == "subproofValue":
        pol = _get_value(ctx, hint, "expression")
        position = _get_value(ctx, hint, "row_index")
        value = pol[int(position)]
        ref = _field(hint, "reference")
        ctx.subproof_values[ref["id"]] = (
            tuple(int(x) for x in value) if hasattr(value, "__len__") else int(value)
        )
        ctx.set_symbol_calculated(ref)
    elif name == "public":
        pol = _get_value(ctx, hint, "expression")
        position = _get_value(ctx, hint, "row_index")
        value = pol[int(position)]
        pub = _get_value(ctx, hint, "reference")
        ctx.publics[pub["id"]] = int(value)
        ctx.set_symbol_calculated(pub)
    elif name in ("gsum", "gprod"):
        num = _get_value(ctx, hint, "numerator")
        den = _get_value(ctx, hint, "denominator")
        ops = getattr(ctx, "hint_ops", polutils)
        if name == "gprod":
            col = ops.calculate_z(np.asarray(num), np.asarray(den))
        else:
            col = ops.calculate_s(num, np.asarray(den))
        ref = _field(hint, "reference")
        ctx.set_pol(ref["id"], col, "n")
        if any(f["name"] == "result" for f in hint["fields"]):
            sv = _field(hint, "result")
            to_scalar = getattr(ctx, "to_scalar", vf3.to_scalar)
            ctx.subproof_values[sv["id"]] = to_scalar(col[ctx.N - 1])
            ctx.calculated["subproofValue"][sv["id"]] = True
    elif name == "h1h2":
        fvals = _get_value(ctx, hint, "f")
        tvals = _get_value(ctx, hint, "t")
        ops = getattr(ctx, "hint_ops", polutils)
        h1, h2 = ops.calculate_h1h2(_to_list(fvals), _to_list(tvals))
        ctx.set_pol(_field(hint, "referenceH1")["id"], h1, "n")
        ctx.set_pol(_field(hint, "referenceH2")["id"], h2, "n")
    else:
        raise ValueError(f"Hint {name} cannot be resolved.")


def _to_list(vals):
    vals = np.asarray(vals)
    if vals.ndim == 1:
        return [int(v) for v in vals]
    return [tuple(int(x) for x in row) for row in vals]


def apply_hints(ctx, stage) -> None:
    for hint in ctx.expressions_info["hintsInfo"]:
        if is_hint_resolved(ctx, hint):
            continue
        if can_resolve_hint(ctx, hint, stage):
            resolve_hint(ctx, hint)
