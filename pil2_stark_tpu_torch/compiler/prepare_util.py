"""Shared expression-dimension computation (helpers.js getExpDim), kept in
its own module to avoid a prepare ↔ pil1_libs import cycle."""
from __future__ import annotations


def get_exp_dim_lazy(expressions, exp_id, stark):
    def rec(exp):
        if exp.get("dim") is not None:
            return exp["dim"]
        op = exp["op"]
        if op in ("add", "sub", "mul", "muladd"):
            return max(rec(v) for v in exp["values"])
        if op == "neg":
            return rec(exp["values"][0])
        if op == "exp":
            exp["dim"] = rec(expressions[exp["id"]])
            return exp["dim"]
        if op == "cm":
            return exp.get("dim") or 1
        if op in ("const", "number", "public", "x", "Zi"):
            return 1
        if op in ("challenge", "eval", "xDivXSubXi"):
            return 3 if stark else 1
        raise ValueError(f"Exp op not defined: {op}")

    return rec(expressions[exp_id])
