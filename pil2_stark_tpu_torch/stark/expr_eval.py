"""Host TAC evaluator for the hints: runs a setup-compiled program over the
base domain with numpy Goldilocks/extension ops, every instruction a
whole-column vector op, rotations np.roll.

Host copy of pil2_stark_tpu/stark/expr_eval.py, base domain only (the
extended-domain programs run on the device, ops/torch_tac.py), with the
debug mode's constraint check (``check_constraint``).  Operand
addressing mirrors pil2-stark-js src/prover/prover_helpers.js:31-107:
section-major buffers with stagePos offsets, rotation (i + prime) mod N.
"""
from __future__ import annotations

import numpy as np

from ..field import gl64, vf3


def _roll_read(col: np.ndarray, shift: int):
    """value[i] = col[(i + shift) % N]."""
    if shift == 0:
        return col
    return np.roll(col, -shift, axis=0)


def _shift_amount(prime, ctx, dom):
    if not prime:
        return 0
    if dom == "n":
        n = ctx.N
        return prime % n
    return (prime << ctx.extend_bits) % ctx.ext_N


def _col(buf: np.ndarray, offset: int, dim: int):
    if dim == 1:
        return buf[:, offset]
    return buf[:, offset : offset + dim]


def get_ref(ctx, r, dom):
    t = r["type"]
    if t == "tmp":
        return ctx.tmp[r["id"]]
    if t == "const":
        buf = ctx.buffer("const", dom)
        col = buf[:, r["id"]]
        return _roll_read(col, _shift_amount(r.get("prime"), ctx, dom))
    if t == "cm":
        p = ctx.get_pol_ref(r["id"], dom)
        col = _col(p["buffer"], p["offset"], p["dim"])
        return _roll_read(col, _shift_amount(r.get("prime"), ctx, dom))
    if t == "number":
        return np.uint64(int(r["value"]) % gl64.P_INT)
    if t == "public":
        return np.uint64(int(ctx.publics[r["id"]]) % gl64.P_INT)
    if t == "challenge":
        return np.array(ctx.challenges[r["stage"] - 1][r["stageId"]], dtype=np.uint64)
    if t == "eval":
        return np.array(ctx.evals[r["id"]], dtype=np.uint64)
    if t == "x":
        return ctx.x_n
    if t == "subproofValue":
        return np.array(ctx.subproof_values[r["id"]], dtype=np.uint64)
    raise ValueError(f"Invalid reference type get: {t}")


def set_ref(ctx, r, val, dom):
    t = r["type"]
    if t == "tmp":
        ctx.tmp[r["id"]] = val
        return
    if t == "cm":
        p = ctx.get_pol_ref(r["id"], dom)
        shift = _shift_amount(r.get("prime"), ctx, dom)
        v = _as_dim(val, p["dim"], p["deg"])
        if shift:
            v = np.roll(v, shift, axis=0)
        if p["dim"] == 1:
            p["buffer"][:, p["offset"]] = v
        else:
            p["buffer"][:, p["offset"] : p["offset"] + p["dim"]] = v
        return
    raise ValueError(f"Invalid reference type set: {t}")


def _as_dim(val, dim, n):
    val = np.asarray(val, dtype=np.uint64)
    if dim == 3:
        v3 = vf3.as3(val)
        if v3.ndim == 1:
            v3 = np.broadcast_to(v3, (n, 3))
        return v3
    if val.ndim == 0:
        return np.broadcast_to(val, (n,))
    return val


_OPS = {
    "add": vf3.add,
    "sub": vf3.sub,
    "mul": vf3.mul,
}


def execute_code(ctx, code_obj, dom, ret=False):
    """Run a TAC program over the whole domain; optionally return the last
    destination's value (per-row vector)."""
    ctx.tmp = [None] * code_obj["tmpUsed"]
    code = code_obj["code"]
    for inst in code:
        srcs = [get_ref(ctx, s, dom) for s in inst["src"]]
        op = inst["op"]
        if op == "copy":
            res = srcs[0]
        elif op == "muladd":
            res = vf3.add(vf3.mul(srcs[0], srcs[1]), srcs[2])
        else:
            res = _OPS[op](srcs[0], srcs[1])
        set_ref(ctx, inst["dest"], res, dom)
    if ret:
        out = get_ref(ctx, code[-1]["dest"], dom)
        n = ctx.N
        out = np.asarray(out, dtype=np.uint64)
        if out.ndim == 0:
            out = np.broadcast_to(out, (n,)).copy()
        elif out.shape[0] != n:
            out = np.broadcast_to(out, (n,) + out.shape).copy()
        return out
    return None


def check_constraint(ctx, code_obj):
    """Debug-mode constraint check (pil2_stark_tpu/stark/expr_eval.py:159-188,
    prover_helpers.js:46-70) on the base domain: evaluate the constraint
    everywhere, then report the first 10 non-zero rows of its boundary
    range."""
    vals = execute_code(ctx, code_obj, "n", ret=True)
    n = ctx.N
    boundary = code_obj.get("boundary", "everyRow")
    if boundary == "everyRow":
        first, last = 0, n
    elif boundary in ("firstRow", "finalProof"):
        first, last = 0, 1
    elif boundary == "lastRow":
        first, last = n - 1, n
    elif boundary == "everyFrame":
        first, last = code_obj["offsetMin"], n - code_obj["offsetMax"]
    else:
        raise ValueError(f"Invalid boundary: {boundary}")
    window = vals[first:last]
    nonzero = (
        np.nonzero(window)[0] if window.ndim == 1 else np.nonzero(window.any(axis=1))[0]
    )
    errors = []
    for i in nonzero[:10]:
        row = first + int(i)
        errors.append(
            f"{code_obj.get('line')}: identity does not match w={row} "
            f"val={vals[row]}"
        )
    return errors
