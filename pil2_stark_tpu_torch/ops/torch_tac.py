"""Device TAC executor: runs a setup-compiled TAC program as whole-column
torch ops on planar device sections.

Counterpart of pil2_stark_tpu/ops/jax_tac.py (``make_executor`` :53,
``pack_inputs`` :220) in its planar form: a section is a (cols, rows) int64
tensor, a value a (d, N) tensor with d in {1, 3} (field/torch_f3), and a
rotation reads row (i + prime·2^extendBits) mod N (torch.roll along the
row axis; prover_helpers.js getRef/evalMap).  The JAX package traces the
same instruction stream into one XLA program; here each instruction runs
eagerly (the TPU kernels are not on this path).
"""
from __future__ import annotations

import numpy as np
import torch

from ..field import gl64
from ..field import torch_gl as gl
from ..field import torch_f3 as f3g


def _shift_amount(prime, dom, n, extend_bits):
    if not prime:
        return 0
    if dom == "n":
        return prime % n
    return (prime << extend_bits) % n


def _roll(v, shift):
    return v if shift == 0 else torch.roll(v, -shift, dims=1)


def _zi_index(pil_info, boundary_id):
    boundary = pil_info["boundaries"][boundary_id]
    return next(
        i for i, b in enumerate(pil_info["boundaries"])
        if b["name"] == boundary["name"]
        and b.get("offsetMin") == boundary.get("offsetMin")
        and b.get("offsetMax") == boundary.get("offsetMax")
    )


def make_executor(code_obj, dom: str, pil_info: dict, n_bits: int, ext_bits: int | None):
    """Returns fn(inputs) for the TAC program `code_obj`.

    inputs: {"sections": {"const"|"cm1"|…: (cols, rows) tensor},
             "x": (N,), "Zi": (nBoundaries, extN), "xDivXSubXi": (nOpenings, 3, extN),
             "publics": (nPublics,), "challenges": (nChallenges, 3), "evals": (nEvals, 3)}
    Output: {"q": (d, N), "f": (3, N), "cm": {(section, offset, dim): (d, N)}}
    for whatever the program writes.
    """
    n = (1 << ext_bits) if dom == "ext" else (1 << n_bits)
    extend_bits = (ext_bits - n_bits) if ext_bits is not None else 0
    code = code_obj["code"]
    cm_map = pil_info["cmPolsMap"]

    def fn(inputs):
        device = inputs["x"].device
        tmp = {}
        out_cm = {}
        out = {}

        def section_cols(section, offset, dim, prime):
            sl = inputs["sections"][section][offset:offset + dim]
            return _roll(sl, _shift_amount(prime, dom, n, extend_bits))

        def get_ref(r):
            t = r["type"]
            if t == "tmp":
                return tmp[r["id"]]
            if t == "const":
                return section_cols("const", r["id"], 1, r.get("prime"))
            if t == "cm":
                p = cm_map[r["id"]]
                key = (f"cm{p['stage']}", p["stagePos"], p["dim"])
                if key in out_cm:
                    return _roll(out_cm[key], _shift_amount(r.get("prime"), dom, n, extend_bits))
                return section_cols(key[0], key[1], key[2], r.get("prime"))
            if t == "number":
                return torch.full((1, 1), gl.i64(int(r["value"])), dtype=torch.int64, device=device)
            if t == "public":
                return inputs["publics"][r["id"]].reshape(1, 1)
            if t == "challenge":
                return inputs["challenges"][r["id"]].reshape(3, 1)
            if t == "eval":
                return inputs["evals"][r["id"]].reshape(3, 1)
            if t == "xDivXSubXi":
                return inputs["xDivXSubXi"][r["id"]]
            if t == "x":
                return inputs["x"][None, :]
            if t == "Zi":
                return inputs["Zi"][_zi_index(pil_info, r["boundaryId"])][None, :]
            raise ValueError(f"Invalid ref type {t}")

        def full_rows(v, d):
            if v.shape[0] != d:
                v = torch.cat([v, torch.zeros((d - v.shape[0],) + v.shape[1:],
                                              dtype=torch.int64, device=device)])
            return v.expand(d, n).contiguous()

        def set_ref(r, val):
            t = r["type"]
            if t == "tmp":
                tmp[r["id"]] = val
                return
            if t in ("q", "f"):
                out[t] = full_rows(val, 3 if t == "f" else r["dim"])
                return
            if t == "cm":
                p = cm_map[r["id"]]
                shift = _shift_amount(r.get("prime"), dom, n, extend_bits)
                v = full_rows(val, p["dim"])
                if shift:
                    v = torch.roll(v, shift, dims=1)
                out_cm[(f"cm{p['stage']}", p["stagePos"], p["dim"])] = v
                return
            raise ValueError(f"Invalid dest type {t}")

        for inst in code:
            srcs = [get_ref(s) for s in inst["src"]]
            op = inst["op"]
            if op == "copy":
                res = srcs[0]
            elif op == "add":
                res = f3g.add(srcs[0], srcs[1])
            elif op == "sub":
                res = f3g.sub(srcs[0], srcs[1])
            elif op == "mul":
                res = f3g.mul(srcs[0], srcs[1])
            elif op == "muladd":
                res = f3g.muladd(srcs[0], srcs[1], srcs[2])
            else:
                raise ValueError(f"Invalid op {op}")
            set_ref(inst["dest"], res)

        out["cm"] = out_cm
        return out

    return fn


def _small(values, shape, device):
    arr = np.asarray(values, dtype=np.uint64).reshape(shape)
    return gl.from_u64(arr, device)


def pack_inputs(ctx, dom: str):
    """A ProverCtx's device buffers for make_executor.  Sections already on
    the device (ctx.dsections) pass as they are; a stage section that exists
    only on the host (the current stage's hint outputs) is uploaded
    transposed to the planar layout."""
    device = ctx.device
    sections = dict(ctx.dsections[dom])
    for i in range(ctx.pil_info["nStages"] + (1 if dom == "ext" else 0)):
        name = f"cm{i + 1}"
        if name in sections:
            continue
        buf = ctx.buffers.get(f"{name}_{dom}")
        if buf is not None:
            sections[name] = gl.from_u64(np.ascontiguousarray(buf.T), device)
    publics = [int(p or 0) % gl64.P_INT for p in ctx.publics]
    challenges = [list(c) for stage in ctx.challenges for c in stage] or [[0, 0, 0]]
    evals = [list(e) for e in ctx.evals] or [[0, 0, 0]]
    inputs = {
        "sections": sections,
        "x": ctx.dx[dom],
        "publics": _small(publics or [0], (-1,), device),
        "challenges": _small(challenges, (-1, 3), device),
        "evals": _small(evals, (-1, 3), device),
    }
    if dom == "ext":
        inputs["Zi"] = ctx.dZi
        inputs["xDivXSubXi"] = ctx.dxdiv
    return inputs
