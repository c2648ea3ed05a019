"""Fr prover context + TAC executor for the pil-fflonk tier.

Counterpart of initProverFflonk
(pil2-stark-js src/fflonk/helpers/fflonk_prover_helpers.js:10-140) and
the generic BigBuffer expression executor
(pil2-stark-js src/prover/prover_helpers.js:23-230) instantiated over
BN254-Fr.  Everything is dim-1 (Fr needs no extension tower — qDim = 1
when stark=False), columns are numpy object arrays of python ints, and
sizes are recursion-scale (N <= 2^17), so this is deliberately host code
— the same placement as the reference's WASM field ops.
"""
from __future__ import annotations

import numpy as np

from ..ops.fft_bn128 import FR, w
from ..protocol.shplonk import Keccak256Transcript


def fr_powers(base: int, n: int) -> np.ndarray:
    out = np.empty(n, dtype=object)
    acc = 1
    for i in range(n):
        out[i] = acc
        acc = acc * base % FR
    return out


class FrProverCtx:
    """Same addressing/symbol-tracking interface as stark.context.ProverCtx
    so the hints engine (stark/hints.py) runs unchanged over Fr."""

    def __init__(self, pil_info, expressions_info, zkey, debug=False):
        self.prover = "fflonk"
        self.pil_info = pil_info
        self.expressions_info = expressions_info
        self.zkey = zkey
        self.debug = debug

        self.n_bits = pil_info["pilPower"]
        self.N = 1 << self.n_bits
        self.n_bits_zk = pil_info["nBitsZK"]
        # ceil(log2(qDeg + 1)) (fflonk_prover_helpers.js:33)
        self.extend_bits_q = (pil_info["qDeg"]).bit_length()
        self.n_bits_coefs = self.n_bits + self.n_bits_zk
        self.n_bits_ext = self.n_bits + self.extend_bits_q + self.n_bits_zk
        self.extend_bits = self.n_bits_ext - self.n_bits
        self.N_coefs = 1 << self.n_bits_coefs
        self.ext_N = 1 << self.n_bits_ext

        self.tmp = []
        self.challenges = []
        self.publics = [None] * pil_info["nPublics"]
        self.subproof_values = [0] * pil_info.get("nSubproofValues", 0)
        self.evals = []
        self.errors = []
        self.calculated = {
            "public": [False] * pil_info["nPublics"],
            "const": [True] * pil_info["nConstants"],
            "subproofValue": [False] * pil_info.get("nSubproofValues", 0),
            "challenge": [False] * len(pil_info["challengesMap"]),
            "cm": [False] * len(pil_info["cmPolsMap"]),
        }

        n_constants = pil_info["nConstants"]
        self.const_n = np.array(
            zkey["constPolsEvals"], dtype=object
        ).reshape(self.N, n_constants) if n_constants else np.empty((self.N, 0), dtype=object)

        self.buffers = {}
        for i in range(pil_info["nStages"] + 1):
            stage = i + 1
            width = pil_info["mapSectionsN"][f"cm{stage}"]
            buf = np.empty((self.N, width), dtype=object)
            buf[:] = 0
            self.buffers[f"cm{stage}_n"] = buf
            ext = np.empty((self.ext_N, width), dtype=object)
            ext[:] = 0
            self.buffers[f"cm{stage}_ext"] = ext
        self.q_ext = np.empty((self.ext_N, 1), dtype=object)
        self.q_ext[:] = 0

        if n_constants:
            self.const_ext = np.array(
                zkey["constPolsEvalsExt"], dtype=object
            ).reshape(self.ext_N, n_constants)
        else:
            self.const_ext = np.empty((self.ext_N, 0), dtype=object)

        self.x_n = fr_powers(w(self.n_bits), self.N)
        self.x_ext = fr_powers(w(self.n_bits_ext), self.ext_N)

        # name -> coefficient list, for shplonk commit/open
        self.pols = {}
        self.committed_pols = {}
        self.non_committed_pols = []

        self.transcript = Keccak256Transcript()

        # hints-engine dispatch hooks (stark/hints.py)
        from . import fr_hints
        self.hint_ops = fr_hints
        self.exec_fn = lambda c, code: execute_code(c, code, "n", ret=True)
        self.to_scalar = lambda v: int(v) % FR

    # -- addressing (same shape as ProverCtx) -------------------------------

    def buffer(self, section, dom):
        if section == "const":
            return self.const_n if dom == "n" else self.const_ext
        return self.buffers[f"{section}_{dom}"]

    def get_pol_ref(self, pol_id, dom, is_fixed=False):
        deg = self.ext_N if dom == "ext" else self.N
        if is_fixed:
            return {"buffer": self.buffer("const", dom), "deg": deg,
                    "offset": pol_id, "dim": 1, "stage": "const"}
        p = self.pil_info["cmPolsMap"][pol_id]
        section = f"cm{p['stage']}"
        return {"buffer": self.buffer(section, dom), "deg": deg,
                "offset": p["stagePos"], "dim": 1, "stage": section}

    def get_pol(self, pol_id, dom, is_fixed=False):
        p = self.get_pol_ref(pol_id, dom, is_fixed)
        return p["buffer"][:, p["offset"]].copy()

    def set_pol(self, pol_id, values, dom):
        p = self.get_pol_ref(pol_id, dom)
        p["buffer"][:, p["offset"]] = [int(v) % FR for v in values]
        self.calculated["cm"][pol_id] = True

    # -- symbol tracking ----------------------------------------------------

    def is_symbol_calculated(self, ref):
        if ref["op"] == "tmp":
            return True
        return self.calculated[ref["op"]][ref["id"]]

    def set_symbol_calculated(self, ref):
        if ref["op"] != "tmp":
            self.calculated[ref["op"]][ref["id"]] = True

    def stage_symbols_missing(self, stage):
        missing = 0
        for i, p in enumerate(self.pil_info["cmPolsMap"]):
            if p["stage"] != stage or p.get("imPol"):
                continue
            if not self.calculated["cm"][i]:
                missing += 1
        for i, c in enumerate(self.pil_info["challengesMap"]):
            if c["stage"] == stage and not self.calculated["challenge"][i]:
                missing += 1
        if stage == 1:
            for i in range(self.pil_info["nPublics"]):
                if not self.calculated["public"][i]:
                    missing += 1
        if stage == self.pil_info["nStages"]:
            for i in range(self.pil_info.get("nSubproofValues", 0)):
                if not self.calculated["subproofValue"][i]:
                    missing += 1
        return missing


# ---------------------------------------------------------------------------
# TAC executor over Fr object arrays
# ---------------------------------------------------------------------------


def _shift_amount(prime, ctx, dom):
    if not prime:
        return 0
    if dom == "n":
        return -int(prime)
    return -int(prime) * (1 << ctx.extend_bits)


def _roll_read(col, shift):
    if shift == 0:
        return col
    return np.roll(col, shift)


def get_ref(ctx, r, dom):
    t = r["type"]
    if t == "tmp":
        return ctx.tmp[r["id"]]
    if t == "const":
        col = ctx.buffer("const", dom)[:, r["id"]]
        return _roll_read(col, _shift_amount(r.get("prime"), ctx, dom))
    if t == "cm":
        p = ctx.get_pol_ref(r["id"], dom)
        col = p["buffer"][:, p["offset"]]
        return _roll_read(col, _shift_amount(r.get("prime"), ctx, dom))
    if t == "number":
        return int(r["value"]) % FR
    if t == "public":
        return int(ctx.publics[r["id"]]) % FR
    if t == "challenge":
        return ctx.challenges[r["stage"] - 1][r["stageId"]]
    if t == "x":
        return ctx.x_n if dom == "n" else ctx.x_ext
    if t == "subproofValue":
        return int(ctx.subproof_values[r["id"]]) % FR
    if t == "eval":
        return ctx.evals[r["id"]]
    raise ValueError(f"Invalid reference type get: {t}")


def set_ref(ctx, r, val, dom):
    t = r["type"]
    if t == "tmp":
        ctx.tmp[r["id"]] = val
        return
    if t == "q":
        if dom != "ext":
            raise ValueError("Accessing q in domain n")
        n = ctx.ext_N
        ctx.q_ext[:, 0] = val if isinstance(val, np.ndarray) else np.full(n, val, dtype=object)
        return
    if t == "cm":
        p = ctx.get_pol_ref(r["id"], dom)
        shift = _shift_amount(r.get("prime"), ctx, dom)
        v = val if isinstance(val, np.ndarray) else np.full(p["deg"], val, dtype=object)
        if shift:
            v = np.roll(v, -shift)
        p["buffer"][:, p["offset"]] = v
        return
    raise ValueError(f"Invalid reference type set: {t}")


def execute_code(ctx, code_obj, dom, ret=False):
    """Run a TAC program column-vectorized over Fr."""
    code = code_obj["code"] if isinstance(code_obj, dict) else code_obj
    tmp_used = code_obj.get("tmpUsed", 0) if isinstance(code_obj, dict) else 0
    if len(ctx.tmp) < tmp_used:
        ctx.tmp.extend([None] * (tmp_used - len(ctx.tmp)))
    res = None
    for inst in code:
        src = [get_ref(ctx, s, dom) for s in inst["src"]]
        op = inst["op"]
        if op == "add":
            v = _mod(src[0] + src[1])
        elif op == "sub":
            v = _mod(src[0] - src[1])
        elif op == "mul":
            v = _mod(src[0] * src[1])
        elif op == "muladd":
            v = _mod(src[0] * src[1] + src[2])
        elif op == "copy":
            v = src[0]
        else:
            raise ValueError(f"Invalid op: {op}")
        set_ref(ctx, inst["dest"], v, dom)
        res = (inst["dest"], v)
    if ret and res is not None:
        return get_ref(ctx, res[0], dom)
    return None


def _mod(v):
    if isinstance(v, np.ndarray):
        return np.mod(v, FR)
    return v % FR


def check_constraint(ctx, constraint, dom="n"):
    """Debug-mode constraint check (prover.js:222-229 over Fr)."""
    vals = execute_code(ctx, constraint, dom, ret=True)
    vals = vals if isinstance(vals, np.ndarray) else np.full(ctx.N, vals, dtype=object)
    errors = []
    first = constraint.get("boundary", "everyRow")
    for i in range(ctx.N):
        if vals[i] % FR != 0:
            errors.append(
                f"Constraint (boundary {first}, line {constraint.get('line')}) "
                f"fails at row {i}: {vals[i]}"
            )
            if len(errors) > 10:
                break
    return errors
