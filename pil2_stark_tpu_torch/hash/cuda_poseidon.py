"""Kernel B4: the width-12 Poseidon-GL permutation (csrc/poseidon.cu),
beside its plain PyTorch version.

Replaces pallas_poseidon._permute_combined (pallas_poseidon.py:433) and its
entry points permute_planes_pair / permute_pair / permute_pallas_u64.  Input
and output are planar (12, B) int64 tensors, one state per column; the
batch is not padded (the TPU's bucket padding kept its compile count down).

``permute`` computes the plain version for a CPU tensor and launches the
kernel for a CUDA tensor (building it at first use) or raises; it counts
its launches in ``permute.launches``.  The kernel's round constants and
matrices are compiled in from csrc/poseidon_constants.cuh, which
``constants_header()`` regenerates from poseidon_gl_constants.npz.

The kernel's schedule (csrc/poseidon_fast.cuh: lazy values, one reduction
per dot product, carry chains) has a twin on python ints here,
``permute_schedule_int`` (B4's instance ``permute_fast_int``, and X2's
canonical, squaring and probe instances) and its helpers, which follows
each carry and borrow of the kernel's asm and checks the bounds the kernel
relies on.
"""
from __future__ import annotations

import ctypes

import torch

from ..field import torch_gl as gl
from ..utils import cuda_build
from . import poseidon_gl as ref

T = 12
HALF_F = ref.N_ROUNDS_F // 2
RP = ref.N_ROUNDS_P

_CONSTS: dict = {}


def _consts(device):
    key = str(device)
    k = _CONSTS.get(key)
    if k is None:
        if int(ref.M.max()) >= 1 << 20:
            raise ValueError("MDS entries must be small for the split product")
        k = {
            "C": gl.from_u64(ref.C, device),
            "S": gl.from_u64(ref.S, device),
            "MT": torch.as_tensor(ref.M.astype("int64").T.copy(), device=device),
            "P": gl.from_u64(ref.P, device),
        }
        _CONSTS[key] = k
    return k


def _mds_small(s, mt):
    """out_i = Σ_j s_j·M[j][i] with small M: the 32-bit halves of s_j
    accumulate separately (sums < 2^42), one reduction per output."""
    lo = torch.zeros_like(s)
    hi = torch.zeros_like(s)
    for j in range(T):
        lo += mt[:, j, None] * (s[j] & gl.MASK32)[None]
        hi += mt[:, j, None] * ((s[j] >> 32) & gl.MASK32)[None]
    return gl.combine_sums(lo, hi)


def _mat_full(s, mat):
    """out_i = Σ_j s_j·mat[j][i] for a dense GL matrix."""
    acc = gl.mul(s[0][None, :], mat[0][:, None])
    for j in range(1, T):
        acc = gl.add(acc, gl.mul(s[j][None, :], mat[j][:, None]))
    return acc


def permute_plain(state: torch.Tensor) -> torch.Tensor:
    """(12, B) -> (12, B), the schedule of poseidon_gl.permute."""
    k = _consts(state.device)
    c = k["C"]
    s = gl.add(gl.canon(state), c[:T, None])
    for r in range(HALF_F - 1):
        s = gl.add(gl.pow7(s), c[(r + 1) * T:(r + 2) * T, None])
        s = _mds_small(s, k["MT"])
    s = gl.add(gl.pow7(s), c[HALF_F * T:(HALF_F + 1) * T, None])
    s = _mat_full(s, k["P"])
    for r in range(RP):
        srow = k["S"][(2 * T - 1) * r:(2 * T - 1) * (r + 1)]
        s0 = gl.add(gl.pow7(s[0]), c[(HALF_F + 1) * T + r])
        rows = torch.cat([s0[None], s[1:]])
        new0 = gl.gl_sum(gl.mul(rows, srow[:T, None]), 0)
        rest = gl.add(s[1:], gl.mul(s0[None], srow[T:, None]))
        s = torch.cat([new0[None], rest])
    base = (HALF_F + 1) * T + RP
    for r in range(HALF_F - 1):
        s = gl.add(gl.pow7(s), c[base + r * T:base + (r + 1) * T, None])
        s = _mds_small(s, k["MT"])
    return _mds_small(gl.pow7(s), k["MT"])


def _lib():
    lib = cuda_build.lib("poseidon")
    if not getattr(lib, "_typed", False):
        vp = ctypes.c_void_p
        lib.poseidon_permute.argtypes = [vp, vp, ctypes.c_longlong, vp]
        lib.poseidon_permute.restype = ctypes.c_int
        lib._typed = True
    return lib


def permute(state: torch.Tensor) -> torch.Tensor:
    if state.device.type == "cpu":
        return permute_plain(state)
    if state.device.type != "cuda":
        raise ValueError(f"poseidon permute: unsupported device {state.device}")
    if state.dtype != torch.int64 or state.dim() != 2 or state.shape[0] != T:
        raise ValueError(f"poseidon permute: want (12, B) int64, got {state.dtype} {tuple(state.shape)}")
    state = state.contiguous()
    out = torch.empty_like(state)
    stream = ctypes.c_void_p(torch.cuda.current_stream(state.device).cuda_stream)
    with torch.cuda.device(state.device):  # launch on the tensor's card
        rc = _lib().poseidon_permute(state.data_ptr(), out.data_ptr(), state.shape[1], stream)
    if rc != 0:
        raise RuntimeError(f"poseidon_permute launch failed: CUDA error {rc}")
    permute.launches += 1
    return out


permute.launches = 0


# ---- python-int twin of csrc/poseidon_fast.cuh --------------------------

PRIME = 0xFFFFFFFF00000001
EPS = 0xFFFFFFFF
W = (1 << 64) - 1


def mul128(a: int, b: int) -> tuple[int, int]:
    """a·b as (lo, hi) words."""
    x = a * b
    return x & W, x >> 64


def mad_wide(a: int, b: int, c: int) -> tuple[int, int]:
    """a·b + c as (lo, hi): mad.lo.cc.u64 / madc.hi.u64; hi never wraps."""
    lo = (a * b & W) + c
    hi = (a * b >> 64) + (lo >> 64)
    assert hi <= W
    return lo & W, hi


def reduce(lo: int, hh: int, hl: int) -> int:
    """(hh·2^96 + hl·2^64 + lo) mod p, lazy (< 2^64), hh < 2^36, hl < 2^32:
    lo - hh with one borrow folded, then + hl·EPS with one carry folded."""
    assert 0 <= lo <= W and 0 <= hh < 1 << 36 and 0 <= hl <= EPS
    t0 = lo - hh
    if t0 < 0:  # sub.cc / subc: e = EPS
        t0 += 1 << 64
        t0 -= EPS
        assert t0 >= 0
    r = t0 + ((hl << 32) - hl)
    if r > W:  # add.cc / addc, neg: + EPS
        r = (r & W) + EPS
        assert r <= W
    return r


def reduce128(lo: int, hi: int) -> int:
    return reduce(lo, hi >> 32, hi & EPS)


def mad_reduce(a: int, b: int, c: int) -> int:
    """(a·b + c) mod p, lazy, one reduction."""
    return reduce128(*mad_wide(a, b, c))


def mul_lazy(a: int, b: int) -> int:
    return reduce128(*mul128(a, b))


def sqr_wide(a: int) -> tuple[int, int]:
    """a^2 as (lo, hi) from three 32x32 products (mul.wide.u32 al·al,
    ah·ah, al·ah), the cross term added at 2^33 by add.cc / addc."""
    al, ah = a & EPS, a >> 32
    m = al * ah
    lo = al * al + ((m << 33) & W)
    hi = ah * ah + (m >> 31) + (lo >> 64)
    assert hi <= W
    return lo & W, hi


def add_c(x: int, c: int) -> int:
    """x + c for c < p, lazy: a carry out of 2^64 folds once as EPS."""
    assert c < PRIME
    t = x + c
    return t - (1 << 64) + EPS if t > W else t


def canon(x: int) -> int:
    return x - PRIME if x >= PRIME else x


def acc3_mad(acc: tuple[int, int, int], a: int, b: int) -> tuple[int, int, int]:
    """Three-word accumulator (a0, a1, a2) += a·b: mad.lo.cc.u64,
    madc.hi.cc.u64, addc.u32."""
    a0, a1, a2 = acc
    lo = (a * b & W) + a0
    mid = (a * b >> 64) + a1 + (lo >> 64)
    a2 += mid >> 64
    assert a2 <= 0xFFFFFFFF
    return lo & W, mid & W, a2


def reduce192(acc: tuple[int, int, int]) -> int:
    """(a2·2^128 + a1·2^64 + a0) mod p, lazy: a2·2^128 ≡ -a2·2^32 joins
    -hh·2^96 as hh + a2·2^32 (disjoint bits of one word)."""
    a0, a1, a2 = acc
    assert a2 < 16
    return reduce(a0, (a1 >> 32) | (a2 << 32), a1 & EPS)


def dot_lazy(xs, cs) -> int:
    """Σ xs[j]·cs[j] mod p, lazy: one three-word sum, one reduction."""
    acc = (0, 0, 0)
    for x, c in zip(xs, cs):
        acc = acc3_mad(acc, x, c)
    return reduce192(acc)


def mds_lazy(s: list) -> list:
    """out_i = Σ_j s_j·M[j][i]: 32-bit halves accumulated apart, then
    lo + hi·EPS with one carry folded (hi < 2^11)."""
    out = []
    for i in range(T):
        acc_lo = sum((s[j] & EPS) * int(ref.M[j][i]) for j in range(T))
        acc_hi = sum((s[j] >> 32) * int(ref.M[j][i]) for j in range(T))
        assert acc_lo < 1 << 42 and acc_hi < 1 << 42
        lo = acc_lo + ((acc_hi << 32) & W)
        hi = (acc_hi >> 32) + (lo >> 64)
        assert hi < 1 << 11
        r = (lo & W) + (hi << 32) - hi
        if r > W:
            r = (r & W) + EPS
        out.append(r)
    return out


def permute_schedule_int(state, canonical: bool = False, sq: bool = False,
                         probe: str | None = None) -> list:
    """One state (12 ints, any u64) through csrc/poseidon_fast.cuh's
    Schedule<canonical, sq, probe>, with the kernel's representative at
    every step: ``canonical`` canonicalises each reduction's result, ``sq``
    squares by sqr_wide, ``probe`` is None or one of "nomxu", "nops",
    "nofs".  The defaults are B4's schedule; canonical out but for nomxu."""
    flip = probe == "nomxu"
    c = [int(v) for v in ref.C]
    sm = [int(v) for v in ref.S]
    pm = [[int(v) for v in row] for row in ref.P]

    def out(x):
        return canon(x) if canonical else x

    def mul(a, b):
        return out(mul_lazy(a, b))

    def sqr(a):
        return out(reduce128(*sqr_wide(a))) if sq else mul(a, a)

    def sbox_add(x, k):
        x2 = sqr(x)
        x3 = mul(x2, x)
        x4 = sqr(x2)
        if flip:  # the plain version's representative: canonical x^7, then + k
            return add_c(canon(mul_lazy(x4, x3)), k)
        return out(mad_reduce(x4, x3, k))

    def full(s, off):
        if probe == "nofs":
            return [out(add_c(x, c[off + i])) for i, x in enumerate(s)]
        return [sbox_add(x, c[off + i]) for i, x in enumerate(s)]

    def mds(s):
        return [x ^ 1 for x in s] if flip else [out(x) for x in mds_lazy(s)]

    s = [out(add_c(int(state[i]), c[i])) for i in range(T)]
    for r in range(HALF_F - 1):
        s = mds(full(s, (r + 1) * T))
    s = full(s, HALF_F * T)
    s = [x ^ 1 for x in s] if flip else [
        out(dot_lazy(s, [pm[j][i] for j in range(T)])) for i in range(T)]
    for r in range(RP):
        k = c[(HALF_F + 1) * T + r]
        if flip:
            s = [x ^ 1 for x in [sbox_add(s[0], k)] + s[1:]]
            continue
        srow = sm[(2 * T - 1) * r:(2 * T - 1) * (r + 1)]
        s0 = out(add_c(s[0], k)) if probe == "nops" else sbox_add(s[0], k)
        new0 = out(dot_lazy(s[1:] + [s0], srow[1:T] + [srow[0]]))  # the kernel's order
        s = [new0] + [out(mad_reduce(s0, srow[T + j - 1], s[j])) for j in range(1, T)]
    base = (HALF_F + 1) * T + RP
    for r in range(HALF_F - 1):
        s = mds(full(s, base + r * T))
    s = mds([sbox_add(x, 0) for x in s])  # under every probe
    return s if flip else [canon(x) for x in s]


def permute_fast_int(state) -> list:
    """One state (12 ints, any u64) through B4's schedule; canonical out."""
    return permute_schedule_int(state)


def constants_header() -> str:
    """Text of csrc/poseidon_constants.cuh for the current constant tables."""
    def arr(name, values):
        vals = [f"0x{int(v):016x}ull" for v in values]
        lines = [", ".join(vals[i:i + 4]) for i in range(0, len(vals), 4)]
        body = ",\n    ".join(lines)
        return f"__constant__ uint64_t {name}[{len(vals)}] = {{\n    {body}}};\n"

    return (
        "// Poseidon-GL round constants and matrices (hash/poseidon_gl_constants.npz).\n"
        "// Generated by hash/cuda_poseidon.py:constants_header(); do not edit.\n"
        "#pragma once\n#include <cstdint>\n\n"
        + arr("POSEIDON_C", ref.C)
        + arr("POSEIDON_S", ref.S)
        + arr("POSEIDON_M", ref.M.reshape(-1))
        + arr("POSEIDON_P", ref.P.reshape(-1))
    )
