"""Goldilocks field (p = 2^64 - 2^32 + 1) on torch.int64 tensors.

Counterpart of pil2_stark_tpu/field/jax_gl.py.  An element is ONE int64
tensor entry holding the canonical u64 bit pattern (values >= 2^63 read as
negative int64).  torch's int64 add/sub/mul wrap mod 2^64, so the low 64
bits of every sum and product are the unsigned ones; what torch lacks for
u64 (unsigned compare, logical shift, the high half of a product) is
rebuilt here from 32-bit halves held in int64:

  * unsigned a < b   ==  (a ^ 2^63) < (b ^ 2^63)  (signed compare);
  * logical x >> 32  ==  (x >> 32) & (2^32 - 1);
  * the 128-bit product from four 32x32 partial products, then reduced
    with 2^64 = 2^32 - 1 and 2^96 = -1 (mod p), as _reduce128 at
    jax_gl.py:193 does on u32 limb pairs.

Every function takes canonical inputs and returns canonical outputs; the
same code runs on CPU and CUDA tensors (plain torch ops, no kernel).
"""
from __future__ import annotations

import numpy as np
import torch

P_INT = 0xFFFFFFFF00000001
EPS = 0xFFFFFFFF  # 2^64 mod p
MASK32 = 0xFFFFFFFF
_SIGN = -(1 << 63)
P_I64 = P_INT - (1 << 64)  # p as an int64 bit pattern
_P_FLIP = (P_INT ^ (1 << 63))  # p with the sign bit flipped (a positive int64)


def i64(x: int) -> int:
    """Python int (any) -> the int64 bit pattern of x mod p."""
    x %= P_INT
    return x - (1 << 64) if x >= (1 << 63) else x


def from_u64(a, device=None) -> torch.Tensor:
    """numpy u64 array -> int64 tensor (bit pattern), on `device`."""
    arr = np.ascontiguousarray(np.asarray(a, dtype=np.uint64))
    t = torch.from_numpy(arr.view(np.int64).copy())
    return t if device is None else t.to(device)


def to_u64(t: torch.Tensor) -> np.ndarray:
    """int64 tensor -> numpy u64 array (copied to host)."""
    return t.detach().contiguous().cpu().numpy().view(np.uint64)


def ult(a, b):
    """Unsigned a < b on u64 bit patterns."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def _geq_p(a):
    return (a ^ _SIGN) >= _P_FLIP


def canon(a):
    """x mod p for any u64 bit pattern (x < 2^64 < 2p)."""
    return torch.where(_geq_p(a), a - P_I64, a)


def add(a, b):
    s = a + b
    # a carry out of 2^64 or s >= p: subtract p once (true sum < 2p)
    return torch.where(ult(s, a) | _geq_p(s), s - P_I64, s)


def sub(a, b):
    d = a - b
    return torch.where(ult(a, b), d + P_I64, d)


def neg(a):
    return torch.where(a == 0, a, P_I64 - a)


def _reduce128(lo, hi):
    """(hi·2^64 + lo) mod p, canonical."""
    hh = (hi >> 32) & MASK32
    hl = hi & MASK32
    t0 = lo - hh
    t0 = torch.where(ult(lo, hh), t0 - EPS, t0)
    t1 = (hl << 32) - hl  # hl·EPS < 2^64
    r = t0 + t1
    r = torch.where(ult(r, t0), r + EPS, r)
    return canon(r)


def _halves(a):
    if isinstance(a, int):
        a = i64(a)
    return a & MASK32, (a >> 32) & MASK32


def mul(a, b):
    """a·b mod p; either operand may be a python int."""
    al, ah = _halves(a)
    bl, bh = _halves(b)
    ll = al * bl
    lh = al * bh
    hl = ah * bl
    hh = ah * bh
    mid = ((ll >> 32) & MASK32) + (lh & MASK32) + (hl & MASK32)  # < 3·2^32
    lo = (ll & MASK32) | (mid << 32)
    hi = hh + ((lh >> 32) & MASK32) + ((hl >> 32) & MASK32) + (mid >> 32)
    return _reduce128(lo, hi)


def square(a):
    return mul(a, a)


def mul_const(a, k: int):
    return mul(a, int(k) % P_INT)


def exp_const(a, e: int):
    """a^e for a python-int exponent (square-and-multiply)."""
    e = int(e) % (P_INT - 1)
    if e == 0:
        return torch.ones_like(a)
    res = a
    for bit in bin(e)[3:]:
        res = square(res)
        if bit == "1":
            res = mul(res, a)
    return res


def inv(a):
    """Elementwise inverse a^(p-2) (0 maps to 0)."""
    return exp_const(a, P_INT - 2)


def pow7(a):
    """x^7 — the Poseidon S-box."""
    x2 = square(a)
    x3 = mul(x2, a)
    x4 = square(x2)
    return mul(x4, x3)


def combine_sums(lo_sum, hi_sum):
    """(hi_sum·2^32 + lo_sum) mod p for non-negative int64 sums < 2^62
    (sums of 32-bit halves), canonical."""
    a0 = lo_sum & MASK32
    mid = (lo_sum >> 32) + (hi_sum & MASK32)  # < 2^33
    lo = a0 | ((mid & MASK32) << 32)
    hi = (hi_sum >> 32) + (mid >> 32)
    return _reduce128(lo, hi)


def gl_sum(a, dim: int, keepdim: bool = False):
    """Σ a mod p along `dim` (any length below 2^30)."""
    lo = (a & MASK32).sum(dim=dim, keepdim=keepdim)
    hi = ((a >> 32) & MASK32).sum(dim=dim, keepdim=keepdim)
    return combine_sums(lo, hi)


def powers(base: int, n: int, device=None, start: int = 1) -> torch.Tensor:
    """[start, start·base, …, start·base^(n-1)] by log-doubling on `device`."""
    out = torch.tensor([i64(start)], dtype=torch.int64, device=device)
    b = int(base) % P_INT
    while out.shape[0] < n:
        step = pow(b, out.shape[0], P_INT)
        out = torch.cat([out, mul(out, step)])
    return out[:n]
