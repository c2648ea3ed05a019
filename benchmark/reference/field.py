"""Goldilocks (p = 2^64 - 2^32 + 1) and its cubic extension on int64 torch
tensors and on python ints: the plain arithmetic the reference prover runs.

A frozen copy of the plain versions pil2_stark_tpu_torch/field/torch_gl.py
and field/torch_f3.py at commit a529475 (the element layout, the 32-bit
half products and the closed-form cubic inverse), cut to what the
reference uses, with the host helpers it needs on python ints.  An element
is one int64 holding the canonical u64 bit pattern; every function takes
canonical inputs and returns canonical outputs, on any device.  Field
arithmetic is exact, so any correct program computes the same canonical
values: the reference and the program agree bit for bit or one is wrong.
"""
from __future__ import annotations

import numpy as np
import torch

P = 0xFFFFFFFF00000001
EPS = 0xFFFFFFFF  # 2^64 mod p
MASK32 = 0xFFFFFFFF
_SIGN = -(1 << 63)
_P_I64 = P - (1 << 64)
_P_FLIP = P ^ (1 << 63)
SHIFT = 7  # the coset generator of the extended domain
SHIFT_INV = pow(SHIFT, P - 2, P)
_W0 = 7277203076849721926  # a primitive 2^32-th root of unity (pil2-stark-js f3g.js)


def w(bits: int) -> int:
    """The primitive 2^bits-th root of unity of the f3g.js chain."""
    return pow(_W0, 1 << (32 - bits), P)


def w_inv(bits: int) -> int:
    return pow(w(bits), P - 2, P)


def i64(x: int) -> int:
    x %= P
    return x - (1 << 64) if x >= (1 << 63) else x


def from_u64(a, device=None) -> torch.Tensor:
    arr = np.ascontiguousarray(np.asarray(a, dtype=np.uint64))
    return torch.from_numpy(arr.view(np.int64).copy()).to(device)


def to_u64(t: torch.Tensor) -> np.ndarray:
    return t.detach().contiguous().cpu().numpy().view(np.uint64)


def _ult(a, b):
    return (a ^ _SIGN) < (b ^ _SIGN)


def _canon(a):
    return torch.where((a ^ _SIGN) >= _P_FLIP, a - _P_I64, a)


def add(a, b):
    s = a + b
    return torch.where(_ult(s, a) | ((s ^ _SIGN) >= _P_FLIP), s - _P_I64, s)


def sub(a, b):
    d = a - b
    return torch.where(_ult(a, b), d + _P_I64, d)


def neg(a):
    return torch.where(a == 0, a, _P_I64 - a)


def _reduce128(lo, hi):
    hh = (hi >> 32) & MASK32
    hl = hi & MASK32
    t0 = lo - hh
    t0 = torch.where(_ult(lo, hh), t0 - EPS, t0)
    r = t0 + ((hl << 32) - hl)
    r = torch.where(_ult(r, t0), r + EPS, r)
    return _canon(r)


def _halves(a):
    if isinstance(a, int):
        a = i64(a)
    return a & MASK32, (a >> 32) & MASK32


def mul(a, b):
    """a·b mod p; either operand may be a python int."""
    al, ah = _halves(a)
    bl, bh = _halves(b)
    ll, lh, hl, hh = al * bl, al * bh, ah * bl, ah * bh
    mid = ((ll >> 32) & MASK32) + (lh & MASK32) + (hl & MASK32)
    lo = (ll & MASK32) | (mid << 32)
    hi = hh + ((lh >> 32) & MASK32) + ((hl >> 32) & MASK32) + (mid >> 32)
    return _reduce128(lo, hi)


def pow7(a):
    a2 = mul(a, a)
    return mul(mul(a2, a2), mul(a2, a))


def exp(a, e: int):
    res = torch.ones_like(a)
    for bit in bin(e)[2:]:
        res = mul(res, res)
        if bit == "1":
            res = mul(res, a)
    return res


def inv(a):
    return exp(a, P - 2)


def combine_sums(lo_sum, hi_sum):
    """(hi_sum·2^32 + lo_sum) mod p for sums of 32-bit halves below 2^62."""
    mid = (lo_sum >> 32) + (hi_sum & MASK32)
    lo = (lo_sum & MASK32) | ((mid & MASK32) << 32)
    hi = (hi_sum >> 32) + (mid >> 32)
    return _reduce128(lo, hi)


def gl_sum(a, dim: int):
    return combine_sums((a & MASK32).sum(dim=dim), ((a >> 32) & MASK32).sum(dim=dim))


def powers(base: int, n: int, device=None, start: int = 1) -> torch.Tensor:
    """[start·base^i for i < n] on `device`."""
    out = torch.tensor([i64(start)], dtype=torch.int64, device=device)
    while out.shape[0] < n:
        out = torch.cat([out, mul(out, pow(base, out.shape[0], P))])
    return out[:n]


# -- the cubic extension F_p[X]/(X^3 - X - 1): a (d, ...) tensor, d in {1, 3}


def _stack(rows):
    shape = torch.broadcast_shapes(*[r.shape for r in rows])
    return torch.stack([r.expand(shape) for r in rows])


def e_add(a, b):
    if a.shape[0] == b.shape[0]:
        return add(a, b)
    if a.shape[0] == 1:
        a, b = b, a
    return _stack([add(a[0], b[0]), a[1], a[2]])


def e_sub(a, b):
    if a.shape[0] == b.shape[0]:
        return sub(a, b)
    if a.shape[0] == 3:
        return _stack([sub(a[0], b[0]), a[1], a[2]])
    return _stack([sub(a[0], b[0]), neg(b[1]), neg(b[2])])


def e_mul(a, b):
    if a.shape[0] == 1 or b.shape[0] == 1:
        return mul(a, b)
    a0, a1, a2 = a[0], a[1], a[2]
    b0, b1, b2 = b[0], b[1], b[2]
    A = mul(add(a0, a1), add(b0, b1))
    B = mul(add(a0, a2), add(b0, b2))
    C = mul(add(a1, a2), add(b1, b2))
    D, E, F = mul(a0, b0), mul(a1, b1), mul(a2, b2)
    G = sub(D, E)
    return _stack([sub(add(C, G), F), sub(sub(add(A, C), add(E, E)), D), sub(B, G)])


def e_inv(a):
    """The closed-form cubic inverse (f3g.js:136-171) of a (3, ...) value."""
    a0, a1, a2 = a[0], a[1], a[2]
    aa, ac, ba = mul(a0, a0), mul(a0, a2), mul(a1, a0)
    bb, bc, cc = mul(a1, a1), mul(a1, a2), mul(a2, a2)
    aaa, aac, abc = mul(aa, a0), mul(aa, a2), mul(ba, a2)
    abb, acc, bbb = mul(ba, a1), mul(ac, a2), mul(bb, a1)
    bcc, ccc = mul(bc, a2), mul(cc, a2)
    t = sub(add(add(add(abc, abc), abc), add(abb, bcc)),
            add(add(add(aaa, aac), add(aac, acc)), add(bbb, ccc)))
    tinv = inv(t)
    return torch.stack([mul(sub(add(bc, bb), add(add(aa, ac), add(ac, cc))), tinv),
                        mul(sub(ba, cc), tinv), mul(sub(add(ac, cc), bb), tinv)])


def scalar3(v, device=None) -> torch.Tensor:
    """A python int or 3-tuple as a (3, 1) tensor."""
    vals = v if isinstance(v, (tuple, list)) else (v, 0, 0)
    return torch.tensor([i64(int(x)) for x in vals], dtype=torch.int64,
                        device=device).reshape(3, 1)


def f3_mul(a, b):
    """Product of two extension elements given as 3-tuples of python ints."""
    c = [0] * 5
    for i in range(3):
        for j in range(3):
            c[i + j] += a[i] * b[j]
    return ((c[0] + c[3]) % P, (c[1] + c[3] + c[4]) % P, (c[2] + c[4]) % P)
