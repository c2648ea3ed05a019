"""Goldilocks on numpy uint64, for the input builders: a frozen copy of
pil2_stark_tpu_torch/field/gl64.py (add, mul) at commit a529475."""
from __future__ import annotations

import numpy as np

P_INT = 0xFFFFFFFF00000001
P = np.uint64(P_INT)
EPS = np.uint64(0xFFFFFFFF)
MASK32 = np.uint64(0xFFFFFFFF)
_0 = np.uint64(0)
_32 = np.uint64(32)


def add(a, b):
    with np.errstate(over="ignore"):
        a, b = np.asarray(a, dtype=np.uint64), np.asarray(b, dtype=np.uint64)
        s = a + b
        s = s + np.where(s < a, EPS, _0)
        return np.where(s >= P, s - P, s)


def mul(a, b):
    with np.errstate(over="ignore"):
        a, b = np.asarray(a, dtype=np.uint64), np.asarray(b, dtype=np.uint64)
        a0, a1, b0, b1 = a & MASK32, a >> _32, b & MASK32, b >> _32
        ll, lh, hl, hh = a0 * b0, a0 * b1, a1 * b0, a1 * b1
        mid = lh + hl
        mid_c = (mid < lh).astype(np.uint64)
        lo = ll + (mid << _32)
        hi = hh + (mid >> _32) + (mid_c << _32) + (lo < ll).astype(np.uint64)
        t0 = lo - (hi >> _32)
        t0 = t0 - np.where(lo < (hi >> _32), EPS, _0)
        t2 = t0 + (hi & MASK32) * EPS
        t2 = t2 + np.where(t2 < t0, EPS, _0)
        return np.where(t2 >= P, t2 - P, t2)
