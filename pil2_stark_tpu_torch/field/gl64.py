"""Goldilocks field (p = 2^64 - 2^32 + 1) vectorized over numpy uint64.

Host-side reference implementation ("oracle") used by tests, the transcript,
and small host-side prover steps.  Semantics mirror the BigInt arithmetic of
the reference JS implementation (pil2-stark-js src/helpers/f3g.js) but are
implemented with branch-free u64 limb tricks (cf. the overflow handling that
the reference encodes in its WASM kernel, glwasm.js:5-96).

All inputs/outputs are canonical (< p) numpy uint64 arrays or scalars.
"""
from __future__ import annotations

import functools

import numpy as np


def _wrapping(fn):
    """u64 wraparound is intentional in the limb tricks below."""

    @functools.wraps(fn)
    def inner(*args, **kwargs):
        with np.errstate(over="ignore"):
            return fn(*args, **kwargs)

    return inner


P = np.uint64(0xFFFFFFFF00000001)
P_INT = 0xFFFFFFFF00000001
EPSILON = np.uint64(0xFFFFFFFF)  # 2^64 mod p
ZERO = np.uint64(0)
ONE = np.uint64(1)
MASK32 = np.uint64(0xFFFFFFFF)

# 2-adicity chain: w[32] = 7277203076849721926 (f3g.js:40 via buildFFT w0),
# w[s-1] = w[s]^2.  shift (coset generator) = 7 (f3g.js:22).
W0_2_32 = 7277203076849721926
S_MAX = 32
SHIFT = np.uint64(7)


def _u64(x) -> np.ndarray:
    return np.asarray(x, dtype=np.uint64)


@_wrapping
def add(a, b):
    a = _u64(a)
    b = _u64(b)
    s = a + b
    over = s < a
    s = s + np.where(over, EPSILON, ZERO)
    return np.where(s >= P, s - P, s)


@_wrapping
def sub(a, b):
    a = _u64(a)
    b = _u64(b)
    d = a - b
    borrow = a < b
    return d - np.where(borrow, EPSILON, ZERO)


@_wrapping
def neg(a):
    a = _u64(a)
    return np.where(a > ZERO, P - a, a)


@_wrapping
def _mul_wide(a, b):
    """Full 128-bit product of u64 values as (hi, lo) u64 pair."""
    a = _u64(a)
    b = _u64(b)
    a0 = a & MASK32
    a1 = a >> np.uint64(32)
    b0 = b & MASK32
    b1 = b >> np.uint64(32)
    ll = a0 * b0
    lh = a0 * b1
    hl = a1 * b0
    hh = a1 * b1
    mid = lh + hl
    mid_c = (mid < lh).astype(np.uint64)
    lo = ll + (mid << np.uint64(32))
    c1 = (lo < ll).astype(np.uint64)
    hi = hh + (mid >> np.uint64(32)) + (mid_c << np.uint64(32)) + c1
    return hi, lo


@_wrapping
def reduce128(hi, lo):
    """Reduce (hi·2^64 + lo) mod p to canonical form.

    Uses 2^64 ≡ 2^32 - 1 and 2^96 ≡ -1 (mod p).
    """
    hi = _u64(hi)
    lo = _u64(lo)
    hi_hi = hi >> np.uint64(32)
    hi_lo = hi & MASK32
    t0 = lo - hi_hi
    borrow = lo < hi_hi
    t0 = t0 - np.where(borrow, EPSILON, ZERO)
    t1 = hi_lo * EPSILON
    t2 = t0 + t1
    over = t2 < t0
    t2 = t2 + np.where(over, EPSILON, ZERO)
    return np.where(t2 >= P, t2 - P, t2)


def mul(a, b):
    hi, lo = _mul_wide(a, b)
    return reduce128(hi, lo)


def square(a):
    return mul(a, a)


def exp(base, e: int):
    """base^e with a python-int exponent, vectorized over base."""
    e = int(e) % (P_INT - 1)
    base = _u64(base)
    result = np.broadcast_to(ONE, base.shape).copy() if base.shape else ONE
    acc = base
    while e:
        if e & 1:
            result = mul(result, acc)
        e >>= 1
        if e:
            acc = mul(acc, acc)
    return result


def inv(a):
    """Inverse via Fermat (a^(p-2)); exact for canonical nonzero inputs."""
    return exp(a, P_INT - 2)


def batch_inverse(a):
    """Montgomery batch inversion matching f3g.js:370-385 ordering."""
    a = _u64(a)
    n = a.shape[0]
    if n == 0:
        return a
    tmp = np.empty_like(a)
    tmp[0] = a[0]
    for i in range(1, n):
        tmp[i] = mul(tmp[i - 1], a[i])
    z = inv(tmp[n - 1])
    res = np.empty_like(a)
    for i in range(n - 1, 0, -1):
        res[i] = mul(z, tmp[i - 1])
        z = mul(z, a[i])
    res[0] = z
    return res


def _build_w_chain():
    w = [0] * (S_MAX + 1)
    wi = [0] * (S_MAX + 1)
    w[S_MAX] = W0_2_32
    wi[S_MAX] = pow(W0_2_32, P_INT - 2, P_INT)
    for s in range(S_MAX - 1, -1, -1):
        w[s] = (w[s + 1] * w[s + 1]) % P_INT
        wi[s] = (wi[s + 1] * wi[s + 1]) % P_INT
    return w, wi


W_CHAIN, WI_CHAIN = _build_w_chain()
SHIFT_INT = 7
SHIFT_INV_INT = pow(7, P_INT - 2, P_INT)


def w(bits: int) -> int:
    """2^bits-th primitive root of unity (python int), f3g.js w[] table."""
    return W_CHAIN[bits]


def w_inv(bits: int) -> int:
    return WI_CHAIN[bits]


def powers(base: int, n: int, start: int = 1) -> np.ndarray:
    """[start, start·base, start·base^2, ...] length n, as uint64.

    Doubling construction: O(log n) vectorized passes.
    """
    if n == 0:
        return np.empty(0, dtype=np.uint64)
    arr = np.array([start % P_INT], dtype=np.uint64)
    b = base % P_INT
    while arr.shape[0] < n:
        step = pow(b, arr.shape[0], P_INT)
        arr = np.concatenate([arr, mul(arr, np.uint64(step))])
    return arr[:n]
