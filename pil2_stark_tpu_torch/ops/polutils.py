"""Hint helpers on the host: lookup multiset halves and grand product/sum
columns (host copy of pil2_stark_tpu/ops/polutils.py).

Semantics mirror pil2-stark-js src/helpers/polutils.js (calculateH1H2
:105-130, calculateZ :132-145, calculateS :147-164), vectorized over numpy;
grand product/sum are prefix scans over extension values.
"""
from __future__ import annotations

import numpy as np

from ..field import gl64, vf3


def calculate_h1h2(f, t):
    """Plookup multiset halves (polutils.js:105-130).

    f, t are length-N arrays of scalar values (ints; dim-1 only in PIL1).
    Returns (h1, h2).  Duplicate t values take the LAST index, as the JS
    idx_t assignment does; the merged list is sorted stably by index.
    """
    idx_t = {}
    s = []
    for i, v in enumerate(t):
        v = int(v) if not isinstance(v, tuple) else v
        idx_t[v] = i
        s.append((v, i))
    for i, v in enumerate(f):
        v = int(v) if not isinstance(v, tuple) else v
        if v not in idx_t:
            raise ValueError(f"Number not included: w={i}, value={v}")
        s.append((v, idx_t[v]))
    s.sort(key=lambda p: p[1])  # python sort is stable, like V8's
    n = len(f)
    h1 = [s[2 * i][0] for i in range(n)]
    h2 = [s[2 * i + 1][0] for i in range(n)]
    return h1, h2


def _prefix_mul(vals: np.ndarray) -> np.ndarray:
    """Inclusive prefix product of extension values, Hillis-Steele
    (O(N log N) vectorized passes)."""
    res = vals.copy()
    n = res.shape[0]
    shift = 1
    while shift < n:
        upd = vf3.mul(res[shift:], res[:-shift])
        res[shift:] = upd
        shift <<= 1
    return res


def calculate_z(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """Grand product: z[0]=1, z[i]=z[i-1]·num[i-1]/den[i-1]
    (polutils.js:132-145).  num/den are (N,) or (N,3) arrays."""
    ratio = vf3.mul(num, vf3.inv(den))
    ratio3 = vf3.as3(ratio)
    shifted = np.empty_like(ratio3)
    shifted[0] = np.array([1, 0, 0], dtype=np.uint64)
    shifted[1:] = ratio3[:-1]
    return _prefix_mul(shifted)


def calculate_s(num, den: np.ndarray) -> np.ndarray:
    """Grand sum: s[i] = Σ_{k≤i} num/den[k] (polutils.js:147-164);
    num is a scalar (shared numerator)."""
    vals = vf3.as3(vf3.mul(vf3.from_scalar(num), vf3.inv(den)))
    if vals.ndim == 1:
        vals = np.broadcast_to(vals, den.shape[:1] + (3,)).copy()
    # prefix sum via Hillis-Steele with gl64.add
    res = vals.copy()
    n = res.shape[0]
    shift = 1
    while shift < n:
        res[shift:] = gl64.add(res[shift:], res[:-shift])
        shift <<= 1
    return res
