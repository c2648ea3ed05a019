"""Fr instantiations of the hint kernels (grand product / log-up grand
sum / plookup multiset halves) used by the shared hints engine
(stark/hints.py) when proving with the fflonk backend.

Same semantics as ops/polutils.py over GL (which mirrors the reference's
polutils.js:105-164); dim is always 1 over Fr.
"""
from __future__ import annotations

import numpy as np

from ..ops.fft_bn128 import FR


def _inv(v: int) -> int:
    return pow(int(v) % FR, FR - 2, FR)


def calculate_z(num, den) -> np.ndarray:
    """Grand product: z[0]=1, z[i]=z[i-1]*num[i-1]/den[i-1]."""
    n = len(den)
    out = np.empty(n, dtype=object)
    acc = 1
    num_arr = num if hasattr(num, "__len__") else [num] * n
    for i in range(n):
        out[i] = acc
        acc = acc * int(num_arr[i]) % FR * _inv(den[i]) % FR
    return out


def calculate_s(num, den) -> np.ndarray:
    """Grand sum: s[i] = sum_{k<=i} num[k]/den[k] (num may be scalar)."""
    n = len(den)
    out = np.empty(n, dtype=object)
    acc = 0
    num_arr = num if hasattr(num, "__len__") else [num] * n
    for i in range(n):
        acc = (acc + int(num_arr[i]) % FR * _inv(den[i])) % FR
        out[i] = acc
    return out


def calculate_h1h2(f, t):
    """Plookup multiset halves; duplicate t values take the LAST index
    and the merged sort is stable (polutils.js:105-130)."""
    idx_t = {}
    s = []
    for i, v in enumerate(t):
        v = int(v) % FR
        idx_t[v] = i
        s.append((v, i))
    for i, v in enumerate(f):
        v = int(v) % FR
        if v not in idx_t:
            raise ValueError(f"Number not included: w={i}, value={v}")
        s.append((v, idx_t[v]))
    s.sort(key=lambda p: p[1])
    n = len(f)
    h1 = [s[2 * i][0] for i in range(n)]
    h2 = [s[2 * i + 1][0] for i in range(n)]
    return h1, h2
