"""Linear (sponge) hash over row vectors — numpy batch oracle.

Mirrors pil2-stark-js src/helpers/hash/linearhash/linearhash.js:8-42 and the
split ("GPU"-layout) variant linearhash_gpu.js:31-68, batched over rows.
Used by the host-side verifier and as the differential-test oracle for the
JAX path (jax_poseidon.linear_hash*).
"""
from __future__ import annotations

import numpy as np

from . import poseidon_gl


def linear_hash(rows: np.ndarray) -> np.ndarray:
    """rows (B, W) uint64 -> digests (B, 4).  W ≤ 4 rows copied verbatim."""
    rows = np.asarray(rows, dtype=np.uint64)
    b, w = rows.shape
    if w <= 4:
        out = np.zeros((b, 4), dtype=np.uint64)
        out[:, :w] = rows
        return out
    n_chunks = -(-w // 8)
    padded = np.zeros((b, n_chunks * 8), dtype=np.uint64)
    padded[:, :w] = rows
    st = np.zeros((b, 4), dtype=np.uint64)
    for c in range(n_chunks):
        st = poseidon_gl.hash_n(padded[:, c * 8 : (c + 1) * 8], st)
    return st


def linear_hash_split(rows: np.ndarray, batch_size: int | None = None) -> np.ndarray:
    """Split variant: chunk the row, hash chunks, hash the digests."""
    rows = np.asarray(rows, dtype=np.uint64)
    b, w = rows.shape
    if batch_size is None:
        batch_size = int(max(8, (w + 3) / 4))
    if w <= 4:
        return linear_hash(rows)
    digests = [
        linear_hash(rows[:, s : min(s + batch_size, w)])
        for s in range(0, w, batch_size)
    ]
    cat = np.concatenate(digests, axis=1)
    return linear_hash(cat)
