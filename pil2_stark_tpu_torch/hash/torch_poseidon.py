"""Planar Poseidon sponge and Merkle levels on the device.

Counterpart of the planar half of pil2_stark_tpu/hash/jax_poseidon.py
(``linear_hash_planar`` :261, ``linear_hash_split_planar`` :287,
``_hash_level_planar_jit`` :306, ``_leaf_digests_planar`` :364,
``merkle_levels_planar`` :390).  Columns are (width, B) tensors with the row
index on the contiguous axis; digests are (4, B).  Every permutation goes
through cuda_poseidon.permute (kernel B4 on the card).  Digests equal the
host tree's (hash/linearhash.py, hash/merkle.py) bit for bit.
"""
from __future__ import annotations

import torch

from . import cuda_poseidon


def permute_planar(state: torch.Tensor) -> torch.Tensor:
    return cuda_poseidon.permute(state)


def linear_hash_planar(cols: torch.Tensor, width: int) -> torch.Tensor:
    """Sponge over planar columns (width, B) -> (4, B); width <= 4 rows are
    copied verbatim (zero-padded)."""
    b = cols.shape[1]
    if width <= 4:
        out = torch.zeros((4, b), dtype=torch.int64, device=cols.device)
        out[:width] = cols
        return out
    n_chunks = -(-width // 8)
    st = torch.zeros((4, b), dtype=torch.int64, device=cols.device)
    for c in range(n_chunks):
        chunk = cols[c * 8:min((c + 1) * 8, width)]
        state = torch.zeros((12, b), dtype=torch.int64, device=cols.device)
        state[:chunk.shape[0]] = chunk
        state[8:] = st
        st = permute_planar(state)[:4]
    return st


def linear_hash_split_planar(cols: torch.Tensor, width: int,
                             batch_size: int | None = None) -> torch.Tensor:
    """Two-level split linear hash (linearhash_gpu.js:31-68)."""
    if batch_size is None:
        batch_size = int(max(8, (width + 3) / 4))
    if width <= 4:
        return linear_hash_planar(cols, width)
    digests = [
        linear_hash_planar(cols[s:min(s + batch_size, width)], min(s + batch_size, width) - s)
        for s in range(0, width, batch_size)
    ]
    cat = torch.cat(digests)
    return linear_hash_planar(cat, cat.shape[0])


def hash_level_planar(level: torch.Tensor) -> torch.Tensor:
    """Planar level (4, 2m) -> (4, m): siblings are adjacent lanes."""
    m = level.shape[1] // 2
    pairs = level.reshape(4, m, 2)
    state = torch.zeros((12, m), dtype=torch.int64, device=level.device)
    state[:4] = pairs[:, :, 0]
    state[4:8] = pairs[:, :, 1]
    return permute_planar(state)[:4]


def leaf_digests_planar(cols: torch.Tensor, width: int, split: bool) -> torch.Tensor:
    """(width, height) columns -> (4, height) leaf digests."""
    if split:
        return linear_hash_split_planar(cols, width)
    return linear_hash_planar(cols, width)


def merkle_levels_planar(cols: torch.Tensor, width: int, height: int,
                         split: bool = False) -> list:
    """Planar Merkle build: (width, height) -> list of (4, n) digest levels,
    root last; every non-root level zero-padded to an even count
    (merklehash_p.js:28-42)."""
    d = leaf_digests_planar(cols, width, split)
    levels = []
    n = height
    while n > 1:
        if n % 2:
            d = torch.cat([d, torch.zeros((4, 1), dtype=torch.int64, device=d.device)], dim=1)
        levels.append(d)
        d = hash_level_planar(d)
        n = (n + 1) // 2
    levels.append(d)
    return levels
