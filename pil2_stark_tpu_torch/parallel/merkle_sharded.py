"""The Merkle tree of a sharded array: shard-local subtrees, then the top.

Counterpart of pil2_stark_tpu/parallel/merkle_sharded.py
(``make_sharded_merkle_levels`` :33, ``make_sharded_merkle_root`` :90).
Each rank hashes its extN/d leaf rows (hash/torch_poseidon.py on kernel B4,
the split linear hash where the setup asks for it) and builds its subtree
(the ranks of one device hash each level of their subtrees in one batch);
with a power-of-two height every local level is a contiguous slice of the
global level, so the levels gathered in rank order are the global ones.
The d subtree roots form the level of d nodes, and the top log2(d) levels
are hashed on the lead device of each process.
"""
from __future__ import annotations

import torch

from ..hash import torch_poseidon
from ..stark import device as dev


def merkelize(mesh, shards: list, width: int, height: int, split: bool = False) -> dev.DeviceTree:
    """The tree of a sharded (width, height) array, as a DeviceTree on this
    process's lead device whose elements and levels equal
    stark.device.merkelize's of the whole array.  A zero-width section is
    stark.device.merkelize's uniform tree."""
    d = mesh.size
    if width == 0:
        elements = torch.zeros((0, height), dtype=torch.int64, device=mesh.lead)
        return dev.merkelize(elements, 0, height, split)
    if height & (height - 1) or height % d:
        raise ValueError(f"a sharded tree needs a power-of-two height that {d} ranks divide, "
                         f"got {height}")
    by_device = {}  # the ranks of each device, which hash their levels in one batch
    for r in mesh.local_ranks:
        by_device.setdefault(mesh.device(r), []).append(r)
    packs, sizes = [None] * d, None
    for ranks in by_device.values():
        k = len(ranks)
        level = torch.cat([torch_poseidon.leaf_digests_planar(shards[r], width, split)
                           for r in ranks], dim=1)
        levels = [level]
        while level.shape[1] > k:  # pairs never straddle two ranks' blocks
            level = torch_poseidon.hash_level_planar(level)
            levels.append(level)
        sizes = [lvl.shape[1] // k for lvl in levels]
        for i, r in enumerate(ranks):
            packs[r] = torch.cat([lvl[:, i * n:(i + 1) * n].reshape(-1)
                                  for lvl, n in zip(levels, sizes)])
    # every rank's levels, in one exchange, then each level in rank order
    gathered = mesh.gather_list(packs)
    levels, pos = [], 0
    for n in sizes:
        levels.append(torch.cat([g[pos:pos + 4 * n].reshape(4, n) for g in gathered], dim=1))
        pos += 4 * n
    while levels[-1].shape[1] > 1:
        levels.append(torch_poseidon.hash_level_planar(levels[-1]))
    return dev.DeviceTree(width=width, height=height, elements=mesh.gather(shards),
                          levels=levels)
