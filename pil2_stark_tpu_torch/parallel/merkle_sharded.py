"""The Merkle tree of a sharded array: shard-local subtrees, then the top.

Counterpart of pil2_stark_tpu/parallel/merkle_sharded.py
(``make_sharded_merkle_levels`` :33, ``make_sharded_merkle_root`` :90).
Each rank hashes its extN/d leaf rows (hash/torch_poseidon.py on kernel B4,
the split linear hash where the setup asks for it) and builds its subtree
(the ranks of one device hash each level of their subtrees in one batch);
with a power-of-two height every local level is a contiguous slice of the
global level.  The d subtree roots form the level of d nodes, and the top
log2(d) levels are hashed on the lead device of each process, as the
reference keeps the tops replicated.

A ``ShardedTree`` keeps what each rank built on that rank: its element rows
and its subtree's levels.  Nothing of a whole extended section is gathered:
a query reads its element row and its lower siblings on the rank that owns
the row and its top siblings on the lead (``gather_group_proofs_multi``,
one exchange for every query of every tree).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..field import torch_gl as gl
from ..hash import torch_poseidon
from ..stark import device as dev


@dataclasses.dataclass
class ShardedTree:
    """A Poseidon-GL tree of (width, height) elements over a mesh of d
    ranks.  shards[r]: rank r's planar (width, height/d) element rows on
    its device (None for the ranks of other processes); low[r]: its
    subtree's levels (4, b), (4, b/2), ..., (4, 1) with b = height/d;
    top: the levels (4, d), ..., (4, 1) on this process's lead device.
    base: a const tree's base-domain fixed columns, on the lead."""

    mesh: object
    width: int
    height: int
    shards: list
    low: list
    top: list
    base: torch.Tensor | None = None

    @property
    def rows_per_rank(self) -> int:
        return self.height // self.mesh.size

    @functools.cached_property
    def root(self) -> np.ndarray:
        return gl.to_u64(self.top[-1][:, 0])

    def rank_bytes(self) -> list:
        """The bytes of element rows each rank of this process holds."""
        return [0 if s is None else s.numel() * 8 for s in self.shards]

    def gather_levels(self) -> list:
        """Every level of the whole tree on the lead, as
        stark.device.merkelize gives them (an exchange; for checks)."""
        sizes = [lvl.shape[1] for lvl in self.low[self.mesh.local_ranks[0]]]
        packs = [None if lv is None else torch.cat([x.reshape(-1) for x in lv])
                 for lv in self.low]
        gathered = self.mesh.gather_list(packs)
        levels, pos = [], 0
        for n in sizes[:-1]:
            levels.append(torch.cat([g[pos:pos + 4 * n].reshape(4, n) for g in gathered], dim=1))
            pos += 4 * n
        return levels + list(self.top)


def _check_height(height: int, d: int) -> None:
    if height & (height - 1) or height % d:
        raise ValueError(f"a sharded tree needs a power-of-two height that {d} ranks divide, "
                         f"got {height}")


def merkelize(mesh, shards: list, width: int, height: int, split: bool = False):
    """The tree of a sharded (width, height) array: a ShardedTree whose
    root and levels equal stark.device.merkelize's of the whole array.  A
    zero-width section is stark.device.merkelize's uniform tree."""
    d = mesh.size
    if width == 0:
        elements = torch.zeros((0, height), dtype=torch.int64, device=mesh.lead)
        return dev.merkelize(elements, 0, height, split)
    _check_height(height, d)
    by_device = {}  # the ranks of each device, which hash their levels in one batch
    for r in mesh.local_ranks:
        by_device.setdefault(mesh.device(r), []).append(r)
    low = [None] * d
    for ranks in by_device.values():
        k = len(ranks)
        level = torch.cat([torch_poseidon.leaf_digests_planar(shards[r], width, split)
                           for r in ranks], dim=1)
        levels = [level]
        while level.shape[1] > k:  # pairs never straddle two ranks' blocks
            level = torch_poseidon.hash_level_planar(level)
            levels.append(level)
        for i, r in enumerate(ranks):
            low[r] = [lvl[:, i * (lvl.shape[1] // k):(i + 1) * (lvl.shape[1] // k)].contiguous()
                      if k > 1 else lvl for lvl in levels]
    return ShardedTree(mesh=mesh, width=width, height=height, shards=list(shards), low=low,
                       top=_top(mesh, low))


def _top(mesh, low: list) -> list:
    """The top levels from the d subtree roots, hashed on the lead."""
    roots = mesh.gather_list([None if lv is None else lv[-1].reshape(-1) for lv in low])
    top = [torch.stack(roots, dim=1)]
    while top[-1].shape[1] > 1:
        top.append(torch_poseidon.hash_level_planar(top[-1]))
    return top


def shard_tree(tree: dev.DeviceTree, mesh) -> ShardedTree:
    """A whole tree on this process's lead (a const tree from
    stark.setup.load_setup) split over the mesh: each rank gets a copy of
    its element rows and its subtree's levels on its device; the top levels
    and the `base` columns stay where they are.  stark.prover.prove(mesh=)
    takes the split, made once for every prove on that mesh.  The split
    holds nothing of the whole tree's rows, so a caller that drops the
    whole tree keeps each rank's rows once (on a virtual mesh too)."""
    d = mesh.size
    _check_height(tree.height, d)
    b = tree.height // d
    lb = b.bit_length() - 1
    shards = [None] * d
    low = [None] * d

    def copy(t, dv):  # a copy even on the tree's own device, not a view into it
        return t.to(dv, copy=True, memory_format=torch.contiguous_format)

    for r in mesh.local_ranks:
        dv = mesh.device(r)
        shards[r] = copy(tree.elements[:, r * b:(r + 1) * b], dv)
        low[r] = [copy(tree.levels[k][:, r * (b >> k):(r + 1) * (b >> k)], dv)
                  for k in range(lb + 1)]
    return ShardedTree(mesh=mesh, width=tree.width, height=tree.height, shards=shards, low=low,
                       top=list(tree.levels[lb:]), base=tree.base)


def gather_group_proofs_multi(trees, idxs_list):
    """Values and sibling paths of every query of every tree, as
    stark.device.gather_group_proofs_multi gives them.  The sharded trees
    (one mesh) answer in one exchange: each rank sends every process's
    lead the element rows and lower siblings of the queries whose rows it
    owns; the top siblings come from the lead's own levels."""
    sharded = [i for i, t in enumerate(trees) if isinstance(t, ShardedTree)]
    plain = [i for i in range(len(trees)) if i not in sharded]
    results = [None] * len(trees)
    if plain:
        got = dev.gather_group_proofs_multi([trees[i] for i in plain],
                                            [idxs_list[i] for i in plain])
        for i, res in zip(plain, got):
            results[i] = res
    if not sharded:
        return results
    mesh = trees[sharded[0]].mesh
    if any(trees[i].mesh is not mesh for i in sharded):
        raise ValueError("the sharded trees of one query gather share one mesh")
    d = mesh.size

    def owned(t, idxs, r):
        b = t.rows_per_rank
        return [(q, i % b) for q, i in enumerate(idxs) if i // b == r]

    def span(t):
        return t.width + 4 * (t.rows_per_rank.bit_length() - 1)

    sends, shapes = {}, {}
    leads = [mesh.lead_rank(p) for p in range(mesh.n_processes)]
    me = mesh.lead_rank(mesh.process_index)
    for r in range(d):
        words = sum(span(trees[i]) * len(owned(trees[i], idxs_list[i], r)) for i in sharded)
        shapes[(r, me)] = (words,)
        if r not in mesh.local_ranks:
            continue
        parts = []
        for i in sharded:
            t = trees[i]
            loc = [li for _, li in owned(t, idxs_list[i], r)]
            if not loc:
                continue
            cur = torch.as_tensor(np.asarray(loc, dtype=np.int64), device=mesh.device(r))
            cols = [t.shards[r][:, cur]]
            for lvl in t.low[r][:-1]:
                cols.append(lvl[:, cur ^ 1])
                cur = cur >> 1
            parts.append(torch.cat(cols).T.reshape(-1))  # query-major
        data = (torch.cat(parts) if parts
                else torch.empty(0, dtype=torch.int64, device=mesh.device(r)))
        for lead in leads:
            sends[(r, lead)] = data
    got = mesh.exchange(sends, shapes)
    host = [gl.to_u64(got[(r, me)]) for r in range(d)]
    pos = [0] * d
    for i in sharded:
        t, idxs = trees[i], idxs_list[i]
        w, lb = t.width, t.rows_per_rank.bit_length() - 1
        sp = span(t)
        # the top siblings of every query, on the lead, in one transfer
        up = torch.as_tensor(np.asarray(idxs, dtype=np.int64) >> lb, device=mesh.lead)
        tops = []
        for lvl in t.top[:-1]:
            tops.append(lvl[:, up ^ 1])
            up = up >> 1
        top_host = gl.to_u64(torch.cat(tops).T) if tops else np.zeros((len(idxs), 0), np.uint64)
        out = [None] * len(idxs)
        for r in range(d):
            for q, _ in owned(t, idxs, r):
                row = host[r][pos[r]:pos[r] + sp]
                pos[r] += sp
                proof = [row[w + 4 * k: w + 4 * (k + 1)].copy() for k in range(lb)]
                proof += [top_host[q, 4 * k: 4 * (k + 1)].copy()
                          for k in range(len(t.top) - 1)]
                out[q] = (row[:w].copy(), proof)
        results[i] = out
    return results
