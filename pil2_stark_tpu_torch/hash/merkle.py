"""Poseidon-GL Merkle tree on the host (arity 2 over 4-element digests).

Reproduces the reference's tree shape bit-exactly
(pil2-stark-js src/helpers/hash/merklehash/merklehash_p.js):

- leaves: linear hash of each `width`-element row (normal or split layout);
- every non-root level is padded with zero digests to an even count,
  per the `_getNNodes` rule nextN = (floor((n-1)/8)+1)*4 (merklehash_p.js:28-42);
- inner nodes: poseidon(left4 || right4, zero capacity)[:4];
- proofs: per-level sibling digest, sibling index idx^1 within the padded
  level (merklehash_p.js:142-168);
- files: header (width, height) u64 LE, then the elements row-major, then
  the flat node buffer (padded levels concatenated, root last)
  (merklehash_p.js:228-278).

Host copy of pil2_stark_tpu/hash/merkle.py's host backend.  The prover
builds its trees on the device (stark/device.py); this module serves the
verifier (``verify_group_proof`` hashes one path), small host trees and the
tree files (stark/device.py::to_host_tree turns a device tree into a
MerkleTree).  As in the JAX package, the leaves (normal layout), the levels
and the path hashes run on the host C++ runtime (runtime/native.py;
``native.plain_hashing()`` swaps in the python-int versions it is held
against).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..runtime import native
from . import linearhash


@dataclasses.dataclass
class MerkleTree:
    width: int
    height: int
    elements: np.ndarray  # (height, width) uint64, row-major
    levels: list  # [level0 (padded), ..., root (1,4)] each (n,4) uint64

    @property
    def root(self) -> np.ndarray:
        return self.levels[-1][0]

    def nodes_flat(self) -> np.ndarray:
        return np.concatenate([lvl.reshape(-1) for lvl in self.levels])


def level_sizes(height: int) -> list:
    """Digests per stored level of a tree of `height` leaves: each level
    below the root padded to an even count, the root alone."""
    sizes = []
    n = height
    while n > 1:
        sizes.append(2 * ((n + 1) // 2))
        n = (n + 1) // 2
    return sizes + [1]


def levels_from_nodes(nodes: np.ndarray, height: int) -> list:
    """Split a flat node buffer into its (n, 4) levels."""
    levels, pos = [], 0
    for n in level_sizes(height):
        levels.append(nodes[pos * 4:(pos + n) * 4].reshape(n, 4).astype(np.uint64))
        pos += n
    return levels


def _pad_even(digests: np.ndarray) -> np.ndarray:
    n = digests.shape[0]
    target = 2 * ((n + 1) // 2)
    if target == n:
        return digests
    out = np.zeros((target, 4), dtype=np.uint64)
    out[:n] = digests
    return out


def merkelize(buff: np.ndarray, width: int, height: int,
              split_linear_hash: bool = False) -> MerkleTree:
    elements = np.asarray(buff, dtype=np.uint64).reshape(height, width)
    fn = linearhash.linear_hash_split if split_linear_hash else native.linear_hash
    levels = [_pad_even(fn(elements))]
    n = height
    while n > 1:
        nxt = native.merkle_level(levels[-1])
        n = nxt.shape[0]
        levels.append(_pad_even(nxt) if n > 1 else nxt)
    return MerkleTree(width=width, height=height, elements=elements, levels=levels)


def get_group_proof(tree: MerkleTree, idx: int):
    """Returns (row values, sibling path) as in merklehash_p.js:140-167."""
    if idx < 0 or idx >= tree.height:
        raise IndexError("Out of range")
    values = tree.elements[idx].copy()
    proof = []
    i = idx
    for lvl in tree.levels[:-1]:
        proof.append(lvl[i ^ 1].copy())
        i >>= 1
    return values, proof


def _sponge_int(values: list, permute) -> list:
    """linearhash.linear_hash of one row, on python ints."""
    if len(values) <= 4:
        return values + [0] * (4 - len(values))
    st = [0, 0, 0, 0]
    for c in range(0, len(values), 8):
        chunk = values[c:c + 8]
        st = permute(chunk + [0] * (8 - len(chunk)) + st)[:4]
    return st


def _linear_hash_int(values: list, split: bool) -> list:
    if split and len(values) > 4:
        w = len(values)
        batch = int(max(8, (w + 3) / 4))
        cat = []
        for s in range(0, w, batch):
            cat += _sponge_int(values[s:s + batch], native.permute_int)
        return _sponge_int(cat, native.permute_int)
    return [int(v) for v in native.linear_hash(np.array([values], dtype=np.uint64))[0]]


def calculate_root_from_proof(proof, idx: int, values, split_linear_hash: bool = False):
    """Recompute the root from a (values, siblings) proof
    (merklehash_p.js:169-206)."""
    h = _linear_hash_int([int(v) for v in values], split_linear_hash)
    for sib in proof:
        sib = [int(v) for v in sib]
        inp = sib + h if idx & 1 else h + sib
        h = [int(v) for v in native.merkle_level(np.array(inp, dtype=np.uint64).reshape(2, 4))[0]]
        idx >>= 1
    return np.array(h, dtype=np.uint64)


def verify_group_proof(root, proof, idx: int, values, split_linear_hash: bool = False) -> bool:
    got = calculate_root_from_proof(proof, idx, values, split_linear_hash)
    return bool(np.array_equal(np.asarray(root, dtype=np.uint64), got))


# ---------------------------------------------------------------------------
# file round trip (merklehash_p.js:228-278 layout)


def write_tree(tree: MerkleTree, path: str) -> None:
    """The bytes of pil2_stark_tpu/hash/merkle.py::write_tree, written from
    the tree's arrays without copying them."""
    with open(path, "wb") as f:
        np.array([tree.width, tree.height], dtype="<u8").tofile(f)
        np.ascontiguousarray(tree.elements, dtype="<u8").tofile(f)
        for lvl in tree.levels:
            np.ascontiguousarray(lvl, dtype="<u8").tofile(f)


def read_tree(path: str) -> MerkleTree:
    with open(path, "rb") as f:
        width, height = (int(x) for x in np.fromfile(f, dtype="<u8", count=2))
        elements = np.fromfile(f, dtype="<u8", count=width * height).reshape(height, width)
        nodes = np.fromfile(f, dtype="<u8")
    return MerkleTree(width=width, height=height, elements=elements.astype(np.uint64),
                      levels=levels_from_nodes(nodes, height))
