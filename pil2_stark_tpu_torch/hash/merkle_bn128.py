"""Arity-N Poseidon-BN254 Merkle tree (the recursion-to-SNARK tier).

Host copy of pil2_stark_tpu/hash/merkle_bn128.py, itself pil2-stark-js
src/helpers/hash/merklehash/merklehash_bn128_p.js: leaves are rows of GL
values packed 3 per Fr and hashed by the arity-wide sponge
(linearhash.bn128.js); levels are zero-padded to a multiple of the arity
(`_getNNodes`); proofs carry whole sibling groups; the custom variant pads
the last chunk of the sponge to the full arity.  Python ints: the tier
runs at recursion sizes.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import poseidon_bn128

P = poseidon_bn128.P


def pack_gl3(vals) -> list[int]:
    """Pack GL u64 values 3 per Fr: v0 + v1·2^64 + v2·2^128
    (linearhash.bn128.js:14-42)."""
    out = []
    acc = 0
    acc_n = 0
    for v in vals:
        acc = (acc + (int(v) << (64 * acc_n))) % P
        acc_n += 1
        if acc_n == 3:
            out.append(acc)
            acc = 0
            acc_n = 0
    if acc_n:
        out.append(acc)
    return out


def linear_hash_bn128(vals, arity: int = 16, custom: bool = False) -> int:
    """Sponge over a row of GL values (linearhash.bn128.js hash)."""
    vals3 = pack_gl3(vals)
    if len(vals3) == 0:
        return 0
    if len(vals3) == 1:
        return vals3[0]
    st = 0
    in_hash: list[int] = []
    for v in vals3:
        in_hash.append(v)
        if len(in_hash) == arity:
            st = poseidon_bn128.poseidon(in_hash, st)
            in_hash = []
    if in_hash:
        if custom:
            while len(in_hash) % arity != 0:
                in_hash.append(0)
        st = poseidon_bn128.poseidon(in_hash, st)
    return st


@dataclasses.dataclass
class MerkleTreeBN128:
    arity: int
    custom: bool
    width: int
    height: int
    elements: np.ndarray  # (height, width) uint64 GL values
    levels: list  # [level0 padded, ..., root]; each a list[int] of Fr

    @property
    def root(self) -> int:
        return self.levels[-1][0]


def merkelize(buff, width: int, height: int, arity: int = 16,
              custom: bool = False) -> MerkleTreeBN128:
    elements = np.asarray(buff, dtype=np.uint64).reshape(height, width)
    digests = [linear_hash_bn128(elements[i], arity, custom) for i in range(height)]
    levels = []
    n = height
    cur = digests
    while True:
        padded = cur + [0] * ((-len(cur)) % arity)
        if n <= 1:
            levels.append(cur if cur else [0])
            break
        levels.append(padded)
        cur = [poseidon_bn128.poseidon(padded[i:i + arity], 0)
               for i in range(0, len(padded), arity)]
        n = len(cur)
    return MerkleTreeBN128(arity=arity, custom=custom, width=width, height=height,
                           elements=elements, levels=levels)


def get_group_proof(tree: MerkleTreeBN128, idx: int):
    """(row values, sibling groups) — merklehash_bn128_p.js:140-174."""
    if idx < 0 or idx >= tree.height:
        raise IndexError("Out of range")
    values = tree.elements[idx].copy()
    n_bits_arity = (tree.arity - 1).bit_length()
    proof = []
    i = idx
    for lvl in tree.levels[:-1]:
        group_start = i ^ (i & (tree.arity - 1))
        proof.append([lvl[group_start + k] if group_start + k < len(lvl) else 0
                      for k in range(tree.arity)])
        i >>= n_bits_arity
    return values, proof


def calculate_root_from_proof(proof, idx: int, values, arity: int = 16,
                              custom: bool = False) -> int:
    h = linear_hash_bn128(values, arity, custom)
    n_bits_arity = (arity - 1).bit_length()
    for sibs in proof:
        group = list(sibs)
        group[idx & (arity - 1)] = h
        h = poseidon_bn128.poseidon(group, 0)
        idx >>= n_bits_arity
    return h


def verify_group_proof(root: int, proof, idx: int, values, arity: int = 16,
                       custom: bool = False) -> bool:
    return calculate_root_from_proof(proof, idx, values, arity, custom) == int(root)
