"""Merkle-hash backend selector — the interface the prover, FRI and the
verifier talk to for trees, roots, path checks and transcripts (counterpart
of pil2_stark_tpu/hash/mh.py, itself the MH selection of pil2-stark-js
src/stark/stark_gen_helpers.js:91-102).  ``verificationHashType`` in the
starkStruct picks the backend: GL (Poseidon-GL, arity 2) for
STARK-inside-STARK recursion, BN128 (Poseidon-BN254, arity 16) for the
final recursion-to-SNARK tier.

Both take the planar (width, height) device columns the prover holds:
``merkelize(cols, width, height)`` and one batched
``get_group_proofs_multi(trees, idxs_list)``.  GL trees are built on the
device (stark/device.py, kernel B4).  BN128 trees are built on the host on
python ints, as in the JAX package, whose device backend refuses them: the
columns are copied to the host as row-major u64 once per tree.
"""
from __future__ import annotations

import dataclasses

import torch

from ..field import torch_gl as gl
from ..stark import device as dev
from . import merkle as merkle_gl
from . import merkle_bn128
from .transcript import Transcript
from .transcript_bn128 import TranscriptBN128


class MerkleHashGL:
    hash_type = "GL"

    def __init__(self, split_linear_hash=False):
        self.split_linear_hash = split_linear_hash

    def merkelize(self, cols: torch.Tensor, width: int, height: int) -> dev.DeviceTree:
        return dev.merkelize(cols, width, height, self.split_linear_hash)

    def root(self, tree):
        return tree.root

    def get_group_proofs_multi(self, trees, idxs_list):
        return dev.gather_group_proofs_multi(trees, idxs_list)

    def verify_group_proof(self, root, proof, idx, values):
        return merkle_gl.verify_group_proof(root, proof, idx, values, self.split_linear_hash)

    def new_transcript(self):
        return Transcript()


@dataclasses.dataclass
class TreeBN128:
    """A BN128 tree built on the host from planar device columns.
    ``elements`` keeps those columns, as DeviceTree.elements does (the
    prover reads the const tree's extended columns from there), and
    ``base`` the base-domain fixed columns of a const tree
    (stark.setup.load_setup), so that no prove uploads them again."""

    host: merkle_bn128.MerkleTreeBN128
    elements: torch.Tensor
    base: torch.Tensor | None = None

    @property
    def root(self) -> int:
        return self.host.root


class MerkleHashBN128:
    hash_type = "BN128"

    def __init__(self, arity=16, custom=False):
        self.arity = arity or 16
        self.custom = custom or False

    def merkelize(self, cols: torch.Tensor, width: int, height: int) -> TreeBN128:
        return TreeBN128(merkle_bn128.merkelize(gl.to_u64(cols.T), width, height, self.arity,
                                                self.custom), cols)

    def root(self, tree):
        return tree.root

    def get_group_proofs_multi(self, trees, idxs_list):
        return [[merkle_bn128.get_group_proof(t.host, i) for i in idxs]
                for t, idxs in zip(trees, idxs_list)]

    def verify_group_proof(self, root, proof, idx, values):
        return merkle_bn128.verify_group_proof(root, proof, idx, values, self.arity, self.custom)

    def new_transcript(self):
        return TranscriptBN128(self.arity if self.custom else 16, self.custom)


def build_mh(stark_struct: dict):
    hash_type = stark_struct.get("verificationHashType", "GL")
    if hash_type == "GL":
        return MerkleHashGL(stark_struct.get("splitLinearHash", False))
    if hash_type == "BN128":
        return MerkleHashBN128(stark_struct.get("merkleTreeArity", 16),
                               stark_struct.get("merkleTreeCustom", False))
    raise ValueError(f"Invalid Hash Type: {hash_type}")
