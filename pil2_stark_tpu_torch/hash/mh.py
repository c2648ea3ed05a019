"""Merkle-hash backend selector — the interface the prover, FRI and the
verifier talk to for roots, path checks and transcripts (counterpart of
pil2_stark_tpu/hash/mh.py; the trees themselves are built on the device by
stark/device.py).

The port supports the Poseidon-GL backend only.  ``verificationHashType``
BN128 (the recursion-to-SNARK tier) raises NotImplementedError.
"""
from __future__ import annotations

from . import merkle as merkle_gl
from .transcript import Transcript


class MerkleHashGL:
    hash_type = "GL"

    def __init__(self, split_linear_hash=False):
        self.split_linear_hash = split_linear_hash

    def root(self, tree):
        return tree.root

    def verify_group_proof(self, root, proof, idx, values):
        return merkle_gl.verify_group_proof(root, proof, idx, values, self.split_linear_hash)

    def new_transcript(self):
        return Transcript()


def build_mh(stark_struct: dict):
    hash_type = stark_struct.get("verificationHashType", "GL")
    if hash_type == "GL":
        return MerkleHashGL(stark_struct.get("splitLinearHash", False))
    if hash_type == "BN128":
        raise NotImplementedError("BN128 Merkle trees are not ported yet")
    raise ValueError(f"Invalid Hash Type: {hash_type}")
