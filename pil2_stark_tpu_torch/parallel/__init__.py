"""The multi-device prover: a mesh of ranks (distributed.py), the sharded
NTT and LDE (ntt_sharded.py) and the sharded Merkle tree
(merkle_sharded.py), which stark.prover.prove(mesh=) runs its commits on."""
