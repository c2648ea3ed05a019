"""PyTorch port's Poseidon-GL permutation (plain version of kernel B4), the
planar sponge and Merkle levels against the JAX package's numpy oracle,
its host Merkle tree and the reference's golden digest.  Tolerance: none —
exact, bit for bit.  (The Pallas Poseidon is never run here: its interpret
mode hangs on the CPU.)
"""
import numpy as np
import pytest

from pil2_stark_tpu.hash import linearhash as jlinear, merkle as jmerkle, poseidon_gl as jposeidon
from pil2_stark_tpu_torch.field import torch_gl
from pil2_stark_tpu_torch.hash import cuda_poseidon, merkle, poseidon_gl, torch_poseidon
from pil2_stark_tpu_torch.hash.transcript import Transcript
from pil2_stark_tpu_torch.utils import cuda_build

P = 0xFFFFFFFF00000001
GOLDEN = [0xD64E1E3EFC5B8E9E, 0x53666633020AAA47, 0xD40285597C6A8825, 0x613A4F81E81231D2]


def _rand(shape, seed):
    return np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)


def test_plain_permutation_matches_oracle_and_golden():
    states = _rand((300, 12), 0)
    states[:12] = np.uint64(P - 1)
    states[12] = np.arange(12, dtype=np.uint64)
    got = torch_gl.to_u64(cuda_poseidon.permute(torch_gl.from_u64(states.T.copy()))).T
    np.testing.assert_array_equal(got, jposeidon.permute(states))
    assert [int(x) for x in got[12, :4]] == GOLDEN
    assert poseidon_gl.permute_int(list(range(12)))[:4] == GOLDEN
    assert poseidon_gl.permute_int([int(v) for v in states[5]]) == [int(v) for v in got[5]]


def test_constants_header_is_current():
    text = (cuda_build.CSRC / "poseidon_constants.cuh").read_text()
    assert text == cuda_poseidon.constants_header()


@pytest.mark.parametrize("width", [1, 4, 5, 8, 15, 24])
@pytest.mark.parametrize("split", [False, True])
def test_linear_hash_planar_matches_host(width, split):
    rows = _rand((37, width), width)
    cols = torch_gl.from_u64(rows.T.copy())
    if split:
        got = torch_poseidon.linear_hash_split_planar(cols, width)
        want = jlinear.linear_hash_split(rows)
    else:
        got = torch_poseidon.linear_hash_planar(cols, width)
        want = jlinear.linear_hash(rows)
    np.testing.assert_array_equal(torch_gl.to_u64(got).T, want)
    for i in (0, 36):
        assert merkle._linear_hash_int([int(v) for v in rows[i]], split) == [int(v) for v in want[i]]


@pytest.mark.parametrize("width,height,split", [(9, 64, False), (3, 37, False), (15, 32, True)])
def test_merkle_levels_planar_matches_host_tree(width, height, split):
    rows = _rand((height, width), height)
    levels = torch_poseidon.merkle_levels_planar(torch_gl.from_u64(rows.T.copy()), width, height, split)
    tree = jmerkle.merkelize(rows, width, height, split_linear_hash=split, backend="np")
    assert len(levels) == len(tree.levels)
    for got, want in zip(levels, tree.levels):
        np.testing.assert_array_equal(torch_gl.to_u64(got).T, want)
    host = merkle.merkelize(rows, width, height, split)
    np.testing.assert_array_equal(host.root, tree.root)
    for idx in (0, height - 1):
        values, proof = merkle.get_group_proof(host, idx)
        assert merkle.verify_group_proof(tree.root, proof, idx, values, split)
        assert not merkle.verify_group_proof(tree.root, proof, idx ^ 1, values, split)


def test_transcript_matches_jax():
    from pil2_stark_tpu.hash.transcript import Transcript as JTranscript

    a, b = Transcript(), JTranscript()
    for t in (a, b):
        t.put([1, 2, 3, P - 1])
        t.put(list(range(11)))
    assert a.get_field() == b.get_field()
    assert a.get_state() == b.get_state()
    assert a.get_permutations(16, 12) == b.get_permutations(16, 12)
