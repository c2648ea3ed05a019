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


# ---- the python-int twin of kernel B4's schedule (csrc/poseidon_fast.cuh) --

W = (1 << 64) - 1
EPS32 = 0xFFFFFFFF
PRODUCT_CASES = {
    "max_products": [(W, W)] * 12,
    "zero": [(0, 0)] * 12,
    "multiples_of_p": [(P, W), (2 * P - (1 << 64) + W, P - 1)] + [(P, P)] * 10,
    "p_minus_1": [(P - 1, P - 1)] * 12,
    "mixed": [(W, P - 1), (P, 1), (0, W), (1 << 63, 1 << 32)] * 3,
}


@pytest.mark.parametrize("case", sorted(PRODUCT_CASES))
def test_fast_dot_product_reduces_once(case):
    """Twelve 128-bit products in three words (a2 < 16), one reduce192;
    the result is a u64 representative of the sum mod p."""
    terms = [(a & W, b & W) for a, b in PRODUCT_CASES[case]]
    acc = (0, 0, 0)
    for a, b in terms:
        acc = cuda_poseidon.acc3_mad(acc, a, b)
    exact = sum(a * b for a, b in terms)
    assert acc[0] + (acc[1] << 64) + (acc[2] << 128) == exact
    assert acc[2] < 16
    r = cuda_poseidon.reduce192(acc)
    assert 0 <= r <= W and r % P == exact % P
    assert cuda_poseidon.dot_lazy(*zip(*terms)) == r


@pytest.mark.parametrize("a,b,c", [(W, W, W), (0, 0, 0), (P, P, P), (W, P - 1, P - 1),
                                   (1, 1, W), (P - 1, 2, 0), (1 << 32, 1 << 32, 0)])
def test_fast_mad_reduce_at_extremes(a, b, c):
    """a·b + c: the carry chain keeps the 128-bit sum exact, the reduction
    folds one borrow and one carry and leaves a u64 representative."""
    lo, hi = cuda_poseidon.mad_wide(a, b, c)
    assert lo + (hi << 64) == a * b + c
    r = cuda_poseidon.mad_reduce(a, b, c)
    assert 0 <= r <= W and r % P == (a * b + c) % P
    assert cuda_poseidon.mul_lazy(a, b) % P == a * b % P


def test_fast_reductions_random_and_borrow_paths():
    rng = np.random.default_rng(4)
    words = [int(v) for v in rng.integers(0, 1 << 64, size=3000, dtype=np.uint64)]
    edges = [0, 1, EPS32, EPS32 + 1, P - 1, P, W]
    words[:len(edges)] = edges
    for lo, hi in zip(words[::2], words[1::2]):
        assert cuda_poseidon.reduce128(lo, hi) % P == (lo + (hi << 64)) % P
    for lo, hh, hl in [(0, (1 << 36) - 1, EPS32), (5, 6, 0), (W, 0, EPS32), (0, 1, 0)]:
        r = cuda_poseidon.reduce(lo, hh, hl)  # lo < hh takes the borrow fold
        assert 0 <= r <= W and r % P == (lo + (hl << 64) + (hh << 96)) % P
    s = [W] * 12
    assert [x % P for x in cuda_poseidon.mds_lazy(s)] == [
        sum(W * int(cuda_poseidon.ref.M[j][i]) for j in range(12)) % P for i in range(12)]


def test_fast_schedule_twin_matches_oracle():
    """The kernel's schedule on python ints, from any u64 state, equals the
    numpy oracle on the state's canonical residues."""
    rng = np.random.default_rng(5)
    states = [list(range(12)), [0] * 12, [P - 1] * 12, [W] * 12, [P] * 12,
              [int(v) for v in rng.integers(P, 1 << 64, size=12, dtype=np.uint64)],
              [int(v) for v in rng.integers(0, P, size=12, dtype=np.uint64)]]
    want = jposeidon.permute(np.array([[v % P for v in st] for st in states], dtype=np.uint64))
    for st, w in zip(states, want):
        assert cuda_poseidon.permute_fast_int(st) == [int(v) for v in w]
    assert cuda_poseidon.permute_fast_int(list(range(12)))[:4] == GOLDEN
