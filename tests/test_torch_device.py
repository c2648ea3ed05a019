"""PyTorch port's device prover pieces (stark/device.py, stark/fri.py) against
the JAX package's host oracles at small sizes: the zerofier and domain
tables, xDivXSubXi, the batched query gather (including the zero-width
uniform trees) and one FRI fold.  Tolerance: none — exact, bit for bit."""
import numpy as np
import pytest

from pil2_stark_tpu.field import gl64, vf3
from pil2_stark_tpu.hash import merkle as jmerkle
from pil2_stark_tpu.ops import polutils as jpolutils
from pil2_stark_tpu.stark import fri as jfri
from pil2_stark_tpu_torch.field import torch_gl
from pil2_stark_tpu_torch.stark import device, fri

P = 0xFFFFFFFF00000001
BOUNDARIES = [
    {"name": "everyRow"},
    {"name": "firstRow"},
    {"name": "lastRow"},
    {"name": "everyFrame", "offsetMin": 1, "offsetMax": 2},
]


def _rand(shape, seed):
    return np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)


def test_domain_consts_match_host_tables():
    n_bits, n_bits_ext = 6, 8
    x_n, x_ext, zi = device.domain_consts(n_bits, n_bits_ext, BOUNDARIES, "cpu")
    np.testing.assert_array_equal(torch_gl.to_u64(x_n), gl64.powers(gl64.w(n_bits), 1 << n_bits))
    np.testing.assert_array_equal(
        torch_gl.to_u64(x_ext),
        gl64.mul(np.uint64(7), gl64.powers(gl64.w(n_bits_ext), 1 << n_bits_ext)))
    zh_inv = jpolutils.build_zh_inv(n_bits, n_bits_ext)
    want = [
        zh_inv,
        jpolutils.build_one_row_zerofier_inv(zh_inv, n_bits, n_bits_ext, 0),
        jpolutils.build_one_row_zerofier_inv(zh_inv, n_bits, n_bits_ext, (1 << n_bits) - 1),
        jpolutils.build_frame_zerofier_inv(zh_inv, n_bits, n_bits_ext, BOUNDARIES[3]),
    ]
    np.testing.assert_array_equal(torch_gl.to_u64(zi), np.stack(want))


def test_xdiv_matches_host():
    ext_bits = 7
    x = gl64.mul(np.uint64(7), gl64.powers(gl64.w(ext_bits), 1 << ext_bits))
    xis = [tuple(int(v) for v in _rand(3, s)) for s in (1, 2)]
    got = torch_gl.to_u64(device.compute_xdiv(torch_gl.from_u64(x), xis))
    for i, xi in enumerate(xis):
        den = vf3.sub(x, np.array(xi, dtype=np.uint64))
        want = vf3.mul(vf3.inv(den), x)  # (extN, 3)
        np.testing.assert_array_equal(got[i], want.T)


@pytest.mark.parametrize("width,height", [(5, 32), (0, 64)])
def test_query_gather_matches_host_tree(width, height):
    rows = _rand((height, width), width + height)
    tree = device.merkelize(torch_gl.from_u64(rows.T.copy()), width, height)
    ref = jmerkle.merkelize(rows, width, height, backend="np")
    np.testing.assert_array_equal(tree.root, ref.root)
    idxs = [0, 3, height - 1, 17]
    got = device.gather_group_proofs_multi([tree, tree], [idxs, idxs[::-1]])
    for res, order in zip(got, (idxs, idxs[::-1])):
        for (values, proof), i in zip(res, order):
            w_values, w_proof = jmerkle.get_group_proof(ref, i)
            np.testing.assert_array_equal(values, w_values)
            assert [list(p) for p in proof] == [list(p) for p in w_proof]


def test_fri_fold_matches_host():
    ss = {"nBits": 5, "nBitsExt": 8, "nQueries": 4,
          "steps": [{"nBits": 8}, {"nBits": 5}, {"nBits": 2}]}
    pol = _rand((1 << 8, 3), 4)  # a step-1 input: folds 2^8 -> 2^5 -> 2^2
    ch = tuple(int(v) for v in _rand(3, 5))
    want = jfri.FRI(ss).fold(1, pol, ch)
    got = fri.FRI(ss).fold(1, torch_gl.from_u64(np.ascontiguousarray(pol.T)), ch)
    np.testing.assert_array_equal(torch_gl.to_u64(got["pol"]).T, want["pol"])
    np.testing.assert_array_equal(got["proof"]["root"], want["proof"]["root"])
    last = fri.FRI(ss).fold(2, got["pol"], ch)
    want_last = jfri.FRI(ss).fold(2, want["pol"], ch)
    assert last["proof"] == want_last["proof"]
