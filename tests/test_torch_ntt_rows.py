"""PyTorch port's row-major NTT route (ops/ntt.py::axis0_ntt and the row
route of planar_ntt above its planar ceiling) and the plain version of
kernel B1 (ops/cuda_ntt.py::base_rows) against the JAX package.

The plain B1 is held against the Pallas base_ntt_brev in interpret mode
(which takes its rows already bit-reversed; the port gathers inside);
axis0_ntt against the JAX _axis0_ntt and the numpy oracle ntt_host_u64.  The
planar ceiling MAX_BITS is lowered so that transforms of 2^14-2^16 points
take the route the port runs above 2^24.  Tolerance: none — exact field
arithmetic, compared bit for bit.  torch runs on one thread: these shapes
are small, and the test workers share the host's cores.
"""
import numpy as np
import pytest
import torch

import jax

from pil2_stark_tpu.field import jax_gl
from pil2_stark_tpu.ops import ntt as jntt, pallas_ntt
from pil2_stark_tpu_torch.field import gl64, torch_gl
from pil2_stark_tpu_torch.ops import cuda_ntt, ntt

P = 0xFFFFFFFF00000001


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(shape, seed):
    a = np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)
    flat = a.reshape(-1)
    corners = np.array([0, 1, P - 1, P - 2], dtype=np.uint64)
    flat[: min(4, flat.size)] = corners[: min(4, flat.size)]
    return a


def _jax_axis0(x, bits, inverse):
    fn = jax.jit(lambda lo, hi: jntt._axis0_ntt((lo, hi), bits, inverse))
    return jax_gl.to_u64(fn(*jax_gl.from_u64(x))) % np.uint64(P)


@pytest.mark.parametrize("bits", [3, 7])
@pytest.mark.parametrize("inverse", [False, True])
def test_plain_b1_matches_pallas_interpret(bits, inverse):
    x = _rand((1 << bits, 128), 40 + bits + inverse)
    rev = jntt.bit_reverse_indices(bits)
    ref = jax_gl.to_u64(pallas_ntt.base_ntt_brev(jax_gl.from_u64(x[rev]), bits, inverse,
                                                 interpret=True))
    got = torch_gl.to_u64(cuda_ntt.base_rows(torch_gl.from_u64(x), bits, inverse))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("bits,lanes", [(1, 1), (3, 5), (12, 3), (13, 2), (15, 3)])
@pytest.mark.parametrize("inverse", [False, True])
def test_axis0_ntt_matches_jax_and_host(bits, lanes, inverse):
    """Both directions against the numpy oracle; the forward one also
    against the JAX recursion (the inverse runs the same code on inverted
    roots, and compiling it again costs seconds)."""
    x = _rand((1 << bits, lanes), 50 + bits * 7 + lanes + inverse)
    got = torch_gl.to_u64(ntt.axis0_ntt(torch_gl.from_u64(x), bits, inverse))
    if inverse:  # axis0_ntt leaves out 1/n, the host oracle applies it
        got = gl64.mul(got, np.uint64(pow(1 << bits, P - 2, P)))
    else:
        np.testing.assert_array_equal(got, _jax_axis0(x, bits, inverse))
    np.testing.assert_array_equal(got, ntt.ntt_host_u64(x, bits, inverse))


@pytest.mark.parametrize("bits", [7, 9])
def test_axis0_halving_split_matches_jax(monkeypatch, bits):
    """Above 2·BASE_BITS both packages split a transform in halves (bits //
    2); with the base lowered to 2^3 on both sides, a 2^7 or 2^9 transform
    takes that branch at a size the CPU runs quickly."""
    monkeypatch.setattr(ntt, "BASE_BITS", 3)
    monkeypatch.setattr(jntt, "_BASE_BITS", 3)
    assert ntt.split_bits(bits) == jntt._split_bits(bits) == bits // 2
    x = _rand((1 << bits, 3), 60 + bits)
    got = torch_gl.to_u64(ntt.axis0_ntt(torch_gl.from_u64(x), bits, False))
    np.testing.assert_array_equal(got, _jax_axis0(x, bits, False))
    np.testing.assert_array_equal(got, ntt.ntt_host_u64(x, bits))


@pytest.mark.parametrize("case", ["ntt_16", "intt_15", "lde_14_15"])
def test_row_route_matches_jax(monkeypatch, case):
    """With the planar ceiling at 2^13, ntt/intt/lde_planar run the row
    route the port takes above 2^24 and equal the JAX transforms.  The LDE
    is held against the host construction that pins jntt.lde_u64 in
    tests/test_pallas_ntt.py (iNTT, scale by 7^i, zero-pad, NTT): compiling
    lde_u64 at this size alone takes over 5 s on the CPU."""
    monkeypatch.setattr(ntt, "MAX_BITS", 13)
    calls = []
    real_axis0 = ntt.axis0_ntt
    monkeypatch.setattr(ntt, "axis0_ntt", lambda x, b, inv: calls.append(b) or real_axis0(x, b, inv))
    cols = 2
    routed = {"ntt_16": {16}, "intt_15": {15}, "lde_14_15": {14, 15}}[case]
    if case == "ntt_16":
        x = _rand((cols, 1 << 16), 71)
        y = ntt.ntt(torch_gl.from_u64(x), 16)
        np.testing.assert_array_equal(torch_gl.to_u64(y), jntt.ntt_u64(x.T.copy(), 16).T)
        np.testing.assert_array_equal(torch_gl.to_u64(ntt.intt(y, 16)), x)
    elif case == "intt_15":
        x = _rand((cols, 1 << 15), 72)
        got = torch_gl.to_u64(ntt.intt(torch_gl.from_u64(x), 15))
        np.testing.assert_array_equal(got, jntt.intt_u64(x.T.copy(), 15).T)
    else:
        x = _rand((cols, 1 << 14), 73)
        got = torch_gl.to_u64(ntt.lde_planar(torch_gl.from_u64(x), 14, 15))
        coefs = gl64.mul(jntt.ntt_host_u64(x.T.copy(), 14, inverse=True),
                         gl64.powers(7, 1 << 14)[:, None])
        padded = np.zeros((1 << 15, cols), dtype=np.uint64)
        padded[: 1 << 14] = coefs
        np.testing.assert_array_equal(got, jntt.ntt_host_u64(padded, 15).T)
    assert routed <= set(calls)  # every transform took the row route
