"""PyTorch port's planar NTT / iNTT / LDE (ops/ntt.py) and the plain
versions of kernels B2 and B3 (ops/cuda_ntt.py) against the JAX package.

On the CPU the JAX package's ntt_u64/intt_u64/lde_u64 take their axis-0 jnp
path (the planar path needs a TPU), which computes the same transform;
ntt_host_u64 is the numpy oracle.  The plain B2/B3 are held against the
Pallas kernels in interpret mode at one small shape (B3's lazy output
reduced mod p).  Tolerance: none — exact field arithmetic, compared bit for
bit.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pil2_stark_tpu.field import jax_gl
from pil2_stark_tpu.ops import ntt as jntt, pallas_ntt
from pil2_stark_tpu_torch.field import torch_gl
from pil2_stark_tpu_torch.ops import cuda_ntt, ntt

P = 0xFFFFFFFF00000001


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch's multi-threaded int64 ops are slow on small CPU tensors: a
    2^14 x 5 NTT takes seconds on 8 threads and tens of ms on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(shape, seed):
    a = np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)
    a.reshape(-1)[:4] = [0, 1, P - 1, P - 2]
    return a


@pytest.mark.parametrize("bits,cols", [(8, 3), (12, 2), (14, 2)])
def test_ntt_intt_match_jax(bits, cols):
    x = _rand((cols, 1 << bits), bits * 10 + cols)
    tx = torch_gl.from_u64(x)
    np.testing.assert_array_equal(torch_gl.to_u64(ntt.ntt(tx, bits)),
                                  jntt.ntt_u64(x.T.copy(), bits).T)
    np.testing.assert_array_equal(torch_gl.to_u64(ntt.intt(tx, bits)),
                                  jntt.intt_u64(x.T.copy(), bits).T)


@pytest.mark.parametrize("bits,cols", [(2, 1), (5, 2), (8, 1), (9, 4), (11, 3), (13, 3), (14, 5),
                                       (13, 1)])  # one column above 2^12: B2 then B3
def test_ntt_intt_match_host_oracle(bits, cols):
    x = _rand((cols, 1 << bits), bits * 10 + cols + 1)
    tx = torch_gl.from_u64(x)
    np.testing.assert_array_equal(torch_gl.to_u64(ntt.ntt(tx, bits)),
                                  jntt.ntt_host_u64(x.T.copy(), bits).T)
    inv = torch_gl.to_u64(ntt.intt(tx, bits))
    np.testing.assert_array_equal(inv, jntt.ntt_host_u64(x.T.copy(), bits, inverse=True).T)
    np.testing.assert_array_equal(inv, ntt.ntt_host_u64(x.T.copy(), bits, inverse=True).T)


@pytest.mark.parametrize("bits,ext_bits,cols", [(8, 10, 3), (13, 14, 2), (10, 13, 1)])
def test_lde_planar_matches_jax(bits, ext_bits, cols):
    x = _rand((cols, 1 << bits), bits + ext_bits + cols)
    got = torch_gl.to_u64(ntt.lde_planar(torch_gl.from_u64(x), bits, ext_bits))
    np.testing.assert_array_equal(got, jntt.lde_u64(x.T.copy(), bits, ext_bits).T)


def test_intt_rows_matches_host():
    x = _rand((8, 3 * 16), 9)
    got = torch_gl.to_u64(ntt.intt_rows(torch_gl.from_u64(x), 3))
    np.testing.assert_array_equal(got, jntt.ntt_host_u64(x, 3, inverse=True))


@pytest.mark.parametrize("inverse", [False, True])
def test_plain_b2_b3_match_pallas_interpret(inverse):
    """bits1 = 7, n2 = 128, C = 1: the smallest shape the Pallas kernels
    tile.  The port's kernels take natural-order input (the bit-reverse
    gather is fused); the Pallas ones take it gathered."""
    bits1, bits2, c = 7, 7, 1
    n1, n2 = 1 << bits1, 1 << bits2
    x = _rand((c, n1 * n2), 21 + inverse)
    lt = jntt._twiddle_consts(bits1 + bits2, bits1, inverse)
    rev1 = jntt.bit_reverse_indices(bits1)
    xr = x.reshape(c, n1, n2).transpose(1, 0, 2).reshape(n1, c * n2)[rev1]
    y_ref = jax_gl.to_u64(pallas_ntt.level_planar(
        jax_gl.from_u64(xr), bits1, n2, c, (jnp.asarray(lt[0]), jnp.asarray(lt[1])),
        inverse, interpret=True))
    lt_t = torch_gl.from_u64(lt[0].astype(np.uint64) | (lt[1].astype(np.uint64) << np.uint64(32)))
    y = cuda_ntt.level_planar(torch_gl.from_u64(x), bits1, n2, c, lt_t, inverse)
    np.testing.assert_array_equal(torch_gl.to_u64(y), y_ref % np.uint64(P))

    idx = np.add.outer(np.arange(c) * n2, jntt.bit_reverse_indices(bits2)).reshape(-1)
    z_ref = jax_gl.to_u64(pallas_ntt.base_grid(
        jax_gl.from_u64(y_ref[idx]), bits2, c, inverse, interpret=True))
    z = cuda_ntt.base_grid(y, bits2, c, inverse)
    np.testing.assert_array_equal(torch_gl.to_u64(z), z_ref % np.uint64(P))


def test_split_bits_keeps_a_2_12_factor():
    """Up to 2^24 one factor stays at 2^12; above, the JAX rule halves
    (2^25 splits 12 + 13), so transforms past the planar ceiling run."""
    assert [ntt.split_bits(b) for b in (8, 12, 13, 20, 22, 24)] == [0, 0, 1, 8, 10, 12]
    assert [ntt.split_bits(b) for b in range(13, 31)] == [jntt._split_bits(b) for b in range(13, 31)]
    assert ntt.split_bits(25) == 12
