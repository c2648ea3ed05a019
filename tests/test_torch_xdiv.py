"""Kernel T2's formula for the xDivXSubXi table (csrc/tac.cu) on the CPU:
x/(x − xi) = 1 + (xi·x² + B1·x + c0)/N(x), with the host coefficients of
ops/cuda_tac.py::xdiv_coefficients and the zero rule (N(x) = 0 exactly at
x = xi, where the output is 0), evaluated with python ints over a 2^7-point
coset.  It must equal the port's plain version (stark/device.py::
compute_xdiv_plain) and the JAX package's compute_xdiv bit for bit.
Tolerance: none."""
import numpy as np
import pytest
import torch

from pil2_stark_tpu.field import jax_gl
from pil2_stark_tpu.stark import device as jdevice
from pil2_stark_tpu_torch.field import f3, gl64, torch_gl
from pil2_stark_tpu_torch.ops import cuda_tac
from pil2_stark_tpu_torch.stark import device

P = f3.P
EXT_BITS = 7


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch's threaded int64 ops are slow at this size on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _formula(xs, xi):
    """The kernel's arithmetic per point, one opening: (3, n) ints."""
    xi3, b1, c2, c1, c0 = cuda_tac.xdiv_coefficients(xi)
    out = [[], [], []]
    for x in xs:
        x2 = x * x % P
        n = (x2 * (x - c2) + c1 * x - c0) % P
        if n == 0:
            vals = (0, 0, 0)
        else:
            s = pow(n, P - 2, P)
            num = [(xi3[c] * x2 + b1[c] * x + (c0 if c == 0 else 0)) % P for c in range(3)]
            vals = ((1 + num[0] * s) % P, num[1] * s % P, num[2] * s % P)
        for c in range(3):
            out[c].append(vals[c])
    return out


def test_xdiv_formula_equals_plain_and_jax():
    x = gl64.mul(np.uint64(7), gl64.powers(gl64.w(EXT_BITS), 1 << EXT_BITS))
    rng = np.random.default_rng(8)
    xis = [tuple(int(v) for v in rng.integers(0, P, 3, dtype=np.uint64)) for _ in range(3)]
    xis.append((int(x[5]), 0, 0))  # x − xi is 0 at x[5]
    xs = [int(v) for v in x]
    want = np.array([_formula(xs, xi) for xi in xis], dtype=np.uint64)  # (nOpen, 3, n)
    assert not want[3, :, 5].any() and want[3, 0, 6] != 0

    plain = torch_gl.to_u64(device.compute_xdiv_plain(torch_gl.from_u64(x), xis))
    np.testing.assert_array_equal(plain, want)
    # one opening per call: one JAX compile, reused for every opening
    for o, xi in enumerate(xis):
        jax_out = jax_gl.to_u64(jdevice.compute_xdiv(jax_gl.from_u64(x), [xi]))  # (n, 1, 3)
        np.testing.assert_array_equal(np.asarray(jax_out)[:, 0].T, want[o])


def test_xdiv_coefficients_factor_the_norm():
    """(x − xi)·(x² + A1·x + A0) = N(x) with A1 = xi − c2, A0 = xi² − c2·xi
    + c1, and B1 = xi·A1, c0 = xi·A0, at random points and openings."""
    rng = np.random.default_rng(9)
    for _ in range(50):
        xi = tuple(int(v) for v in rng.integers(0, P, 3, dtype=np.uint64))
        x = int(rng.integers(0, P, dtype=np.uint64))
        xi3, b1, c2, c1, c0 = cuda_tac.xdiv_coefficients(xi)
        a1 = f3.sub(xi3, c2)
        a0 = f3.add(f3.sub(f3.mul(xi3, xi3), f3.mul(c2, xi3)), c1)
        adj = f3.add(f3.add(x * x % P, f3.mul(a1, x)), a0)
        assert f3.mul(f3.sub(x, xi3), adj) == ((x ** 3 - c2 * x * x + c1 * x - c0) % P, 0, 0)
        assert f3.mul(xi3, a1) == b1 and f3.mul(xi3, a0) == (c0, 0, 0)
