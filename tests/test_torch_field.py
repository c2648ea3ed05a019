"""PyTorch port's Goldilocks and cubic-extension arithmetic (field/torch_gl,
field/torch_f3) against the JAX package's jax_gl / jax_f3 and python ints.

Tolerance: none — field arithmetic is exact, results are compared bit for
bit.  The operands include the near-p and near-2^64 corners of
tests/test_lazy_gl.py and random × random pairs.  torch_gl's add/sub/neg
take canonical operands (the port's invariant), so those corners enter
them reduced mod p; mul and canon take any u64 bit pattern.
"""
import numpy as np
import pytest
import torch

from pil2_stark_tpu.field import jax_f3, jax_gl
from pil2_stark_tpu_torch.field import torch_f3, torch_gl

P = 0xFFFFFFFF00000001
EPS = 0xFFFFFFFF
EDGES = [
    0, 1, 2, EPS, EPS + 1, EPS - 1,
    P - 1, P, P + 1,
    2**64 - 1, 2**64 - 2, 2**64 - EPS, 2**64 - EPS - 1, 2**64 - EPS + 1,
    (EPS << 32), (EPS << 32) | 1, (EPS << 32) | EPS,
    2**63, 2**63 - 1, 2**32, 2**32 - 1, 2**32 + 1,
]


def _operands(canonical: bool):
    """All edge × edge pairs, edges × randoms and random × random pairs."""
    rng = np.random.default_rng(11)
    hi = P if canonical else 2**64
    rand = [int(x) for x in rng.integers(0, hi, 300, dtype=np.uint64)]
    edges = [e % P for e in EDGES] if canonical else list(EDGES)
    vals = edges + rand
    a, b = [], []
    for x in vals:
        for y in edges:
            a.append(x)
            b.append(y)
    rr = rng.integers(0, hi, size=(2, 2000), dtype=np.uint64)
    a = np.concatenate([np.array(a, dtype=np.uint64), rr[0]])
    b = np.concatenate([np.array(b, dtype=np.uint64), rr[1]])
    return a, b


def _jax(op, a, b=None):
    args = [jax_gl.from_u64(a)] + ([jax_gl.from_u64(b)] if b is not None else [])
    return jax_gl.to_u64(op(*args))


def _torch(op, a, b=None):
    args = [torch_gl.from_u64(a)] + ([torch_gl.from_u64(b)] if b is not None else [])
    return torch_gl.to_u64(op(*args))


def _want(fn, a, b):
    return np.array([fn(int(x), int(y)) % P for x, y in zip(a, b)], dtype=np.uint64)


@pytest.mark.parametrize("name,fn", [
    ("add", lambda x, y: x + y),
    ("sub", lambda x, y: x - y),
    ("mul", lambda x, y: x * y),
])
def test_binary_ops_match_jax_and_ints(name, fn):
    a, b = _operands(canonical=True)
    got = _torch(getattr(torch_gl, name), a, b)
    np.testing.assert_array_equal(got, _jax(getattr(jax_gl, name), a, b))
    np.testing.assert_array_equal(got, _want(fn, a, b))


def test_mul_and_canon_take_any_u64():
    a, b = _operands(canonical=False)
    got = _torch(torch_gl.mul, a, b)
    np.testing.assert_array_equal(got, _want(lambda x, y: x * y, a, b))
    np.testing.assert_array_equal(_torch(torch_gl.canon, a), a % np.uint64(P))


@pytest.mark.parametrize("name", ["neg", "square"])
def test_unary_ops_match_jax(name):
    a, _ = _operands(canonical=True)
    np.testing.assert_array_equal(_torch(getattr(torch_gl, name), a),
                                  _jax(getattr(jax_gl, name), a))


@pytest.mark.parametrize("e", [0, 1, 7, 255, P - 2])
def test_exp_const_matches_jax(e):
    a, _ = _operands(canonical=True)
    a = a[:500]
    got = torch_gl.to_u64(torch_gl.exp_const(torch_gl.from_u64(a), e))
    np.testing.assert_array_equal(got, jax_gl.to_u64(jax_gl.exp_const(jax_gl.from_u64(a), e)))


def test_mul_const_pow7_and_sum():
    a, b = _operands(canonical=True)
    k = 0xDEADBEEF12345678 % P
    np.testing.assert_array_equal(
        torch_gl.to_u64(torch_gl.mul_const(torch_gl.from_u64(a), k)),
        jax_gl.to_u64(jax_gl.mul_const(jax_gl.from_u64(a), k)))
    np.testing.assert_array_equal(
        torch_gl.to_u64(torch_gl.pow7(torch_gl.from_u64(a))),
        jax_gl.to_u64(jax_gl.pow7(jax_gl.from_u64(a))))
    m = a[: (a.size // 64) * 64].reshape(64, -1)
    got = torch_gl.to_u64(torch_gl.gl_sum(torch_gl.from_u64(m), 0))
    want = [sum(int(v) for v in m[:, j]) % P for j in range(m.shape[1])]
    assert [int(x) for x in got] == want


def test_f3_ops_match_jax():
    rng = np.random.default_rng(3)
    a = rng.integers(0, P, size=(3, 700), dtype=np.uint64)
    b = rng.integers(0, P, size=(3, 700), dtype=np.uint64)
    c = rng.integers(0, P, size=(1, 700), dtype=np.uint64)
    a[:, :22] = np.array([e % P for e in EDGES], dtype=np.uint64)
    cases = [(a, b), (a, c), (c, a), (c, c)]
    for x, y in cases:
        jx, jy = jax_gl.from_u64(x), jax_gl.from_u64(y)
        tx, ty = torch_gl.from_u64(x), torch_gl.from_u64(y)
        for name in ("add", "sub", "mul"):
            got = torch_gl.to_u64(getattr(torch_f3, name)(tx, ty))
            want = jax_gl.to_u64(getattr(jax_f3, name)(jx, jy))
            np.testing.assert_array_equal(got, want, err_msg=f"{name} {x.shape} {y.shape}")
        got = torch_gl.to_u64(torch_f3.muladd(tx, ty, tx))
        np.testing.assert_array_equal(got, jax_gl.to_u64(jax_f3.muladd(jx, jy, jx)))


def test_f3_inverse():
    rng = np.random.default_rng(5)
    a = torch_gl.from_u64(rng.integers(1, P, size=(3, 300), dtype=np.uint64))
    one = torch_f3.mul(a, torch_f3.inv(a))
    assert torch.equal(one[0], torch.ones_like(one[0]))
    assert torch.equal(one[1:], torch.zeros_like(one[1:]))


def test_u64_round_trip_and_powers():
    vals = np.array([0, 1, P - 1, 2**63, 2**63 - 1, 2**64 - 1], dtype=np.uint64)
    np.testing.assert_array_equal(torch_gl.to_u64(torch_gl.from_u64(vals)), vals)
    from pil2_stark_tpu.field import gl64

    np.testing.assert_array_equal(torch_gl.to_u64(torch_gl.powers(12345, 1000, start=7)),
                                  gl64.powers(12345, 1000, start=7))
