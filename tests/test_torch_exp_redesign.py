"""The Poseidon experiment kernels on B4's schedule (X2
csrc/poseidon_variants.cu, X1 csrc/poseidon_stream.cu) on the CPU: the
python-int twin of the schedule template that both instantiate
(hash/cuda_poseidon.py::permute_schedule_int, csrc/poseidon_fast.cuh
Schedule) against each variant's plain version, the control variant
``packed-nosq-lazy`` against B4 and the JAX experiment's body, and X1's
wrapper on its CPU path.  Tolerance: none — bit for bit.  torch runs on
one thread.
"""
import numpy as np
import pytest
import torch

from pil2_stark_tpu.hash import poseidon_gl as jposeidon
from pil2_stark_tpu_torch.field import torch_gl
from pil2_stark_tpu_torch.hash import cuda_poseidon
from pil2_stark_tpu_torch.tools import exp_poseidon, exp_stream

from test_torch_exp_poseidon import (CORNERS, P, _first_round_overflow, jax_body,  # noqa: F401
                                     load_tool, one_thread)

W = (1 << 64) - 1
VARIANTS = ["packed", "packed-nosq", "packed-lazy", "packed-nosq-lazy", "packed-dual",
            "packed-lazy-dual", "packed-p4x", "packed-psl", "nomxu", "packed-nops",
            "packed-nofs", "nosq-nomxu", "packed-nosq-nops", "packed-nosq-nofs"]


def _states(n, seed):
    s = np.random.default_rng(seed).integers(0, P, size=(n, 12), dtype=np.uint64)
    s[0] = np.array(CORNERS, dtype=np.uint64)
    s[1] = np.uint64(P - 1)
    s[2] = np.arange(12, dtype=np.uint64)
    s[3, 0] = _first_round_overflow()
    return s


def test_control_variant_is_b4():
    """packed-nosq-lazy parses to B4's schedule (no squares, lazy, one
    state a thread), and its plain version equals B4's and the JAX body on
    2^8 random and corner states."""
    v = exp_poseidon.parse("packed-nosq-lazy")
    assert v == exp_poseidon.Variant(sq=False, lazy=True, dual=False, probe=None)
    states = _states(256, 17)
    x = torch_gl.from_u64(states.T.copy())
    got = exp_poseidon.build("packed-nosq-lazy", 1, 256)(x)
    assert torch.equal(got, cuda_poseidon.permute_plain(x))
    want = jax_body(load_tool("exp_poseidon"), "packed-nosq-lazy", states)
    np.testing.assert_array_equal(torch_gl.to_u64(got).T, want)
    np.testing.assert_array_equal(want, jposeidon.permute(states))


def test_schedule_twin_equals_plain():
    """Every variant's instance of the schedule on python ints, with the
    kernel's representative at each step, equals its plain version word
    for word: the probes (nomxu's flips of a first-round sum in [p, 2^64)
    included) and non-canonical u64 inputs."""
    states = _states(12, 5)
    states[4] = np.array([P, P + 1, W, W - 1, P + 5, P + (1 << 31), 0, 1, 2, P - 1, 3, 4],
                         dtype=np.uint64)
    x = torch_gl.from_u64(states.T.copy())
    for variant in VARIANTS:
        want = torch_gl.to_u64(exp_poseidon.permute_variant_plain(x, variant)).T
        for k in range(states.shape[0]):
            got = exp_poseidon.permute_variant_int([int(w) for w in states[k]], variant)
            assert got == [int(w) for w in want[k]], (variant, k)
    assert cuda_poseidon.permute_fast_int(states[4]) == exp_poseidon.permute_variant_int(
        states[4], "packed-nosq-lazy")


def test_sqr_wide_and_add_c_at_extremes():
    """sqr_wide's three partial products give a^2 exactly; add_c folds one
    carry and stays a u64 representative; canon gives the residue."""
    for a in (0, 1, W, P, P - 1, 1 << 32, (1 << 32) - 1, 1 << 63, 0xDEADBEEF12345678):
        lo, hi = cuda_poseidon.sqr_wide(a)
        assert lo + (hi << 64) == a * a
        for c in (0, 1, P - 1, 0xFFFFFFFF):
            r = cuda_poseidon.add_c(a, c)
            assert 0 <= r <= W and r % P == (a + c) % P
        assert cuda_poseidon.canon(a) == a % P


def test_stream_on_cpu():
    """X1's wrapper on the CPU over two tiles: any u64 words (non-canonical
    ones included) give B4's python-int twin's output, no launch is
    counted, and a batch of 11 rows is refused."""
    states = _states(2 * exp_stream.BLK, 9)
    states[5] = np.array([P, P + 1, W, W - 1, P + 5, P + (1 << 31), 0, 1, 2, P - 1, 3, 4],
                         dtype=np.uint64)
    x = torch_gl.from_u64(states.T.copy())
    before = exp_stream.permute_stream.launches
    got = torch_gl.to_u64(exp_stream.build_stream(2)(x)).T
    assert exp_stream.permute_stream.launches == before
    for k in (0, 1, 2, 3, 5, exp_stream.BLK + 7):
        assert [int(w) for w in got[k]] == cuda_poseidon.permute_fast_int(states[k]), k
    with pytest.raises(ValueError):
        exp_stream.permute_stream(x[:11])


def test_decompose_on_cpu():
    """decompose times B4, the control, each base and each probe on one
    input and splits B4's time by base − probe (numbers of the CPU here,
    the device named)."""
    res = exp_poseidon.decompose("cpu", bits=(8,), block=256, chain=(1, 1))
    size = res["sizes"][8]
    assert res["device"] == "cpu" and len(size["b4_ms"]) == 2
    assert set(size["ms"]) == {exp_poseidon.CONTROL, "packed-lazy", *exp_poseidon.DECOMPOSITION,
                               *(p for ps in exp_poseidon.DECOMPOSITION.values() for p in ps)}
    for probe, d in size["drops"].items():
        assert d["dropped_ms"] == size["ms"][d["base"]] - size["ms"][probe]
