"""PyTorch port's streamed Poseidon (kernel X1,
pil2_stark_tpu_torch/tools/exp_stream.py) on the CPU: its plain path against
the JAX streaming tool's block body (tools/exp_stream.py _compute_block, the
production Pallas kernel body run eagerly with stand-in refs) and both
against the numpy oracle, on one 2048-state tile with the near-p corners in
front; the tool's entry point at a small size.  Tolerance: none — exact
and canonical, bit for bit.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pil2_stark_tpu.hash import poseidon_gl as jposeidon
from pil2_stark_tpu_torch.field import torch_gl
from pil2_stark_tpu_torch.tools import exp_stream

from test_torch_exp_poseidon import CORNERS, P, load_tool, one_thread  # noqa: F401


def test_plain_stream_matches_jax_block_body():
    jst = load_tool("exp_stream")
    states = np.random.default_rng(5).integers(0, P, size=(exp_stream.BLK, 12), dtype=np.uint64)
    states[0] = np.array(CORNERS, dtype=np.uint64)
    states[1] = np.uint64(P - 1)
    planes = states.T.copy()
    x = jnp.concatenate([jnp.asarray((planes & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
                         jnp.asarray((planes >> np.uint64(32)).astype(np.uint32))], axis=0)
    k = jst.pp._const_planes()
    y = np.asarray(jst._compute_block(*(jnp.asarray(a) for a in (
        k["c"][0], k["c"][1], k["wq_m"], k["wq_p"], k["wq_s"])), x))
    want = (y[:12].astype(np.uint64) | (y[12:].astype(np.uint64) << np.uint64(32))).T
    got = torch_gl.to_u64(exp_stream.build_stream(1)(torch_gl.from_u64(planes))).T
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jposeidon.permute(states))
    assert (got < np.uint64(P)).all()


def test_stream_checks_shape():
    with pytest.raises(ValueError):
        exp_stream.permute_stream(torch.zeros((12, 1000), dtype=torch.int64))
    with pytest.raises(ValueError):
        exp_stream.build_stream(2)(torch.zeros((12, exp_stream.BLK), dtype=torch.int64))
    with pytest.raises(ValueError):
        exp_stream.build_stream(0)


def test_main_on_cpu():
    res = exp_stream.main(device="cpu", check_bits=11, bench_bits=(11,))
    assert res["ok"] is True and res["device"] == "cpu"
    assert list(res["ms"]) == [11] and res["ms"][11] > 0


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        exp_stream.main(check_bits=11, bench_bits=())
