"""shplonk (protocol/shplonk.py) in the port against the JAX package's on
the CPU: for a config of two polynomials opened at {xi} and {xi, xi*w},
the setup (zkey), the composed commitments, the opening (W1, W2 and the
evaluations) and the verification are the same Python ints in both
packages, from the same inputs drawn with numpy's default_rng(seed); the
port refuses a changed evaluation (the JAX package's own
tests/test_shplonk.py refuses changed evaluations and commitments on its
side)."""
import numpy as np
import pytest

from pil2_stark_tpu.protocol import shplonk as jshplonk
from pil2_stark_tpu_torch.ops.fft_bn128 import FR
from pil2_stark_tpu_torch.protocol import shplonk
from pil2_stark_tpu_torch.protocol.poly_fr import domain_w, poly_eval

POWER = 3
N = 1 << POWER


def _scalars(n, rng):
    return [int.from_bytes(rng.bytes(32), "little") % FR for _ in range(n)]


def _run(mod, pols, tau, xi_seed):
    """(zkey, ptau, commitments, evaluations) of one package's shplonk."""
    pol_defs = {
        0: [{"name": "a", "stage": 1, "degree": N + 2, "fi": 0},
            {"name": "z", "stage": 2, "degree": N + 2, "fi": 1}],
        1: [{"name": "z", "stage": 2, "degree": N + 2, "fi": 1}],
    }
    ptau = mod.dev_ptau(2 * (N + 2) + 4, tau=tau)
    zkey = mod.shplonk_setup({"power": POWER, "polDefs": pol_defs}, ptau)
    committed = {}
    for stage in (1, 2):
        for ent in mod.shplonk_commit(stage, zkey, pols, ptau):
            committed[ent["index"]] = ent
    cmts, evals = mod.shplonk_open(zkey, ptau, pols, committed, xi_seed)
    return zkey, ptau, committed, cmts, evals


@pytest.fixture(scope="module")
def both():
    rng = np.random.default_rng(5)
    pols = {"a": _scalars(N + 2, rng), "z": _scalars(N + 2, rng)}
    xi_seed = _scalars(1, rng)[0]
    tau = int(rng.integers(2, 1 << 16))  # a power of tau costs a scalar multiplication
    return pols, xi_seed, _run(jshplonk, pols, tau, xi_seed), _run(shplonk, pols, tau, xi_seed)


def test_setup_and_commitments_equal_jax(both):
    _, _, (jzkey, _, jcommitted, _, _), (zkey, _, committed, _, _) = both
    assert zkey == jzkey
    assert sorted(f["openingPoints"] for f in zkey["f"]) == [[0], [0, 1]]
    assert {k: v["commit"] for k, v in committed.items()} == {
        k: v["commit"] for k, v in jcommitted.items()}


def test_opening_equals_jax_and_holds(both):
    pols, xi_seed, (_, _, _, jcmts, jevals), (zkey, _, _, cmts, evals) = both
    assert cmts == jcmts and evals == jevals
    xi = pow(xi_seed, zkey["powerW"], FR)
    assert evals["a"] == poly_eval(pols["a"], xi)
    assert evals["zw"] == poly_eval(pols["z"], xi * domain_w(POWER) % FR)


def test_verify_equals_jax_and_refuses_changes(both):
    _, xi_seed, (jzkey, _, _, _, _), (zkey, _, _, cmts, evals) = both
    assert shplonk.shplonk_verify(zkey, cmts, dict(evals), xi_seed) is True
    assert jshplonk.shplonk_verify(jzkey, cmts, dict(evals), xi_seed) is True
    bad = dict(evals)
    bad["a"] = (bad["a"] + 1) % FR
    bad.pop("inv")
    assert not shplonk.shplonk_verify(zkey, cmts, bad, xi_seed)
