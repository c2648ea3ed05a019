"""PyTorch port's Poseidon experiment variants (plain version of kernel X2,
pil2_stark_tpu_torch/tools/exp_poseidon.py) against the JAX experiment's
kernel body.

tools/exp_poseidon.py's ``make_kernel`` body is a plain function of refs:
it runs here eagerly, outside ``pallas_call``, with jnp arrays standing in
for its input refs and an object catching its output (the Pallas Poseidon's
interpret mode hangs on the CPU, and under ``jax.jit`` the body takes
minutes to compile).  Each of the ten variants the card sweeps goes
through both on the same numpy-seeded 256 states, the near-p corners in
front.  Tolerance: none — exact and canonical, bit for bit.  torch runs on
one thread: these shapes are small and the test workers share the cores.
"""
import importlib.util
import pathlib
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pil2_stark_tpu.hash import poseidon_gl as jposeidon
from pil2_stark_tpu_torch.field import torch_gl
from pil2_stark_tpu_torch.tools import exp_poseidon

REPO = pathlib.Path(__file__).resolve().parent.parent
P = 0xFFFFFFFF00000001
VARIANTS = ["packed", "packed-nosq", "packed-lazy", "packed-dual", "packed-lazy-dual",
            "packed-p4x", "packed-psl", "nomxu", "packed-nops", "packed-nofs"]
PROBES = {"nomxu", "packed-nops", "packed-nofs"}
CORNERS = [0, 1, 2, P - 1, P - 2, (1 << 32) - 1, 1 << 32, (1 << 32) + 1,
           (1 << 63) - 1, 1 << 63, P - (1 << 32), P - (1 << 32) - 1]
BLOCK = 256


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load_tool(name: str):
    """tools/<name>.py of the JAX package, loaded from its file (it imports
    __graft_entry__ from the repository root)."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jexp():
    return load_tool("exp_poseidon")


@pytest.fixture(scope="module")
def states():
    s = np.random.default_rng(3).integers(0, P, size=(BLOCK, 12), dtype=np.uint64)
    s[0] = np.array(CORNERS, dtype=np.uint64)
    s[1] = np.uint64(P - 1)
    s[2] = np.arange(12, dtype=np.uint64)
    s[3, 0] = _first_round_overflow()
    return s


def _first_round_overflow() -> int:
    """An element 0 whose first full round ends in a sum in [p, 2^64):
    x^7 is a bijection of the field, so pick the S-box output y with
    y + C[12] = p + 5 and solve back through x^7 and the initial add.
    pallas_poseidon._add leaves that sum as it is; a canonical add would
    not, and a nomxu flip shows the difference."""
    c = [int(v) for v in jposeidon.C]
    y = (P - c[12] + 5) % P
    return (pow(y, pow(7, -1, P - 1), P) - c[0]) % P


class _Out:
    def __setitem__(self, idx, value):
        self.value = value


def jax_body(jexp, variant: str, states: np.ndarray) -> np.ndarray:
    """make_kernel's body for `variant` (flags as build() parses them,
    tools/exp_poseidon.py:432-445), run eagerly on (B, 12) states."""
    lazy = "lazy" in variant
    if "nosq" in variant:
        pow7_fn = lambda lo, hi: jexp.pp._pow7(lo, hi)  # noqa: E731
    elif lazy:
        pow7_fn = jexp._pow7_lazy
    else:
        pow7_fn = jexp._pow7_sq
    kern = jexp.make_kernel(
        states.shape[0], pow7_fn, "p4x" in variant, "none" if "nomxu" in variant else "packed",
        skip_psbox="nops" in variant, skip_fsbox="nofs" in variant, lazy=lazy,
        pslice="psl" in variant, dual="dual" in variant)
    k = jexp._const_packed()
    planes = states.T.copy()
    lo = jnp.asarray((planes & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    hi = jnp.asarray((planes >> np.uint64(32)).astype(np.uint32))
    out_lo, out_hi = _Out(), _Out()
    kern(*(jnp.asarray(a) for a in (k["c"][0], k["c"][1], k["wq_m"], k["wq_p"], k["wq_s"])),
         lo, hi, out_lo, out_hi)
    got = (np.asarray(out_lo.value).astype(np.uint64)
           | (np.asarray(out_hi.value).astype(np.uint64) << np.uint64(32)))
    return got.T


@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_variant_matches_jax_body(jexp, states, variant):
    want = jax_body(jexp, variant, states)
    got = exp_poseidon.permute_variant_plain(torch_gl.from_u64(states.T.copy()), variant)
    got = torch_gl.to_u64(got).T
    np.testing.assert_array_equal(got, want)
    oracle = jposeidon.permute(states)
    if variant in PROBES:
        assert not np.array_equal(got, oracle)  # a probe drops part of the work
    else:
        np.testing.assert_array_equal(got, oracle)
        assert (got < np.uint64(P)).all()


def test_parse_refuses_lazy_probes_and_probe_pairs():
    for bad in ("packed-lazy-nops", "lazy-nomxu", "packed-lazy-dual-nofs", "nomxu-nops"):
        with pytest.raises(ValueError):
            exp_poseidon.parse(bad)
        with pytest.raises(ValueError):
            exp_poseidon.build(bad, 1, BLOCK)
    v = exp_poseidon.parse("packed-lazy-dual")
    assert (v.sq, v.lazy, v.dual, v.probe) == (True, True, True, None)
    assert exp_poseidon.parse("packed-nosq-p4x") == exp_poseidon.Variant(False, False, False, None)


def test_build_checks_shape_and_block():
    x = torch.zeros((12, 2 * BLOCK), dtype=torch.int64)
    with pytest.raises(ValueError):
        exp_poseidon.build("packed", 3, BLOCK)(x)
    with pytest.raises(ValueError):
        exp_poseidon.permute_variant(x, "packed-dual", 3)
    assert torch.equal(exp_poseidon.build("packed", 2, BLOCK)(x),
                       exp_poseidon.permute_variant_plain(x, "packed"))


@pytest.mark.parametrize("variant,block", [("packed-dual", 128), ("nomxu", 256)])
def test_run_variant_on_cpu(variant, block):
    res = exp_poseidon.run_variant(variant, block=block, batch=256, device="cpu")
    assert res["ok"] is True and res["device"] == "cpu" and res["ms"] > 0
    assert res["launches"] == 0  # the plain version launches nothing


def test_main_and_sustained_on_cpu():
    res = exp_poseidon.main(["packed-nosq:128", "packed-lazy:256"], batch=256, device="cpu")
    assert [(r["variant"], r["block"], r["ok"]) for r in res] == [
        ("packed-nosq", 128, True), ("packed-lazy", 256, True)]
    assert exp_poseidon.run_sustained("packed", block=256, batch=256, device="cpu")["ms"] > 0


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        exp_poseidon.run_variant("packed", batch=256, block=256)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        exp_poseidon.main(["packed"], batch=256)
