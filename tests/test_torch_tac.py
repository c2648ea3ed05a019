"""PyTorch port's TAC executor (ops/torch_tac.py) against the JAX package's
planar jax_tac executor, on the imPol, Q and FRI programs of the all-gadgets
machine at 2^8, with the same random sections, scalars and domain tables.
Tolerance: none — exact, bit for bit.

The JAX executor runs its own body (make_executor's trace of the program)
eagerly, each GL op jitted on its own (the ``jax_executor`` fixture, which
tests/test_torch_tac_codegen.py shares): under one jit the program takes
about a minute to compile on the CPU, op by op under disable_jit about
25 s for the three programs."""
import types

import jax
import numpy as np
import pytest

from pil2_stark_tpu.field import jax_f3, jax_gl
from pil2_stark_tpu.ops import jax_tac
from pil2_stark_tpu_torch.field import torch_gl
from pil2_stark_tpu_torch.ops import torch_tac
from pil2_stark_tpu_torch.stark import setup as tsetup

P = 0xFFFFFFFF00000001


@pytest.fixture(scope="module")
def jax_executor():
    """make_executor with its body run eagerly and each GL op jitted on its
    own; the executors made through it are dropped again afterwards."""
    cached = set(jax_tac._EXECUTOR_CACHE)
    gl_ops = types.SimpleNamespace(**{k: jax.jit(getattr(jax_gl, k))
                                      for k in ("add", "sub", "mul", "neg")})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_tac, "jax", types.SimpleNamespace(jit=lambda f, **_: f))
        mp.setattr(jax_f3, "gl", gl_ops)
        yield jax_tac.make_executor
    for key in set(jax_tac._EXECUTOR_CACHE) - cached:
        del jax_tac._EXECUTOR_CACHE[key]


@pytest.mark.parametrize("which", ["imPols", "q", "fri"])
def test_tac_program_matches_jax(jax_executor, which):
    setup = tsetup.read_setup("all_8")
    info = setup["starkInfo"]
    ss = info["starkStruct"]
    code, dom = torch_tac.device_program(info, setup["expressionsInfo"], which)
    assert code["code"], which
    n_bits, ext_bits = ss["nBits"], ss["nBitsExt"]
    n = 1 << (ext_bits if dom == "ext" else n_bits)
    rng = np.random.default_rng({"imPols": 1, "q": 2, "fri": 3}[which])

    def rand(*shape):
        return rng.integers(0, P, size=shape, dtype=np.uint64)

    n_sections = info["nStages"] + (1 if dom == "ext" else 0)
    sections = {"const": rand(info["nConstants"], n)}
    for i in range(n_sections):
        sections[f"cm{i + 1}"] = rand(info["mapSectionsN"][f"cm{i + 1}"], n)
    x = rand(n)
    zi = rand(len(info["boundaries"]), 1 << ext_bits)
    n_open = len(info["openingPoints"])
    xdiv = rand(n_open, 3, 1 << ext_bits)
    publics = rand(info["nPublics"])
    challenges = rand(len(info["challengesMap"]), 3)
    evals = rand(len(info["evMap"]), 3)

    j_inputs = {
        "sections": {k: jax_gl.from_u64(v) for k, v in sections.items()},
        "x": jax_gl.from_u64(x),
        "smalls": jax_gl.from_u64(np.concatenate(
            [publics, challenges.reshape(-1), evals.reshape(-1)])),
        "sizes": (len(publics), len(challenges)),
        "Zi": jax_gl.from_u64(zi),
        "xDivXSubXi": jax_gl.from_u64(np.ascontiguousarray(xdiv.transpose(2, 0, 1))),
    }
    t_inputs = {
        "sections": {k: torch_gl.from_u64(v) for k, v in sections.items()},
        "x": torch_gl.from_u64(x),
        "publics": torch_gl.from_u64(publics),
        "challenges": torch_gl.from_u64(challenges),
        "evals": torch_gl.from_u64(evals),
        "Zi": torch_gl.from_u64(zi),
        "xDivXSubXi": torch_gl.from_u64(xdiv),
    }
    want = jax_executor(code, dom, info, n_bits, ext_bits, planar=True)(j_inputs)
    got = torch_tac.make_executor(code, dom, info, n_bits, ext_bits)(t_inputs)
    for key in ("q", "f"):
        assert (key in got) == (key in want)
        if key in got:
            np.testing.assert_array_equal(torch_gl.to_u64(got[key]), jax_gl.to_u64(want[key]))
    assert sorted(got["cm"]) == sorted(want["cm"])
    for key, val in got["cm"].items():
        np.testing.assert_array_equal(torch_gl.to_u64(val), jax_gl.to_u64(want["cm"][key]))
