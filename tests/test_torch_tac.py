"""PyTorch port's TAC executor (ops/torch_tac.py) against the JAX package's
planar jax_tac executor, on the imPol, Q and FRI programs of the all-gadgets
machine at 2^8, with the same random sections, scalars and domain tables.
Tolerance: none — exact, bit for bit."""
import jax
import numpy as np
import pytest

from pil2_stark_tpu.field import jax_gl
from pil2_stark_tpu.ops import jax_tac
from pil2_stark_tpu_torch.field import torch_gl
from pil2_stark_tpu_torch.ops import torch_tac
from pil2_stark_tpu_torch.stark import setup as tsetup

P = 0xFFFFFFFF00000001


@pytest.mark.parametrize("which", ["imPols", "q", "fri"])
def test_tac_program_matches_jax(which):
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
    # op by op: compiling the whole program as one XLA computation costs
    # about a minute on the CPU, evaluating it eagerly a few seconds
    with jax.disable_jit():
        want = jax_tac.make_executor(code, dom, info, n_bits, ext_bits, planar=True)(j_inputs)
    got = torch_tac.make_executor(code, dom, info, n_bits, ext_bits)(t_inputs)
    for key in ("q", "f"):
        assert (key in got) == (key in want)
        if key in got:
            np.testing.assert_array_equal(torch_gl.to_u64(got[key]), jax_gl.to_u64(want[key]))
    assert sorted(got["cm"]) == sorted(want["cm"])
    for key, val in got["cm"].items():
        np.testing.assert_array_equal(torch_gl.to_u64(val), jax_gl.to_u64(want["cm"][key]))
