"""The committed setups of the PyTorch port equal a fresh compile by the
JAX package's PIL compiler, the port's const tree has the JAX constRoot,
and the port's witness generators equal the JAX ones.

Regenerate the committed setups with:  python tests/test_torch_setups.py
"""
import copy
import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pil2_stark_tpu.compiler import pil1_parser  # noqa: E402
from pil2_stark_tpu.models import fibonacci as jfib, gadgets as jgad  # noqa: E402
from pil2_stark_tpu.stark import setup as jsetup, witness as jwitness  # noqa: E402
from pil2_stark_tpu_torch.models import fibonacci as tfib, gadgets as tgad  # noqa: E402
from pil2_stark_tpu_torch.stark import setup as tsetup  # noqa: E402

# name -> (machine, nBits, stark struct)
CASES = {
    "all_20": ("all", 20, jgad.stark_struct(20, 22, n_queries=32)),
    "all_8": ("all", 8, jgad.stark_struct(8, 10, n_queries=8)),
    "fibonacci_6": ("fibonacci", 6, jfib.STARK_STRUCT),
    "fibonacci_6_split": ("fibonacci", 6, dict(copy.deepcopy(jfib.STARK_STRUCT), splitLinearHash=True)),
    # blowup 8: the 2^25-point extended domain of the row-route prove
    "fibonacci_22": ("fibonacci", 22, jgad.stark_struct(22, 25, n_queries=32)),
}


def compile_case(name):
    """The JAX compiler's setup for one case, as the committed JSON holds it."""
    machine, n_bits, ss = CASES[name]
    if machine == "all":
        pil = pil1_parser.compile_pil_source(jgad.all_source(n_bits))
        pil["name"] = "all"
    else:
        pil = pil1_parser.compile_pil_source(jfib.pil_source(n_bits))
        pil["name"] = "Fibonacci"
    s = jsetup.stark_setup(None, pil, copy.deepcopy(ss), options={"skipConstTree": True})
    out = {
        "machine": machine,
        "nBits": n_bits,
        "starkInfo": s["starkInfo"],
        "expressionsInfo": s["expressionsInfo"],
        "verifierInfo": s["verifierInfo"],
        "references": pil["references"],
    }
    return json.loads(json.dumps(out)), pil


def regenerate():
    for name in CASES:
        data, _ = compile_case(name)
        path = tsetup.SETUPS_DIR / f"{name}.json"
        with open(path, "w") as f:
            json.dump(data, f, separators=(",", ":"), sort_keys=True)
        print(path, path.stat().st_size)


def jax_columns(machine, pil, n):
    const_cols = jwitness.generate_fixed_cols(pil["references"], n)
    cm_cols = jwitness.generate_wtns_cols(pil["references"], n)
    if machine == "all":
        jgad.build_global_constants(n, const_cols.Global)
        jgad.build_plookup_constants(n, const_cols.Plookup)
        jgad.execute_plookup(n, cm_cols.Plookup)
        jgad.execute_permutation(n, cm_cols.Permutation)
        jgad.build_connection_constants(n, const_cols.Connection)
        jgad.execute_connection(n, cm_cols.Connection)
    jfib.build_constants(n, const_cols.Fibonacci)
    out = jfib.execute(n, cm_cols.Fibonacci, [1, 2])
    return const_cols, cm_cols, [1, 2, out]


@pytest.mark.parametrize("name", sorted(CASES))
def test_committed_setup_matches_fresh_compile(name):
    fresh, _ = compile_case(name)
    assert tsetup.read_setup(name) == fresh


@pytest.mark.parametrize("machine", ["all", "fibonacci"])
def test_witness_generators_match_jax(machine):
    n_bits = 8
    n = 1 << n_bits
    name = "all_8" if machine == "all" else "fibonacci_6"
    setup = tsetup.read_setup(name)
    if machine == "all":
        pil = pil1_parser.compile_pil_source(jgad.all_source(n_bits))
        t_const, t_cm, t_pub = tgad.build_all(pil["references"], n)
    else:
        pil = pil1_parser.compile_pil_source(jfib.pil_source(n_bits))
        t_const, t_cm, t_pub = tfib.build(pil["references"], n)
    assert setup["machine"] == machine
    j_const, j_cm, j_pub = jax_columns(machine, pil, n)
    np.testing.assert_array_equal(t_const.buffer, j_const.buffer)
    np.testing.assert_array_equal(t_cm.buffer, j_cm.buffer)
    assert [int(x) for x in t_pub] == [int(x) for x in j_pub]


@pytest.mark.parametrize("name", ["all_8", "fibonacci_6_split"])
def test_load_setup_const_root_matches_jax(name):
    data = tsetup.read_setup(name)
    machine, n_bits, ss = CASES[name]
    n = 1 << n_bits
    _, pil = compile_case(name)
    j_const, _, _ = jax_columns(machine, pil, n)
    ref = jsetup.stark_setup(j_const.buffer, pil, copy.deepcopy(ss))
    s = tsetup.load_setup(data["starkInfo"], data["expressionsInfo"], data["verifierInfo"],
                          j_const.buffer, device="cpu")
    np.testing.assert_array_equal(s["constRoot"], ref["constRoot"])


if __name__ == "__main__":
    regenerate()
