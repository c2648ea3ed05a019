"""The committed setups of the PyTorch port equal a fresh compile by the
JAX package's PIL compiler, the port's const tree has the JAX constRoot,
and the port's witness generators equal the JAX ones.

Regenerate the committed setups with:  python tests/test_torch_setups.py
"""
import copy
import json
import os
import sys
import tempfile

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pil2_stark_tpu.compiler import pil1_parser, pilinfo  # noqa: E402
from pil2_stark_tpu.compiler import pil2_frontend as pf  # noqa: E402
from pil2_stark_tpu.models import fibonacci as jfib, fibv as jfibv  # noqa: E402
from pil2_stark_tpu.models import gadgets as jgad, poseidon_vm as jvm  # noqa: E402
from pil2_stark_tpu.stark import setup as jsetup, witness as jwitness  # noqa: E402
from pil2_stark_tpu_torch.models import fibonacci as tfib, fibv as tfibv  # noqa: E402
from pil2_stark_tpu_torch.models import gadgets as tgad, poseidon_vm as tvm  # noqa: E402
from pil2_stark_tpu_torch.stark import setup as tsetup  # noqa: E402

P = 0xFFFFFFFF00000001

# the STARK struct of tests/test_stark_boundaries.py:11-17
BOUNDARY_STRUCT = {
    "nBits": 6,
    "nBitsExt": 9,
    "nQueries": 8,
    "verificationHashType": "GL",
    "steps": [{"nBits": 9}, {"nBits": 6}, {"nBits": 3}],
}

# name -> (machine, nBits, stark struct)
CASES = {
    "all_20": ("all", 20, jgad.stark_struct(20, 22, n_queries=32)),
    "all_8": ("all", 8, jgad.stark_struct(8, 10, n_queries=8)),
    "fibonacci_6": ("fibonacci", 6, jfib.STARK_STRUCT),
    "fibonacci_6_split": ("fibonacci", 6, dict(copy.deepcopy(jfib.STARK_STRUCT), splitLinearHash=True)),
    "fibonacci_6_hash": ("fibonacci", 6, dict(copy.deepcopy(jfib.STARK_STRUCT), hashCommits=True)),
    # blowup 8: the 2^25-point extended domain of the row-route prove
    "fibonacci_22": ("fibonacci", 22, jgad.stark_struct(22, 25, n_queries=32)),
    # everyFrame, firstRow and lastRow constraints, no fixed columns
    "boundaries_6": ("boundaries", 6, BOUNDARY_STRUCT),
    # degree 8 (pow7 times a selector) needs blowup 8
    "poseidon_vm_6": ("poseidon_vm", 6, jgad.stark_struct(6, 9)),
    "poseidon_vm_10": ("poseidon_vm", 10, jgad.stark_struct(10, 13)),  # card tests
    "poseidon_vm_20": ("poseidon_vm", 20, jgad.stark_struct(20, 23, n_queries=32)),
}

# the cases checked in debug mode: pilinfo with {"debug": True}, committed
# as setups/<name>_debug.json
DEBUG_CASES = ("boundaries_6", "poseidon_vm_6")

# the two fibv airs (subproof id, air name) and the global constraints
FIBV_AIRS = {"fibv_module": (0, "Module"), "fibv_fibonacci": (1, "Fibonacci")}
FIBV_FILES = tuple(FIBV_AIRS) + tuple(f"{name}_debug" for name in FIBV_AIRS) + ("fibv_global",)


def machine_pil(machine, n_bits):
    """The JAX front end's pil of one machine."""
    if machine == "all":
        pil = pil1_parser.compile_pil_source(jgad.all_source(n_bits))
        pil["name"] = "all"
    elif machine == "boundaries":
        pil = jfib.pil_boundaries(n_bits)
    elif machine == "poseidon_vm":
        pil = pil1_parser.compile_pil_source(jvm.pil_source(n_bits))
        pil["name"] = "PoseidonVM"
    else:
        pil = pil1_parser.compile_pil_source(jfib.pil_source(n_bits))
        pil["name"] = "Fibonacci"
    return pil


def compile_case(name):
    """The JAX compiler's setup for one case, as the committed JSON holds it."""
    machine, n_bits, ss = CASES[name]
    pil = machine_pil(machine, n_bits)
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


def compile_debug_case(name):
    """The JAX compiler's debug setup (constraint code, no extended domain)
    of one case: {"machine", "nBits", "starkInfo", "expressionsInfo"}."""
    machine, n_bits, _ = CASES[name]
    info = pilinfo.pil_info(machine_pil(machine, n_bits), True, {}, {"debug": True})
    out = {"machine": machine, "nBits": n_bits, "starkInfo": info["pilInfo"],
           "expressionsInfo": info["expressionsInfo"]}
    return json.loads(json.dumps(out))


def fibv_pilout():
    """The fibv pilout, through the wire format as tests/test_vadcop.py
    reads it."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "fibv.pilout")
        with open(path, "wb") as f:
            f.write(pf.encode_pilout(jfibv.build_pilout()))
        return pf.load_pilout(path)


def compile_fibv():
    """{file name: JSON} of the fibv airs' setups (with their fixed
    columns), their debug setups and the global constraints' code."""
    pilout = fibv_pilout()
    out = {}
    for name, (sub_id, air) in FIBV_AIRS.items():
        pil = pf.select_air(pilout, sub_id, 0)
        info = pilinfo.pil_info(pil, True, copy.deepcopy(jfibv.STARK_STRUCT), pil2=True)
        fixed = pf.fixed_cols_array(pil)
        out[name] = {"machine": "fibv", "air": air, "subproofId": sub_id,
                     "nBits": jfibv.N_BITS, "starkInfo": info["pilInfo"],
                     "expressionsInfo": info["expressionsInfo"],
                     "verifierInfo": info["verifierInfo"],
                     "fixedPols": [[int(v) for v in row] for row in fixed]}
        dinfo = pilinfo.pil_info(pil, True, {}, {"debug": True}, pil2=True)
        out[f"{name}_debug"] = {"machine": "fibv", "air": air, "subproofId": sub_id,
                                "nBits": jfibv.N_BITS, "starkInfo": dinfo["pilInfo"],
                                "expressionsInfo": dinfo["expressionsInfo"]}
    out["fibv_global"] = {"constraints": pf.get_global_constraints_info(pilout, stark=True)}
    return json.loads(json.dumps(out))


def _write(name, data):
    path = tsetup.SETUPS_DIR / f"{name}.json"
    with open(path, "w") as f:
        json.dump(data, f, separators=(",", ":"), sort_keys=True)
    print(path, path.stat().st_size)


def regenerate():
    for name in CASES:
        _write(name, compile_case(name)[0])
    for name in DEBUG_CASES:
        _write(f"{name}_debug", compile_debug_case(name))
    for name, data in compile_fibv().items():
        _write(name, data)


def vm_inputs(n, seed=3):
    """The (n // 32, 12) input states of tests/test_poseidon_vm.py."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, P, size=(n // 32, 12), dtype=np.uint64)


def jax_columns(machine, pil, n):
    const_cols = jwitness.generate_fixed_cols(pil["references"], n)
    cm_cols = jwitness.generate_wtns_cols(pil["references"], n)
    if machine == "poseidon_vm":
        jvm.build_globals(n, const_cols.Global)
        jvm.build_constants(n, const_cols.PoseidonVM)
        jvm.execute(n, cm_cols.PoseidonVM, vm_inputs(n))
        return const_cols, cm_cols, []
    if machine == "all":
        jgad.build_global_constants(n, const_cols.Global)
        jgad.build_plookup_constants(n, const_cols.Plookup)
        jgad.execute_plookup(n, cm_cols.Plookup)
        jgad.execute_permutation(n, cm_cols.Permutation)
        jgad.build_connection_constants(n, const_cols.Connection)
        jgad.execute_connection(n, cm_cols.Connection)
    if machine != "boundaries":
        jfib.build_constants(n, const_cols.Fibonacci)
    out = jfib.execute(n, cm_cols.Fibonacci, [1, 2])
    return const_cols, cm_cols, [1, 2, out]


@pytest.mark.parametrize("name", sorted(CASES))
def test_committed_setup_matches_fresh_compile(name):
    fresh, _ = compile_case(name)
    assert tsetup.read_setup(name) == fresh


@pytest.mark.parametrize("name", DEBUG_CASES)
def test_committed_debug_setup_matches_fresh_compile(name):
    assert tsetup.read_setup(f"{name}_debug") == compile_debug_case(name)


def test_committed_fibv_setups_match_fresh_compile():
    fresh = compile_fibv()
    assert sorted(fresh) == sorted(FIBV_FILES)
    for name, data in fresh.items():
        assert tsetup.read_setup(name) == data, name


@pytest.mark.parametrize("machine", ["all", "fibonacci", "boundaries", "poseidon_vm"])
def test_witness_generators_match_jax(machine):
    n_bits = 8 if machine in ("all", "fibonacci") else 6
    n = 1 << n_bits
    name = {"all": "all_8", "fibonacci": "fibonacci_6", "boundaries": "boundaries_6",
            "poseidon_vm": "poseidon_vm_6"}[machine]
    setup = tsetup.read_setup(name)
    pil = machine_pil(machine, n_bits)
    if machine == "all":
        t_const, t_cm, t_pub = tgad.build_all(pil["references"], n)
    elif machine == "poseidon_vm":
        t_const, t_cm, t_pub = tvm.build(pil["references"], n, vm_inputs(n))
    else:
        t_const, t_cm, t_pub = tfib.build(pil["references"], n)
    assert setup["machine"] == machine
    j_const, j_cm, j_pub = jax_columns(machine, pil, n)
    np.testing.assert_array_equal(t_const.buffer, j_const.buffer)
    np.testing.assert_array_equal(t_cm.buffer, j_cm.buffer)
    assert [int(x) for x in t_pub] == [int(x) for x in j_pub]


def test_vm_final_states_are_the_permutation():
    from pil2_stark_tpu_torch.hash import poseidon_gl as tpg

    n = 1 << 6
    inputs = vm_inputs(n)
    _, t_cm, _ = tvm.build(machine_pil("poseidon_vm", 6)["references"], n, inputs)
    np.testing.assert_array_equal(tvm.final_states(t_cm.buffer), tpg.permute(inputs))


def test_fibv_witness_matches_jax():
    for args in ((101, 1, 2), (7, 3, 5)):
        t_mod, t_fib, t_pub = tfibv.execute(*args)
        j_mod, j_fib, j_pub = jfibv.execute(*args)
        np.testing.assert_array_equal(t_mod, j_mod)
        np.testing.assert_array_equal(t_fib, j_fib)
        assert t_pub == j_pub


@pytest.mark.parametrize("name", ["all_8", "fibonacci_6_split", "boundaries_6", "poseidon_vm_6"])
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
