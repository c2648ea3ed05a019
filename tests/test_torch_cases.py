"""Shared cases of the PyTorch port's end-to-end tests: one case of
tests/test_device_prover.py proved by the JAX package (backend="numpy") and
by the port on the CPU, from the same committed setup and columns."""
import copy
import functools

from pil2_stark_tpu.compiler import pil1_parser
from pil2_stark_tpu.models import fibonacci as jfib, gadgets as jgad
from pil2_stark_tpu.stark import prover as jprover, setup as jsetup, witness as jwitness
from pil2_stark_tpu_torch.stark import prover as tprover, setup as tsetup

CASES = {
    "all_8": ("all", 8, jgad.stark_struct(8, 10, n_queries=8)),
    "fibonacci_6": ("fibonacci", 6, jfib.STARK_STRUCT),
    "fibonacci_6_split": ("fibonacci", 6, dict(copy.deepcopy(jfib.STARK_STRUCT), splitLinearHash=True)),
}


def canon(o):
    import numpy as np

    if isinstance(o, np.ndarray):
        return [canon(x) for x in o.tolist()]
    if isinstance(o, (list, tuple)):
        return [canon(x) for x in o]
    if isinstance(o, dict):
        return {k: canon(v) for k, v in o.items()}
    if isinstance(o, (int, np.integer)):
        return int(o)
    return o


@functools.lru_cache(maxsize=None)
def case_inputs(name):
    """(pil, const columns, stage-1 columns, publics) of one case."""
    machine, n_bits, _ = CASES[name]
    n = 1 << n_bits
    if machine == "all":
        pil = pil1_parser.compile_pil_source(jgad.all_source(n_bits))
        pil["name"] = "all"
    else:
        pil = pil1_parser.compile_pil_source(jfib.pil_source(n_bits))
        pil["name"] = "Fibonacci"
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
    return pil, const_cols, cm_cols, [1, 2, out]


def prove_port(name):
    """(port setup, port result) of one case, proved on the CPU."""
    _, const_cols, cm_cols, publics = case_inputs(name)
    data = tsetup.read_setup(name)
    ts = tsetup.load_setup(data["starkInfo"], data["expressionsInfo"], data["verifierInfo"],
                           const_cols.buffer, device="cpu")
    tres = tprover.prove(ts["starkInfo"], ts["expressionsInfo"], const_cols.buffer,
                         ts["constTree"], (cm_cols.buffer, publics), device="cpu")
    return ts, tres


def prove_both(name):
    """Returns (jax setup, jax result, port setup, port result)."""
    pil, const_cols, cm_cols, publics = case_inputs(name)
    js = jsetup.stark_setup(const_cols.buffer, pil, copy.deepcopy(CASES[name][2]))
    jres = jprover.prove(js["starkInfo"], js["expressionsInfo"], const_cols.buffer,
                         js["constTree"], (cm_cols.buffer, publics), backend="numpy")
    return (js, jres) + prove_port(name)


def test_cases_use_the_committed_setups():
    for name, (machine, n_bits, ss) in CASES.items():
        data = tsetup.read_setup(name)
        assert (data["machine"], data["nBits"]) == (machine, n_bits)
        assert data["starkInfo"]["starkStruct"] == json_round_trip(ss)


def json_round_trip(obj):
    import json

    return json.loads(json.dumps(obj))
