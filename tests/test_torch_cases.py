"""Shared cases of the PyTorch port's end-to-end tests: one case of
tests/test_device_prover.py proved by the JAX package (backend="numpy") and
by the port on the CPU, from the same committed setup and columns."""
import copy

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


def prove_both(name):
    """Returns (jax setup, jax result, port setup, port result)."""
    machine, n_bits, ss = CASES[name]
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
    publics = [1, 2, out]

    js = jsetup.stark_setup(const_cols.buffer, pil, copy.deepcopy(ss))
    jres = jprover.prove(js["starkInfo"], js["expressionsInfo"], const_cols.buffer,
                         js["constTree"], (cm_cols.buffer, publics), backend="numpy")
    data = tsetup.read_setup(name)
    ts = tsetup.load_setup(data["starkInfo"], data["expressionsInfo"], data["verifierInfo"],
                           const_cols.buffer, device="cpu")
    tres = tprover.prove(ts["starkInfo"], ts["expressionsInfo"], const_cols.buffer,
                         ts["constTree"], (cm_cols.buffer, publics), device="cpu")
    return js, jres, ts, tres


def test_cases_use_the_committed_setups():
    for name, (machine, n_bits, ss) in CASES.items():
        data = tsetup.read_setup(name)
        assert (data["machine"], data["nBits"]) == (machine, n_bits)
        assert data["starkInfo"]["starkStruct"] == json_round_trip(ss)


def json_round_trip(obj):
    import json

    return json.loads(json.dumps(obj))
