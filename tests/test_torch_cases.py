"""Shared cases of the PyTorch port's end-to-end tests: one case of
tests/test_device_prover.py, tests/test_stark_boundaries.py or
tests/test_poseidon_vm.py proved by the JAX package (backend="numpy") and
by the port on the CPU, from the same committed setup and columns."""
import copy
import functools

from pil2_stark_tpu.models import fibonacci as jfib, gadgets as jgad
from pil2_stark_tpu.stark import prover as jprover, setup as jsetup
from pil2_stark_tpu_torch.stark import prover as tprover, setup as tsetup

from test_torch_setups import BOUNDARY_STRUCT, jax_columns, machine_pil

CASES = {
    "all_8": ("all", 8, jgad.stark_struct(8, 10, n_queries=8)),
    "fibonacci_6": ("fibonacci", 6, jfib.STARK_STRUCT),
    "fibonacci_6_split": ("fibonacci", 6, dict(copy.deepcopy(jfib.STARK_STRUCT), splitLinearHash=True)),
    "fibonacci_6_hash": ("fibonacci", 6, dict(copy.deepcopy(jfib.STARK_STRUCT), hashCommits=True)),
    "boundaries_6": ("boundaries", 6, BOUNDARY_STRUCT),
    "poseidon_vm_6": ("poseidon_vm", 6, jgad.stark_struct(6, 9)),
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
    pil = machine_pil(machine, n_bits)
    return (pil,) + jax_columns(machine, pil, 1 << n_bits)


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
