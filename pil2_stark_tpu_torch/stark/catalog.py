"""The committed setups (``setups/*.json``) and how each is compiled.

Each file is the output of the PIL compiler for one machine at one size:
``CASES`` holds the STARK setups (machine, nBits, STARK struct),
``DEBUG_CASES`` the machines also compiled for debug mode
(``<name>_debug.json``, pilinfo {"debug": True}), and ``FIBV_FILES`` the
two fibv airs, their debug setups and the global constraints' code, from
the fibv pilout.  ``compile_file(name)`` recompiles one file with the
port's compiler; the result equals ``setup.read_setup(name)``
(tests/test_torch_compiler.py, chip_smoke.py's compile phase).
"""
from __future__ import annotations

import copy
import json

from ..compiler import pil1_parser, pilinfo
from ..compiler import pil2_frontend as pf
from ..models import fibonacci, fibv, gadgets, poseidon_vm

# tests/test_stark_boundaries.py:11-17
BOUNDARY_STRUCT = {
    "nBits": 6,
    "nBitsExt": 9,
    "nQueries": 8,
    "verificationHashType": "GL",
    "steps": [{"nBits": 9}, {"nBits": 6}, {"nBits": 3}],
}

# name -> (machine, nBits, stark struct)
CASES = {
    "all_20": ("all", 20, gadgets.stark_struct(20, 22, n_queries=32)),
    "all_8": ("all", 8, gadgets.stark_struct(8, 10, n_queries=8)),
    "fibonacci_6": ("fibonacci", 6, fibonacci.STARK_STRUCT),
    "fibonacci_6_split": ("fibonacci", 6, dict(copy.deepcopy(fibonacci.STARK_STRUCT),
                                               splitLinearHash=True)),
    "fibonacci_6_hash": ("fibonacci", 6, dict(copy.deepcopy(fibonacci.STARK_STRUCT),
                                              hashCommits=True)),
    # blowup 8: the 2^25-point extended domain of the row-route prove
    "fibonacci_22": ("fibonacci", 22, gadgets.stark_struct(22, 25, n_queries=32)),
    # everyFrame, firstRow and lastRow constraints, no fixed columns
    "boundaries_6": ("boundaries", 6, BOUNDARY_STRUCT),
    # degree 8 (pow7 times a selector) needs blowup 8
    "poseidon_vm_6": ("poseidon_vm", 6, gadgets.stark_struct(6, 9)),
    "poseidon_vm_10": ("poseidon_vm", 10, gadgets.stark_struct(10, 13)),
    "poseidon_vm_20": ("poseidon_vm", 20, gadgets.stark_struct(20, 23, n_queries=32)),
}

DEBUG_CASES = ("boundaries_6", "poseidon_vm_6")

# the two fibv airs: file name -> (subproof id, air name)
FIBV_AIRS = {"fibv_module": (0, "Module"), "fibv_fibonacci": (1, "Fibonacci")}
FIBV_FILES = tuple(FIBV_AIRS) + tuple(f"{name}_debug" for name in FIBV_AIRS) + ("fibv_global",)

FILES = tuple(CASES) + tuple(f"{name}_debug" for name in DEBUG_CASES) + FIBV_FILES


def machine_pil(machine: str, n_bits: int) -> dict:
    """The pilcom-style pil of one machine at 2^n_bits rows."""
    if machine == "boundaries":
        return fibonacci.pil_boundaries(n_bits)
    source, name = {
        "all": (gadgets.all_source, "all"),
        "poseidon_vm": (poseidon_vm.pil_source, "PoseidonVM"),
        "fibonacci": (fibonacci.pil_source, "Fibonacci"),
    }[machine]
    pil = pil1_parser.compile_pil_source(source(n_bits))
    pil["name"] = name
    return pil


def _json(data):
    """The committed form: through json, tuples become lists and int keys
    strings."""
    return json.loads(json.dumps(data))


def compile_case(name: str) -> dict:
    """{"machine", "nBits", "starkInfo", "expressionsInfo", "verifierInfo",
    "references"} of one of CASES."""
    machine, n_bits, ss = CASES[name]
    pil = machine_pil(machine, n_bits)
    info = pilinfo.pil_info(pil, True, copy.deepcopy(ss), {})
    return _json({"machine": machine, "nBits": n_bits, "starkInfo": info["pilInfo"],
                  "expressionsInfo": info["expressionsInfo"],
                  "verifierInfo": info["verifierInfo"], "references": pil["references"]})


def compile_debug_case(name: str) -> dict:
    """The debug setup (constraint code, no extended domain) of one of
    DEBUG_CASES: {"machine", "nBits", "starkInfo", "expressionsInfo"}."""
    machine, n_bits, _ = CASES[name]
    info = pilinfo.pil_info(machine_pil(machine, n_bits), True, {}, {"debug": True})
    return _json({"machine": machine, "nBits": n_bits, "starkInfo": info["pilInfo"],
                  "expressionsInfo": info["expressionsInfo"]})


def fibv_pilout() -> dict:
    """The fibv pilout, through the wire format."""
    return pf.decode_pilout(pf.encode_pilout(fibv.build_pilout()))


def compile_fibv(name: str) -> dict:
    """One of FIBV_FILES: an air's setup with its fixed columns, its debug
    setup, or the global constraints' code."""
    pilout = fibv_pilout()
    if name == "fibv_global":
        return _json({"constraints": pf.get_global_constraints_info(pilout, stark=True)})
    debug = name.endswith("_debug")
    sub_id, air = FIBV_AIRS[name[: -len("_debug")] if debug else name]
    pil = pf.select_air(pilout, sub_id, 0)
    head = {"machine": "fibv", "air": air, "subproofId": sub_id, "nBits": fibv.N_BITS}
    if debug:
        info = pilinfo.pil_info(pil, True, {}, {"debug": True}, pil2=True)
        return _json(dict(head, starkInfo=info["pilInfo"],
                          expressionsInfo=info["expressionsInfo"]))
    info = pilinfo.pil_info(pil, True, copy.deepcopy(fibv.STARK_STRUCT), pil2=True)
    fixed = pf.fixed_cols_array(pil)
    return _json(dict(head, starkInfo=info["pilInfo"], expressionsInfo=info["expressionsInfo"],
                      verifierInfo=info["verifierInfo"],
                      fixedPols=[[int(v) for v in row] for row in fixed]))


def compile_file(name: str) -> dict:
    """setups/<name>.json, compiled afresh by the port's compiler."""
    if name in CASES:
        return compile_case(name)
    if name.endswith("_debug") and name[: -len("_debug")] in DEBUG_CASES:
        return compile_debug_case(name[: -len("_debug")])
    if name in FIBV_FILES:
        return compile_fibv(name)
    raise KeyError(f"no committed setup {name!r}")
