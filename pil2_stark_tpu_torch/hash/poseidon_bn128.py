"""Poseidon over BN254 — the recursion tier's hash (circomlib parameters).

Host copy of pil2_stark_tpu/hash/poseidon_bn128.py, on python ints (the
BN128 tier runs at recursion sizes).  x^5 S-box, 8 full rounds, partial
rounds per width t = nInputs + 1 <= 17; the round constants and MDS
matrices are poseidon_bn128_constants.json, a copy of the JAX package's
(circomlib's Grain-LFSR tables; poseidon([1, 2]) is circomlib's vector).
The merkleTreeCustom flag changes only the sponge's padding, not the
constants.  Semantics of circomlibjs buildPoseidon as pil2-stark-js
merklehash_bn128_p.js and transcript.bn128.js use it:
poseidon(inputs, initState, nOut).
"""
from __future__ import annotations

import functools
import json
import operator
import os

P = 21888242871839275222246405745257275088548364400416034343698204186575808495617
N_ROUNDS_F = 8
N_ROUNDS_P = [56, 57, 56, 60, 60, 63, 64, 63, 60, 66, 60, 65, 70, 60, 64, 68]

_DATA = os.path.join(os.path.dirname(__file__), "poseidon_bn128_constants.json")


@functools.lru_cache(maxsize=None)
def _constants(t: int):
    with open(_DATA) as f:
        data = json.load(f)
    entry = data[str(t)]
    c = [int(v) for v in entry["C"]]
    m = [[int(v) for v in row] for row in entry["M"]]
    return c, m, N_ROUNDS_P[t - 2]


def _pow5(a: int) -> int:
    a2 = a * a % P
    a4 = a2 * a2 % P
    return a4 * a % P


def poseidon(inputs, init_state: int = 0, n_out: int = 1, custom: bool = False):
    """poseidon(inputs[t-1], capacity) -> state[0] (or the first n_out)."""
    t = len(inputs) + 1
    if not 2 <= t <= 17:
        raise ValueError(f"Invalid poseidon width t={t}")
    c, m, rp = _constants(t)
    state = [int(init_state) % P] + [int(x) % P for x in inputs]
    half = N_ROUNDS_F // 2
    for r in range(N_ROUNDS_F + rp):
        state = [(s + c[r * t + i]) % P for i, s in enumerate(state)]
        if r < half or r >= half + rp:
            state = [_pow5(s) for s in state]
        else:
            state[0] = _pow5(state[0])
        state = [sum(map(operator.mul, row, state)) % P for row in m]
    if n_out == 1:
        return state[0]
    return state[:n_out]
