"""Poseidon permutation over Goldilocks — numpy batch oracle.

Parameters: t=12 (8-element rate + 4-element capacity), 8 full rounds,
22 partial rounds, S-box x^7, Neptune-style optimized constant schedule
(C/S/M/P tables).  Semantics mirror the reference implementation at
pil2-stark-js src/helpers/hash/poseidon/poseidon.js:57-108; the constant
tables are loaded from ``poseidon_gl_constants.npz`` (extracted protocol data,
see tools/extract_poseidon_constants.py).

This is the host-side oracle: the production path is the batched CUDA
kernel behind ``cuda_poseidon.permute``, tested against this module and
against the reference's hard-coded digest vectors (test/poseidon.test.js).
``permute_int`` is the single-state form on python ints that the transcript
and the verifier's Merkle paths use (one state at a time, where numpy's
per-call overhead would dominate).

All arrays are canonical uint64.  The batch convention is state shape (B, 12).
"""
from __future__ import annotations

import os

import numpy as np

from ..field import gl64

T = 12
N_ROUNDS_F = 8
N_ROUNDS_P = 22

_DATA = os.path.join(os.path.dirname(__file__), "poseidon_gl_constants.npz")


def _load():
    z = np.load(_DATA)
    return z["C"], z["S"], z["M"], z["P"]


C, S, M, P = _load()


def _pow7(x):
    x2 = gl64.mul(x, x)
    x3 = gl64.mul(x2, x)
    x4 = gl64.mul(x2, x2)
    return gl64.mul(x4, x3)


def _mat_mul(state, mat):
    """out_i = Σ_j state_j · mat[j][i]  (row-vector × matrix)."""
    out = np.zeros_like(state)
    for j in range(T):
        out = gl64.add(out, gl64.mul(state[:, j : j + 1], mat[j][None, :]))
    return out


def permute(state: np.ndarray) -> np.ndarray:
    """Full Poseidon permutation on a batch of states, shape (B, 12)."""
    state = np.asarray(state, dtype=np.uint64)
    squeeze = state.ndim == 1
    if squeeze:
        state = state[None, :]
    assert state.shape[1] == T

    state = gl64.add(state, C[0:T][None, :])

    half = N_ROUNDS_F // 2
    for r in range(half - 1):
        state = _pow7(state)
        state = gl64.add(state, C[(r + 1) * T : (r + 2) * T][None, :])
        state = _mat_mul(state, M)

    state = _pow7(state)
    state = gl64.add(state, C[half * T : (half + 1) * T][None, :])
    state = _mat_mul(state, P)

    for r in range(N_ROUNDS_P):
        s0 = _pow7(state[:, 0])
        s0 = gl64.add(s0, C[(half + 1) * T + r])
        state[:, 0] = s0
        srow = S[(2 * T - 1) * r : (2 * T - 1) * (r + 1)]
        new0 = np.zeros(state.shape[0], dtype=np.uint64)
        for j in range(T):
            new0 = gl64.add(new0, gl64.mul(state[:, j], srow[j]))
        for k in range(1, T):
            state[:, k] = gl64.add(
                state[:, k], gl64.mul(state[:, 0], srow[T + k - 1])
            )
        state[:, 0] = new0

    base = (half + 1) * T + N_ROUNDS_P
    for r in range(half - 1):
        state = _pow7(state)
        state = gl64.add(state, C[base + r * T : base + (r + 1) * T][None, :])
        state = _mat_mul(state, M)

    state = _pow7(state)
    state = _mat_mul(state, M)

    return state[0] if squeeze else state


def hash_n(inputs, capacity=None, n_outs: int = 4) -> np.ndarray:
    """poseidon(inputs[8], capacity[4]) -> first n_outs state elements.

    Matches the reference call signature poseidon.js:57-67.
    Batched: inputs (B, 8) [or (8,)], capacity (B, 4) [or (4,) or None].
    """
    inputs = np.asarray(inputs, dtype=np.uint64)
    squeeze = inputs.ndim == 1
    if squeeze:
        inputs = inputs[None, :]
    b = inputs.shape[0]
    assert inputs.shape[1] == 8
    if capacity is None:
        capacity = np.zeros((b, 4), dtype=np.uint64)
    else:
        capacity = np.asarray(capacity, dtype=np.uint64)
        if capacity.ndim == 1:
            capacity = np.broadcast_to(capacity[None, :], (b, 4))
    state = np.concatenate([inputs, capacity], axis=1)
    out = permute(state)[:, :n_outs]
    return out[0] if squeeze else out


_P = gl64.P_INT
_C_INT = [int(x) for x in C]
_S_INT = [int(x) for x in S]
_M_INT = [[int(x) for x in row] for row in M]
_P_INT = [[int(x) for x in row] for row in P]


def _pow7_int(x: int) -> int:
    x2 = x * x % _P
    return x2 * x2 % _P * x2 % _P * x % _P


def _mat_int(s, mat):
    return [sum(s[j] * mat[j][i] for j in range(T)) % _P for i in range(T)]


def permute_int(state) -> list:
    """The permutation of ONE state of 12 python ints (same schedule)."""
    s = [(int(v) + _C_INT[i]) % _P for i, v in enumerate(state)]
    half = N_ROUNDS_F // 2
    for r in range(half - 1):
        s = [(_pow7_int(v) + _C_INT[(r + 1) * T + i]) % _P for i, v in enumerate(s)]
        s = _mat_int(s, _M_INT)
    s = [(_pow7_int(v) + _C_INT[half * T + i]) % _P for i, v in enumerate(s)]
    s = _mat_int(s, _P_INT)
    for r in range(N_ROUNDS_P):
        s0 = (_pow7_int(s[0]) + _C_INT[(half + 1) * T + r]) % _P
        srow = _S_INT[(2 * T - 1) * r: (2 * T - 1) * (r + 1)]
        s[0] = s0
        new0 = sum(s[j] * srow[j] for j in range(T)) % _P
        for k in range(1, T):
            s[k] = (s[k] + s0 * srow[T + k - 1]) % _P
        s[0] = new0
    base = (half + 1) * T + N_ROUNDS_P
    for r in range(half - 1):
        s = [(_pow7_int(v) + _C_INT[base + r * T + i]) % _P for i, v in enumerate(s)]
        s = _mat_int(s, _M_INT)
    s = [_pow7_int(v) for v in s]
    return _mat_int(s, _M_INT)
