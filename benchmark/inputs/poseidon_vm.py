"""The Poseidon VM: one Goldilocks Poseidon permutation per 32 rows, each
row's round selected by fixed columns (the shape of the Poseidon
custom-gate rows of pil2-stark-js's C12/C18 compressor machines).

A frozen copy of the vectorised builders of
pil2_stark_tpu_torch/models/poseidon_vm.py (_round_schedule,
_schedule_tables, build_constants, build_globals, execute, _apply_round)
at commit a529475, on numpy alone.  The input states are drawn from the
generator; the machine has no publics."""
from __future__ import annotations

import os

import numpy as np

from benchmark.inputs import gl_np as gl

ROWS_PER_PERM = 32
ROUNDS = 30
_z = np.load(os.path.join(os.path.dirname(__file__), os.pardir, "reference",
                          "poseidon_gl_constants.npz"))
C, S, M, P = _z["C"], _z["S"], _z["M"], _z["P"]


def _pow7(x):
    x2 = gl.mul(x, x)
    return gl.mul(gl.mul(x2, x2), gl.mul(x2, x))


def _mat_mul(state, mat):
    out = np.zeros_like(state)
    for j in range(12):
        out = gl.add(out, gl.mul(state[:, j:j + 1], mat[j][None, :]))
    return out


def _round_schedule():
    """(type, C row, S row or None) of each of a permutation's 30 rounds."""
    rows = [("M", C[(r + 1) * 12:(r + 2) * 12], None) for r in range(3)]
    rows.append(("P", C[4 * 12:5 * 12], None))
    for r in range(22):
        c_row = np.zeros(12, dtype=np.uint64)
        c_row[0] = C[5 * 12 + r]
        rows.append(("PART", c_row, S[23 * r:23 * (r + 1)]))
    base = 5 * 12 + 22
    rows += [("M", C[base + r * 12:base + (r + 1) * 12], None) for r in range(3)]
    rows.append(("M", np.zeros(12, dtype=np.uint64), None))
    return rows


def fixed(n: int) -> dict:
    k = n // ROWS_PER_PERM
    c_tab = np.zeros((ROWS_PER_PERM, 12), dtype=np.uint64)
    sc_tab = np.zeros((ROWS_PER_PERM, 23), dtype=np.uint64)
    sel = {kind: np.zeros(ROWS_PER_PERM, dtype=np.uint64) for kind in ("M", "P", "PART")}
    for r, (kind, c_row, s_row) in enumerate(_round_schedule()):
        c_tab[r] = c_row
        if s_row is not None:
            sc_tab[r] = s_row
        sel[kind][r] = 1
    cols = {"Global.L1": np.zeros(n, dtype=np.uint64)}
    cols["Global.L1"][0] = 1
    for i in range(12):
        cols[f"PoseidonVM.C{i}"] = np.tile(c_tab[:, i], k)
    for i in range(23):
        cols[f"PoseidonVM.SC{i}"] = np.tile(sc_tab[:, i], k)
    for kind in ("M", "P", "PART"):
        cols[f"PoseidonVM.SEL{kind}"] = np.tile(sel[kind], k)
    return cols


def _apply_round(state, kind, c_row, s_row):
    if kind in ("M", "P"):
        return _mat_mul(gl.add(_pow7(state), c_row[None, :]), M if kind == "M" else P)
    x0 = gl.add(_pow7(state[:, 0]), c_row[0])
    new0 = gl.mul(x0, s_row[0])
    for j in range(1, 12):
        new0 = gl.add(new0, gl.mul(state[:, j], s_row[j]))
    out = gl.add(state, gl.mul(x0[:, None], s_row[None, 11:23]))
    out[:, 0] = new0
    return out


def witness(n: int, rng: np.random.Generator):
    """The trace of n // 32 permutations of input states drawn from rng:
    30 round-entry rows, the final state and its copy."""
    k = n // ROWS_PER_PERM
    inputs = rng.integers(0, gl.P_INT, size=(k, 12), dtype=np.uint64)
    trace = np.empty((k, ROWS_PER_PERM, 12), dtype=np.uint64)
    state = gl.add(inputs, C[0:12][None, :])
    for r, (kind, c_row, s_row) in enumerate(_round_schedule()):
        trace[:, r] = state
        state = _apply_round(state, kind, c_row, s_row)
    trace[:, ROUNDS] = state
    trace[:, ROUNDS + 1] = state
    flat = trace.reshape(k * ROWS_PER_PERM, 12)
    return {f"PoseidonVM.s{i}": np.ascontiguousarray(flat[:, i]) for i in range(12)}, []
