"""Poseidon verification machine: a trace whose rows hold successive
Poseidon-GL round states, each row transition a constraint selected by
fixed columns — the shape of the C12/C18 recursion machines' custom gates.

Builders of pil2_stark_tpu/models/poseidon_vm.py (``_round_schedule`` :81,
``build_constants`` :101, ``build_globals`` :119, ``execute`` :124,
``_apply_round`` :149), vectorised: the JAX builders loop over rows and
scalars in python, which at 2^20 rows (32,768 permutations) would take
hours.  Here ``build_constants`` tiles the 32-row schedule and ``execute``
runs each of the 30 rounds on all K states at once as (K, 12) arrays; the
columns are the JAX builders' bit for bit.  ``pil_source`` is the JAX
package's PIL source (:34-78); its compiled setups are committed as
setups/poseidon_vm_*.json.

Layout (32 rows per permutation: 30 round-entry rows, the final state,
and a copy of it as padding):
  witness  s0..s11             round-entry states
  fixed    C0..C11             post-S-box add constants per row
           SC0..SC22           the partial round's row of the S table
           SELM, SELP, SELPART round-type selectors
"""
from __future__ import annotations

import numpy as np

from ..field import gl64
from ..hash import poseidon_gl as pg

ROWS_PER_PERM = 32
ROUNDS = 30

PIL_SOURCE_HEADER = """
constant %N = 2**{n_bits};

namespace Global(%N);
    pol constant L1;

namespace PoseidonVM(%N);
    pol constant {fixed_decl};
    pol commit {witness_decl};
"""


def _pow7_expr(s):
    return f"({s}*{s}*{s}*{s}*{s}*{s}*{s})"


def pil_source(n_bits: int) -> str:
    fixed = [f"C{i}" for i in range(12)] + [f"SC{i}" for i in range(23)] + [
        "SELM",
        "SELP",
        "SELPART",
    ]
    witness = [f"s{i}" for i in range(12)]
    src = PIL_SOURCE_HEADER.format(
        n_bits=n_bits,
        fixed_decl=", ".join(fixed),
        witness_decl=", ".join(witness),
    )
    lines = []
    # t_k = pow7(s_k) + C_k  (shared sub-expressions as im pols)
    for k in range(12):
        lines.append(f"    pol t{k} = {_pow7_expr(f's{k}')} + C{k};")
    for mat, sel in ((pg.M, "SELM"), (pg.P, "SELP")):
        for j in range(12):
            terms = " + ".join(f"{int(mat[k][j])}*t{k}" for k in range(12))
            lines.append(f"    {sel}*(s{j}' - ({terms})) = 0;")
    # partial round
    lines.append(f"    pol x0 = {_pow7_expr('s0')} + C0;")
    new0 = " + ".join(
        ["SC0*x0"] + [f"SC{j}*s{j}" for j in range(1, 12)]
    )
    lines.append(f"    SELPART*(s0' - ({new0})) = 0;")
    for k in range(1, 12):
        lines.append(f"    SELPART*(s{k}' - s{k} - x0*SC{11 + k}) = 0;")
    return src + "\n".join(lines) + "\n"


def _round_schedule():
    """Per-row (type, C_row[12], S_row[23] or None) for one permutation's
    30 round rows."""
    C, S = pg.C, pg.S
    half = pg.N_ROUNDS_F // 2
    rows = []
    for r in range(half - 1):  # 3 full M rounds, C rows 1..3
        rows.append(("M", C[(r + 1) * 12:(r + 2) * 12], None))
    rows.append(("P", C[half * 12:(half + 1) * 12], None))
    for r in range(pg.N_ROUNDS_P):
        c_row = np.zeros(12, dtype=np.uint64)
        c_row[0] = C[(half + 1) * 12 + r]
        rows.append(("PART", c_row, S[23 * r:23 * (r + 1)]))
    base = (half + 1) * 12 + pg.N_ROUNDS_P
    for r in range(half - 1):
        rows.append(("M", C[base + r * 12:base + (r + 1) * 12], None))
    rows.append(("M", np.zeros(12, dtype=np.uint64), None))  # final, C = 0
    assert len(rows) == ROUNDS
    return rows


def _schedule_tables():
    """(C (32, 12), SC (32, 23), SELM, SELP, SELPART (32,)) of one
    permutation's block; rows 30 and 31 are zero."""
    c_tab = np.zeros((ROWS_PER_PERM, 12), dtype=np.uint64)
    sc_tab = np.zeros((ROWS_PER_PERM, 23), dtype=np.uint64)
    sel = {kind: np.zeros(ROWS_PER_PERM, dtype=np.uint64) for kind in ("M", "P", "PART")}
    for r, (kind, c_row, s_row) in enumerate(_round_schedule()):
        c_tab[r] = c_row
        if s_row is not None:
            sc_tab[r] = s_row
        sel[kind][r] = 1
    return c_tab, sc_tab, sel["M"], sel["P"], sel["PART"]


def build_constants(n: int, pols) -> None:
    k = n // ROWS_PER_PERM
    c_tab, sc_tab, selm, selp, selpart = _schedule_tables()
    for i in range(12):
        getattr(pols, f"C{i}")[:k * ROWS_PER_PERM] = np.tile(c_tab[:, i], k)
    for i in range(23):
        getattr(pols, f"SC{i}")[:k * ROWS_PER_PERM] = np.tile(sc_tab[:, i], k)
    pols.SELM[:k * ROWS_PER_PERM] = np.tile(selm, k)
    pols.SELP[:k * ROWS_PER_PERM] = np.tile(selp, k)
    pols.SELPART[:k * ROWS_PER_PERM] = np.tile(selpart, k)


def build_globals(n: int, pols) -> None:
    pols.L1[:] = 0
    pols.L1[0] = 1


def execute(n: int, pols, inputs: np.ndarray) -> np.ndarray:
    """inputs: (K, 12) initial states, K = n // 32.  Fills the witness
    trace and returns the (K, 12) final states (the permutation of each
    input)."""
    k = n // ROWS_PER_PERM
    inputs = np.asarray(inputs, dtype=np.uint64).reshape(k, 12)
    trace = np.empty((k, ROWS_PER_PERM, 12), dtype=np.uint64)
    # row 0: input plus the initial C (permute()'s pre-round addition)
    state = gl64.add(inputs, pg.C[0:12][None, :])
    for r, (kind, c_row, s_row) in enumerate(_round_schedule()):
        trace[:, r] = state
        state = _apply_round(state, kind, c_row, s_row)
    # rows 30, 31: the final state (and its copy as padding; unconstrained)
    trace[:, ROUNDS] = state
    trace[:, ROUNDS + 1] = state
    flat = trace.reshape(k * ROWS_PER_PERM, 12)
    for i in range(12):
        getattr(pols, f"s{i}")[:k * ROWS_PER_PERM] = flat[:, i]
    return state


def _apply_round(state, kind, c_row, s_row):
    """One round on (K, 12) states."""
    c_row = np.asarray(c_row, dtype=np.uint64)
    if kind in ("M", "P"):
        t = gl64.add(pg._pow7(state), c_row[None, :])
        return pg._mat_mul(t, pg.M if kind == "M" else pg.P)
    # partial: x0 = pow7(s0) + c0; new0 = Σ srow·[x0, s1..]; sk += x0·srow
    s_row = np.asarray(s_row, dtype=np.uint64)
    x0 = gl64.add(pg._pow7(state[:, 0]), c_row[0])
    new0 = gl64.mul(x0, s_row[0])
    for j in range(1, 12):
        new0 = gl64.add(new0, gl64.mul(state[:, j], s_row[j]))
    out = gl64.add(state, gl64.mul(x0[:, None], s_row[None, 11:23]))
    out[:, 0] = new0
    return out


def build(references: dict, n: int, inputs):
    """Fixed columns, witness columns and (no) publics of the machine for
    the (n // 32, 12) input states."""
    from ..stark import witness

    const_cols = witness.generate_fixed_cols(references, n)
    cm_cols = witness.generate_wtns_cols(references, n)
    build_globals(n, const_cols.Global)
    build_constants(n, const_cols.PoseidonVM)
    execute(n, cm_cols.PoseidonVM, inputs)
    return const_cols, cm_cols, []


def final_states(cm_buffer: np.ndarray) -> np.ndarray:
    """The (K, 12) final states held in a witness trace (row 30 of each
    permutation's block)."""
    k = cm_buffer.shape[0] // ROWS_PER_PERM
    return cm_buffer.reshape(k, ROWS_PER_PERM, 12)[:, ROUNDS]
