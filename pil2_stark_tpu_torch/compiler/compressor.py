"""Compressor core: converts an R1CS circuit into a provable PIL machine.

This is the recursion-plumbing step of the proof-composition chain
(SURVEY.md §3.4): a verifier circuit's R1CS becomes a new PIL whose STARK
proof attests satisfaction of the original circuit.  Mirrors the structure
of pil2-stark-js src/compressor/compressor12_setup.js + compressor_exec.js
reduced to its core: PlonK gates + copy constraints — the reference's
additional custom gates (POSEIDON/CMUL/FFT4/...) are an optimization layer
over the same skeleton and are slated for round 2.

Pipeline:
  r1cs2plonk → gate rows (sl,sr,so,qm,ql,qr,qo,qc)
  setup      → PIL source (plonk identity + {a,b,c} connect {S1,S2,S3}),
               fixed columns (Qm..Qc, S1..S3 with permuted cycles),
               sMap (gate slot → signal id)
  exec       → replay plonkAdditions over the witness, scatter by sMap
               into the committed a/b/c columns
"""
from __future__ import annotations

import numpy as np

from ..field import gl64
from .r1cs2plonk import r1cs2plonk
from .pil1_libs import get_ks

P = gl64.P_INT

PIL_TEMPLATE = """
constant %N = 2**{n_bits};

namespace Global(%N);
    pol constant L1;

namespace Compressor(%N);
    pol constant Qm, Ql, Qr, Qo, Qc;
    pol constant S1, S2, S3;
    pol commit a, b, c;

    Qm*a*b + Ql*a + Qr*b + Qo*c + Qc = 0;

    {{a, b, c}} connect {{S1, S2, S3}};
"""


def setup(prime: int, constraints, n_vars: int, min_n_bits: int = 3):
    """Compressor setup.  Returns a dict with pil source, fixed columns,
    sMap and the plonk additions (for exec)."""
    assert prime == P, "compressor tier runs over Goldilocks"
    plonk_constraints, plonk_additions, total_vars = r1cs2plonk(
        prime, constraints, n_vars
    )
    n_gates = len(plonk_constraints)
    n_bits = max(min_n_bits, (max(n_gates, 2) - 1).bit_length())
    n = 1 << n_bits

    q = np.zeros((n, 5), dtype=np.uint64)  # Qm Ql Qr Qo Qc
    s_map = np.zeros((n, 3), dtype=np.int64)  # signal per slot (0 = const 1?)
    for r, (sl, sr, so, qm, ql, qr, qo, qc) in enumerate(plonk_constraints):
        q[r] = [qm % P, ql % P, qr % P, qo % P, qc % P]
        s_map[r] = [sl, sr, so]
    # padding rows: all-zero gates; slots reference signal 0 so the copy
    # argument keeps them in one harmless cycle with other s=0 slots

    # connection columns: start as the coset grid w^i, k1 w^i, k2 w^i and
    # swap along each signal's occurrence cycle (compressor_constraints.js /
    # sm_connection buildConstants pattern)
    ks = get_ks(2)
    w_pows = gl64.powers(gl64.w(n_bits), n)
    s_cols = np.stack(
        [
            w_pows,
            gl64.mul(w_pows, np.uint64(ks[0])),
            gl64.mul(w_pows, np.uint64(ks[1])),
        ],
        axis=1,
    )
    # build occurrence lists per signal
    occurrences: dict[int, list[tuple[int, int]]] = {}
    for r in range(n):
        for col in range(3):
            occurrences.setdefault(int(s_map[r, col]), []).append((r, col))
    # rotate each cycle: S[occ[i]] <- grid value of occ[i+1]
    for sig, occ in occurrences.items():
        if len(occ) < 2:
            continue
        vals = [int(s_cols[r, c]) for (r, c) in occ]
        rotated = vals[1:] + vals[:1]
        for (r, c), v in zip(occ, rotated):
            s_cols[r, c] = v

    # fixed cols order: Global.L1(0) then Qm Ql Qr Qo Qc S1 S2 S3
    l1 = np.zeros(n, dtype=np.uint64)
    l1[0] = 1
    const_pols = np.concatenate(
        [l1[:, None], q, s_cols], axis=1
    )

    return {
        "pilSource": PIL_TEMPLATE.format(n_bits=n_bits),
        "nBits": n_bits,
        "constPols": const_pols,
        "sMap": s_map,
        "plonkAdditions": plonk_additions,
        "nVars": total_vars,
        "nGates": n_gates,
    }


def exec_witness(setup_data: dict, witness) -> np.ndarray:
    """compressor_exec.js:5-32: replay the plonk addition chain over the
    R1CS witness, then scatter signals into the committed a/b/c columns."""
    w = [int(x) % P for x in witness]
    for sl, sr, kl, kr in setup_data["plonkAdditions"]:
        w.append((kl * w[sl] + kr * w[sr]) % P)
    assert len(w) == setup_data["nVars"], (len(w), setup_data["nVars"])

    s_map = setup_data["sMap"]
    n = s_map.shape[0]
    cm = np.zeros((n, 3), dtype=np.uint64)
    for r in range(n):
        for col in range(3):
            cm[r, col] = w[int(s_map[r, col])]
    return cm
