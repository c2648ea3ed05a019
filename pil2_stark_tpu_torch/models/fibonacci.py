"""Fibonacci state machine — the reference's minimal E2E fixture.

Witness generators mirror pil2-stark-js test/state_machines/sm_fibonacci/
sm_fibonacci.js (buildConstants :1-12, execute :15-27).  The PIL sources
and their compiled setups live with the JAX package (models/fibonacci.py)
and in setups/fibonacci_*.json and setups/boundaries_6.json (the boundary
variant: everyFrame, firstRow and lastRow constraints, no L1/LLAST).
"""
from __future__ import annotations

import numpy as np

from ..field import gl64


def build_constants(n: int, pols) -> None:
    pols.L1[:] = 0
    pols.L1[0] = 1
    pols.LLAST[:] = 0
    pols.LLAST[n - 1] = 1


def execute(n: int, pols, inputs) -> int:
    """The recurrence on python ints (a per-row numpy scalar loop costs
    minutes at 2^20 rows)."""
    p = gl64.P_INT
    l1 = [0] * n
    l2 = [0] * n
    l2[0] = int(inputs[0]) % p
    l1[0] = int(inputs[1]) % p
    for i in range(1, n):
        l2[i] = l1[i - 1]
        l1[i] = (l2[i - 1] * l2[i - 1] + l1[i - 1] * l1[i - 1]) % p
    pols.l1[:] = np.array(l1, dtype=np.uint64)
    pols.l2[:] = np.array(l2, dtype=np.uint64)
    return l1[n - 1]


def build(references: dict, n: int, inputs=(1, 2)):
    """Fixed columns, witness columns and publics of the machine."""
    from ..stark import witness

    const_cols = witness.generate_fixed_cols(references, n)
    cm_cols = witness.generate_wtns_cols(references, n)
    if "Fibonacci.L1" in references:  # the boundary variant has no fixed columns
        build_constants(n, const_cols.Fibonacci)
    out = execute(n, cm_cols.Fibonacci, list(inputs))
    return const_cols, cm_cols, [inputs[0], inputs[1], out]
