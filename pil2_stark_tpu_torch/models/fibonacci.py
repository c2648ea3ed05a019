"""Fibonacci state machine — the reference's minimal E2E fixture.

Witness generators mirror pil2-stark-js test/state_machines/sm_fibonacci/
sm_fibonacci.js (buildConstants :1-12, execute :15-27); the PIL source is
embedded (same constraints as fibonacci_main.pil + fibonacci.pil), with a
boundary variant (everyFrame, firstRow and lastRow constraints, no
L1/LLAST; ``pil_boundaries``).  Their compiled setups are committed as
setups/fibonacci_*.json and setups/boundaries_6.json.
"""
from __future__ import annotations

import numpy as np

from ..field import gl64

PIL_SOURCE = """
constant %N = 2**{nbits};

namespace Fibonacci(%N);

    pol constant L1, LLAST;
    pol commit l1,l2;

    pol l2c = l2;

    public in1 = l2c(0);
    public in2 = l1(0);
    public out = l1(%N-1);

    (l2' - l1)*(1-LLAST) = 0;

    pol next = l1*l1 + l2*l2;

    (l1' - next)*(1-LLAST) = 0;

    L1 * (l2 - :in1) = 0;
    L1 * (l1 - :in2) = 0;
    LLAST * (l1 - :out) = 0;
"""

STARK_STRUCT = {
    "nBits": 6,
    "nBitsExt": 9,
    "nQueries": 8,
    "verificationHashType": "GL",
    "steps": [{"nBits": 9}, {"nBits": 6}, {"nBits": 3}],
}


def pil_source(n_bits: int = 6) -> str:
    return PIL_SOURCE.format(nbits=n_bits)


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


PIL_SOURCE_BOUNDARIES = """
constant %N = 2**{nbits};

namespace Fibonacci(%N);

    pol commit l1,l2;

    pol l2c = l2;

    public in1 = l2c(0);
    public in2 = l1(0);
    public out = l1(%N-1);

    l2' - l1 = 0;

    l1' - (l1*l1 + l2*l2) = 0;

    l2 - :in1 = 0;
    l1 - :in2 = 0;
    l1 - :out = 0;
"""


def pil_boundaries(n_bits: int = 6) -> dict:
    """The reference's boundary-variant fixture (fibonacci_main2.pil with
    the identity boundaries mutated as in stark_fibonacci.test.js:34-44:
    frame constraints for the recurrences, firstRow/lastRow for the public
    bindings — no L1/LLAST selector columns)."""
    from ..compiler import pil1_parser

    pil = pil1_parser.compile_pil_source(
        PIL_SOURCE_BOUNDARIES.format(nbits=n_bits)
    )
    pil["name"] = "Fibonacci"
    idents = pil["polIdentities"]
    idents[0].update(boundary="everyFrame", offsetMin=0, offsetMax=1)
    idents[1].update(boundary="everyFrame", offsetMin=0, offsetMax=1)
    idents[2]["boundary"] = "firstRow"
    idents[3]["boundary"] = "firstRow"
    idents[4]["boundary"] = "lastRow"
    return pil
