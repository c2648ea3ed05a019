"""fibv: a two-subproof vadcop machine (Module + Fibonacci) whose mod
reductions are delegated from the Fibonacci air to the Module air through a
log-up (gsum) argument, with the global constraint
gsum_fibonacci + gsum_module === 0 over the two subproof values.

Witness generator of pil2_stark_tpu/models/fibv.py (``execute`` :259).
The pilout is the JAX package's compiler's: the two airs' setups and the
global constraint's code are committed as setups/fibv_module.json,
setups/fibv_fibonacci.json and setups/fibv_global.json.
"""
from __future__ import annotations

import numpy as np

from ..field import gl64

P = gl64.P_INT
N_BITS = 4
N = 1 << N_BITS


def execute(mod: int, in1: int, in2: int):
    """Consistent stage-1 witnesses of both subproofs and the publics.

    Returns (cm_module (N, 3), cm_fib (N, 2), publics [mod, in1, in2, out]).
    The fibonacci chain sends one (x = a^2 + b^2, x mod m) pair per row to
    the Module air (1:1, so the log-up sums cancel exactly)."""
    a = [0] * (N + 1)
    b = [0] * (N + 1)
    b[0], a[0] = in1, in2
    xs = []
    for i in range(N):
        x = (a[i] * a[i] + b[i] * b[i]) % P
        xs.append(x)
        a[i + 1] = x % mod
        b[i + 1] = a[i]
    out = a[N]

    cm_mod = np.zeros((N, 3), dtype=np.uint64)
    cm_mod[:, 0] = xs
    cm_mod[:, 1] = [x // mod for x in xs]
    cm_mod[:, 2] = [x % mod for x in xs]

    cm_fib = np.zeros((N, 2), dtype=np.uint64)
    cm_fib[:, 0] = a[:N]
    cm_fib[:, 1] = b[:N]
    return cm_mod, cm_fib, [mod, in1, in2, out]
