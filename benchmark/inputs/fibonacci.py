"""pil2-stark-js test/state_machines/sm_fibonacci (sm_fibonacci.js:1-27):
a frozen copy of the builders of pil2_stark_tpu_torch/models/fibonacci.py
(build_constants, execute) at commit a529475.  The two public inputs are
drawn from the generator; the third public is the last l1."""
from __future__ import annotations

import numpy as np

from benchmark.inputs.gl_np import P_INT


def fixed(n: int) -> dict:
    l1 = np.zeros(n, dtype=np.uint64)
    last = np.zeros(n, dtype=np.uint64)
    l1[0], last[n - 1] = 1, 1
    return {"Fibonacci.L1": l1, "Fibonacci.LLAST": last}


def witness(n: int, rng: np.random.Generator):
    """l2[0] = in1, l1[0] = in2; l2' = l1, l1' = l1^2 + l2^2 (python ints:
    the recurrence is sequential)."""
    in1, in2 = (int(v) for v in rng.integers(0, P_INT, size=2, dtype=np.uint64))
    l1, l2 = [0] * n, [0] * n
    l2[0], l1[0] = in1, in2
    for i in range(1, n):
        l2[i] = l1[i - 1]
        l1[i] = (l2[i - 1] * l2[i - 1] + l1[i - 1] * l1[i - 1]) % P_INT
    cols = {"Fibonacci.l1": np.array(l1, dtype=np.uint64),
            "Fibonacci.l2": np.array(l2, dtype=np.uint64)}
    return cols, [in1, in2, l1[n - 1]]
