"""State machines exercising each eSTARK argument: plookup, permutation,
connection (copy-constraints), and the combined "all" machine.

PIL sources and witness generators mirror the reference fixtures
(pil2-stark-js test/state_machines/sm_plookup/sm_plookup.js,
sm_permutation/sm_permutation.js, sm_connection/sm_connection.js,
sm/sm_global.js, sm_all/all_main.pil); their compiled setups are committed
as setups/all_*.json.  The per-row loops of the JAX generators are
vectorized here where the rows are independent."""
from __future__ import annotations

import numpy as np

from ..compiler.pil1_libs import get_ks
from ..field import gl64

GLOBAL_PIL = """
namespace Global(%N);
    pol constant L1;
"""

PLOOKUP_PIL = """
namespace Plookup(%N);

    pol commit sel, a, b;
    pol commit cc;

    pol constant SEL, A, B;

    sel {a, b', a*b'} in SEL {A, B, cc};
"""

PERMUTATION_PIL = """
namespace Permutation(%N);

    pol commit a, b;
    pol commit c, d;
    pol commit selC, selD;

    selC {c, c} is selD {d, d};
"""

CONNECTION_PIL = """
namespace Connection(%N);
    pol constant S1, S2, S3;
    pol commit a,b,c;

    {a, b, c} connect {S1, S2, S3};
"""


def source(parts, n_bits):
    return f"constant %N = 2**{n_bits};\n" + "\n".join(parts)


def build_global_constants(n, pols):
    pols.L1[:] = 0
    pols.L1[0] = 1


# -- plookup ----------------------------------------------------------------


def build_plookup_constants(n, pols):
    grid = min(256, n)
    idx = np.arange(grid)
    pols.A[:grid] = idx // 16
    pols.B[:grid] = idx % 16
    pols.SEL[:grid] = 1
    pols.A[grid:] = 0
    pols.B[grid:] = 0
    pols.SEL[grid:] = 0


def execute_plookup(n, pols):
    grid = min(256, n)
    idx = np.arange(grid)
    pols.cc[:grid] = (idx // 16) * (idx % 16)
    pols.cc[grid:] = np.arange(grid, n)

    # selected rows look up (a, b', a·b') — keep the pairs inside the
    # table grid (A < grid/16, B < 16) so small-n machines (the
    # multichip dryrun runs this at n=64) stay satisfiable
    a_max = max(1, grid // 16)
    n_sel = min(10, n - 2)
    pairs = [(i % a_max, (i * 7 + 3) % 16) for i in range(n_sel)]
    pols.sel[:] = 0
    pols.a[:] = pairs[0][0]
    pols.b[:] = pairs[0][1]
    for i, (av, bv) in enumerate(pairs):
        pols.sel[i] = 1
        pols.a[i] = av
        pols.b[i + 1] = bv  # row i's lookup reads b' = b[i+1]


# -- permutation ------------------------------------------------------------


def execute_permutation(n, pols):
    i = np.arange(n, dtype=np.uint64)
    a = i * i + i + np.uint64(1)  # < p for any n below 2^31
    pols.a[:] = a
    pols.b[:] = a[::-1]
    even = (i % np.uint64(2)) == 0
    pols.selC[:] = even
    pols.c[:] = np.where(even, a, np.uint64(44))
    pols.selD[: n // 2] = 1
    pols.d[: n // 2] = a[0::2]
    pols.selD[n // 2:] = 0
    pols.d[n // 2:] = 55


# -- connection -------------------------------------------------------------


def build_connection_constants(n, pols):
    pow_bits = n.bit_length() - 1
    ks = get_ks(2)
    w = gl64.powers(gl64.w(pow_bits), n)
    pols.S1[:] = w
    pols.S2[:] = gl64.mul(w, np.uint64(ks[0]))
    pols.S3[:] = gl64.mul(w, np.uint64(ks[1]))
    # the swaps chain through S2, so they run in order, on python lists
    s1, s2, s3 = pols.S1.tolist(), pols.S2.tolist(), pols.S3.tolist()
    for i in range(n):
        j = i // 2 if i % 2 == 0 else n // 2 + (i - 1) // 2
        s1[i], s2[j] = s2[j], s1[i]
        s2[i], s3[j] = s3[j], s2[i]
    pols.S1[:] = np.array(s1, dtype=np.uint64)
    pols.S2[:] = np.array(s2, dtype=np.uint64)
    pols.S3[:] = np.array(s3, dtype=np.uint64)


def execute_connection(n, pols):
    a = np.arange(n, dtype=np.uint64)
    b = np.concatenate([a[0::2], a[1::2]])
    pols.a[:] = a
    pols.b[:] = b
    pols.c[:] = np.concatenate([b[0::2], b[1::2]])


# -- assembled machines -----------------------------------------------------


def plookup_source(n_bits):
    return source([GLOBAL_PIL, PLOOKUP_PIL], n_bits)


def permutation_source(n_bits):
    return source([GLOBAL_PIL, PERMUTATION_PIL], n_bits)


def connection_source(n_bits):
    return source([GLOBAL_PIL, CONNECTION_PIL], n_bits)


def all_source(n_bits):
    from . import fibonacci

    fib = fibonacci.PIL_SOURCE.format(nbits=n_bits).split("namespace", 1)[1]
    return source(
        [GLOBAL_PIL, "namespace" + fib, CONNECTION_PIL, PERMUTATION_PIL, PLOOKUP_PIL],
        n_bits,
    )


def build_all(references: dict, n: int):
    """Fixed columns, witness columns and publics of the "all" machine."""
    from ..stark import witness
    from . import fibonacci

    const_cols = witness.generate_fixed_cols(references, n)
    cm_cols = witness.generate_wtns_cols(references, n)
    build_global_constants(n, const_cols.Global)
    build_plookup_constants(n, const_cols.Plookup)
    execute_plookup(n, cm_cols.Plookup)
    execute_permutation(n, cm_cols.Permutation)
    build_connection_constants(n, const_cols.Connection)
    execute_connection(n, cm_cols.Connection)
    fibonacci.build_constants(n, const_cols.Fibonacci)
    out = fibonacci.execute(n, cm_cols.Fibonacci, [1, 2])
    return const_cols, cm_cols, [1, 2, out]


def stark_struct(n_bits, n_bits_ext=None, n_queries=8):
    n_bits_ext = n_bits_ext if n_bits_ext is not None else n_bits + 1
    steps = []
    b = n_bits_ext
    while b > 3:
        steps.append({"nBits": b})
        b -= 3
    steps.append({"nBits": b})
    return {
        "nBits": n_bits,
        "nBitsExt": n_bits_ext,
        "nQueries": n_queries,
        "verificationHashType": "GL",
        "steps": steps,
    }
