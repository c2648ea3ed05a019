"""State machines exercising each eSTARK argument: plookup, permutation,
connection (copy-constraints), and the combined "all" machine.

Witness generators mirror the reference fixtures (pil2-stark-js
test/state_machines/sm_plookup/sm_plookup.js, sm_permutation/sm_permutation.js,
sm_connection/sm_connection.js, sm/sm_global.js, sm_all/all_main.pil).  The
PIL sources and their compiled setups live with the JAX package
(models/gadgets.py) and in setups/all_*.json; the per-row loops of the JAX
generators are vectorized here where the rows are independent."""
from __future__ import annotations

import numpy as np

from ..field import gl64

K_GEN = 12275445934081160404  # F.k = 7^(2^32), f3g.js:26


def get_ks(n: int):
    """pilcom getKs: successive powers of F.k (coset labels for connection);
    a copy of pil2_stark_tpu/compiler/pil1_libs.get_ks for the GL field."""
    ks = [K_GEN]
    for _ in range(1, n):
        ks.append((ks[-1] * K_GEN) % gl64.P_INT)
    return ks


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
