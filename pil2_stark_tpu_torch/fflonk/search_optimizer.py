"""Exhaustive fflonk parameter search: pick the composed-commitment
degree (and hence blowup) that minimises prover cost, weighting scalar
multiplications against FFTs by a measured MSM:FFT time ratio.

Counterpart of pil2-stark-js src/fflonk/search_optimizer/
{search_optimizer.js:14-63, bench_msm.js, bench_fft.js}: the reference
benchmarks ffjavascript's MSM and FFT on the ceremony ptau; here the
primitives are our curve/bn254.py MSM and ops/fft_bn128.py NTT, and the
ratio can be measured on any ptau dict (dev_ptau included) or passed in
precomputed.
"""
from __future__ import annotations

import time

from ..curve.bn254 import g1_msm
from ..ops.fft_bn128 import FR, intt, ntt

MAX_PTAU_DEGREE = 28


def msm_bench(ptau, power: int, iterations: int = 1) -> float:
    """Seconds per size-2^power G1 MSM (bench_msm.js)."""
    n = 1 << power
    g1s = ptau["g1"][:n]
    if len(g1s) < n:
        raise ValueError(
            f"ptau too small for 2^{power} MSM ({len(g1s)} < {n})"
        )
    scalars = [(i * 0x9E3779B97F4A7C15 + 1) % FR for i in range(n)]
    best = float("inf")
    for _ in range(iterations):
        t0 = time.perf_counter()
        g1_msm(g1s, scalars)
        best = min(best, time.perf_counter() - t0)
    return best


def fft_bench(power: int, iterations: int = 1, inverse: bool = False) -> float:
    """Seconds per size-2^power Fr NTT (bench_fft.js / ifftBench)."""
    n = 1 << power
    coefs = [(i * 3 + 7) % FR for i in range(n)]
    fn = intt if inverse else ntt
    best = float("inf")
    for _ in range(iterations):
        t0 = time.perf_counter()
        fn(coefs)
        best = min(best, time.perf_counter() - t0)
    return best


def ratio_msm_to_fft(ptau, power: int, iterations: int = 5) -> float:
    """getRatioMSMtoFFT: one warm-up MSM, then best-of-n timings."""
    msm_bench(ptau, power, 1)  # warm-up (the reference does the same)
    msm = msm_bench(ptau, power, iterations)
    fft = fft_bench(power, iterations)
    fft_bench(power, iterations, inverse=True)  # measured, unused (ref parity)
    return msm / fft


def fflonk_cost_table(n_low: int, n_high: int, power: int,
                      n_intermediate: int, n_p: int, ratio: float):
    """constructFflonkCostTable: cost of each candidate composed degree.

    degP candidates in [n_low, n_high]; blowup = floor(log2(degP-2)) + 2;
    msm count = nI + degP - 1; fft count = (nP + nI) * 2^(blowup-1)."""
    table = []
    for deg_p in range(n_low, n_high + 1):
        blowup = (deg_p - 2).bit_length() - 1 + 2
        max_power = MAX_PTAU_DEGREE - (blowup - 1)
        if power > max_power:
            continue
        msm = n_intermediate + deg_p - 1
        fft = (n_p + n_intermediate) * (1 << (blowup - 1))
        table.append({
            "degP": deg_p,
            "degZ": deg_p - 1,
            "blowup": blowup,
            "msm": msm,
            "fft": fft,
            "maxDeg": max_power,
            "cost": msm * ratio + fft,
        })
    return table


def exhaustive_search_optimizer(power: int, n_intermediate: int, n_p: int,
                                ratio: float = None, ptau=None,
                                iterations: int = 5,
                                n_low: int = 3, n_high: int = 10):
    """exhaustiveSearchOptimizerFflonk: minimum-cost candidate.  Pass a
    precomputed `ratio`, or a ptau dict to measure it here."""
    if ratio is None:
        if ptau is None:
            raise ValueError("pass either ratio= or ptau= to measure it")
        ratio = ratio_msm_to_fft(ptau, power, iterations)
    table = fflonk_cost_table(n_low, n_high, power, n_intermediate, n_p, ratio)
    if not table:
        raise ValueError(
            f"no feasible degree: 2^{power} exceeds the ptau ceiling "
            f"for every blowup in [{n_low}, {n_high}]"
        )
    return min(table, key=lambda d: d["cost"])
