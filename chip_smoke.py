#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (pil2_stark_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. build   — compile every CUDA source of the port (one nvcc per source,
               all in parallel);
  2. kernels — run each kernel of the prove path (B2 level_planar, B3
               base_grid, B4 Poseidon) at the shapes the 2^20 prove gives it,
               on random values plus near-p corners, and require output equal
               bit for bit to its plain PyTorch version; time both;
  3. small   — prove the all-gadgets machine at 2^8 on the card and on the
               CPU, and require the two proofs to be identical;
  4. prove   — prove the all-gadgets machine at 2^20 rows (nBitsExt 22, 32
               queries) on the card through prove(); verify the proof; report
               cold and warm wall time, the phase breakdown and peak memory.
               The kernels' launch counters are zeroed just before the cold
               prove and read just after it.
Then the card's name and power limit, the kernels line, and as the last line
{"ok": true, "device": {...}}.  Any failure exits non-zero.  Needs one CUDA
card; imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

P = 0xFFFFFFFF00000001
N_BITS = 20  # the all-gadgets machine at 2^20 rows, blowup 4 (setups/all_20.json)
N_COLS = 15  # the widest committed section of that machine (stage 1)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# Hopper has 64 INT32 lanes per SM against 128 FP32 lanes: its 32-bit
# integer multiply-add rate is half the FP32 FMA rate (67e12 FLOP/s / 2
# FLOP per FMA / 2).  A GL multiply (64x64->128 product + reduction) is
# counted as 8 such multiply-adds.
IMAD_PER_S = 67e12 / 4
IMAD_PER_GL_MUL = 8
# Poseidon: 1,122 GL multiplies per permutation plus 7 products by the
# small MDS matrix, each 144 entries × 2 halves multiply-adds.
POSEIDON_IMAD = 1122 * IMAD_PER_GL_MUL + 7 * 144 * 2
CORNERS = [0, 1, 2, P - 1, P - 2, (1 << 32) - 1, 1 << 32, (1 << 32) + 1,
           (1 << 63) - 1, 1 << 63, P - (1 << 32), P - (1 << 32) - 1]


def emit(obj):
    print(json.dumps(obj), flush=True)


def canon(o):
    import numpy as np

    if isinstance(o, np.ndarray):
        return [canon(x) for x in o.tolist()]
    if isinstance(o, (list, tuple)):
        return [canon(x) for x in o]
    if isinstance(o, dict):
        return {k: canon(v) for k, v in o.items()}
    if isinstance(o, (int, np.integer)):
        return int(o)
    return o


def random_field(shape, seed, device):
    """Canonical random values with the near-p corners at the front."""
    import numpy as np

    from pil2_stark_tpu_torch.field import torch_gl as gl

    rng = np.random.default_rng(seed)
    a = rng.integers(0, P, size=shape, dtype=np.uint64)
    flat = a.reshape(-1)
    flat[: len(CORNERS)] = np.array(CORNERS, dtype=np.uint64) % np.uint64(P)
    return gl.from_u64(a, device)


def cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b) -> float:
    import numpy as np

    from pil2_stark_tpu_torch.field import torch_gl as gl

    x, y = gl.to_u64(a).reshape(-1), gl.to_u64(b).reshape(-1)
    bad = np.nonzero(x != y)[0]
    if bad.size == 0:
        return 0.0
    return float(max(abs(int(x[i]) - int(y[i])) for i in bad[:100000]))


def phase_build():
    from pil2_stark_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    times = cuda_build.build()
    ptxas = {}
    for name in cuda_build.SOURCES:
        ptxas[name] = [ln.strip() for ln in cuda_build.build_log(name).splitlines()
                       if "registers" in ln or "spill" in ln][:8]
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "per_source": times,
          "ptxas": ptxas})


def phase_kernels(device, n_bits, n_bits_ext, n_cols):
    """Each kernel against its plain version at the 2^ext prove shapes."""
    import torch

    from pil2_stark_tpu_torch.hash import cuda_poseidon
    from pil2_stark_tpu_torch.ops import cuda_ntt, ntt

    rows = []
    ext_n = 1 << n_bits_ext
    # B2 and B3 at the extended-domain LDE shape, both directions of the
    # base-domain transform too
    for bits, inverse in ((n_bits_ext, False), (n_bits, True)):
        n = 1 << bits
        bits1 = ntt.split_bits(bits)
        bits2 = bits - bits1
        n1, n2 = 1 << bits1, 1 << bits2
        x = random_field((n_cols, n), 100 + bits, device)
        lt = ntt.level_twiddles(bits, bits1, inverse, device)
        y_k = cuda_ntt.level_planar(x, bits1, n2, n_cols, lt, inverse)
        y_p = cuda_ntt.level_planar_plain(x, bits1, n2, n_cols, lt, inverse)
        err2 = max_abs_err(y_k, y_p)
        z_k = cuda_ntt.base_grid(y_k, bits2, n_cols, inverse)
        z_p = cuda_ntt.base_grid_plain(y_k, bits2, n_cols, inverse)
        err3 = max_abs_err(z_k, z_p)
        if bits != n_bits_ext:
            # the base-domain shape is checked, the ext shape is timed
            if err2 or err3:
                raise AssertionError(f"NTT kernels disagree at 2^{bits}: {err2} {err3}")
            continue
        del y_p, z_p
        muls2 = n_cols * n * (bits1 / 2 + 1)
        bytes2 = 2 * n_cols * n * 8 + n1 * n2 * 8
        muls3 = n_cols * n * bits2 / 2
        bytes3 = 2 * n_cols * n * 8
        for name, src, repl, err, k_fn, p_fn, muls, nbytes in (
            ("level_planar", "pil2_stark_tpu_torch/csrc/ntt.cu",
             "pil2_stark_tpu/ops/pallas_ntt.py:439", err2,
             lambda: cuda_ntt.level_planar(x, bits1, n2, n_cols, lt, inverse),
             lambda: cuda_ntt.level_planar_plain(x, bits1, n2, n_cols, lt, inverse),
             muls2, bytes2),
            ("base_grid", "pil2_stark_tpu_torch/csrc/ntt.cu",
             "pil2_stark_tpu/ops/pallas_ntt.py:497", err3,
             lambda: cuda_ntt.base_grid(y_k, bits2, n_cols, inverse),
             lambda: cuda_ntt.base_grid_plain(y_k, bits2, n_cols, inverse),
             muls3, bytes3),
        ):
            rows.append(_kernel_row(name, src, repl, err, k_fn, p_fn,
                                    muls * IMAD_PER_GL_MUL, nbytes,
                                    {"n_cols": n_cols, "n": n, "n1": n1, "n2": n2}))
    # B4 at the leaf-sponge batch of an extended-domain tree
    state = random_field((12, ext_n), 7, device)
    out_k = cuda_poseidon.permute(state)
    out_p = cuda_poseidon.permute_plain(state)
    err4 = max_abs_err(out_k, out_p)
    del out_p
    rows.append(_kernel_row(
        "poseidon", "pil2_stark_tpu_torch/csrc/poseidon.cu",
        "pil2_stark_tpu/hash/pallas_poseidon.py:433", err4,
        lambda: cuda_poseidon.permute(state), lambda: cuda_poseidon.permute_plain(state),
        ext_n * POSEIDON_IMAD, 2 * 12 * ext_n * 8, {"batch": ext_n}))
    for r in rows:
        emit({"phase": "kernels", **r})
    bad = [r["name"] for r in rows if r["max_abs_err"] != 0]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")
    torch.cuda.empty_cache()
    return rows


def _kernel_row(name, src, repl, err, k_fn, p_fn, imads, nbytes, shape):
    ms = cuda_ms(k_fn, 20)
    plain_ms = cuda_ms(p_fn, 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = imads / IMAD_PER_S * 1e3
    return {"name": name, "route": "cuda", "source": src, "replaces": repl,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "shape": shape}


def _prove_all(n_bits, device, setup=None):
    from pil2_stark_tpu_torch.models import gadgets
    from pil2_stark_tpu_torch.stark import prover, setup as stark_setup

    data = stark_setup.read_setup(f"all_{n_bits}")
    const_cols, cm_cols, publics = gadgets.build_all(data["references"], 1 << n_bits)
    if setup is None:
        setup = stark_setup.load_setup(data["starkInfo"], data["expressionsInfo"],
                                       data["verifierInfo"], const_cols.buffer, device=device)
    res = prover.prove(setup["starkInfo"], setup["expressionsInfo"], const_cols.buffer,
                       setup["constTree"], (cm_cols.buffer, publics), device=device)
    return res, setup


def phase_small(device):
    from pil2_stark_tpu_torch.stark import verifier

    t0 = time.perf_counter()
    res_gpu, s_gpu = _prove_all(8, device)
    res_cpu, _ = _prove_all(8, "cpu")
    same = (canon(res_gpu["proof"]) == canon(res_cpu["proof"])
            and res_gpu["challenges"] == res_cpu["challenges"])
    ok = verifier.verify(res_gpu["proof"], res_gpu["publics"], s_gpu["constRoot"],
                         s_gpu["starkInfo"], s_gpu["verifierInfo"])
    emit({"phase": "small", "machine": "all", "n_bits": 8, "identical": same,
          "verified": ok, "seconds": time.perf_counter() - t0})
    if not (same and ok):
        raise AssertionError("all 2^8: card and CPU proofs differ or do not verify")


def phase_prove(device, n_bits, counters):
    import torch

    from pil2_stark_tpu_torch.models import gadgets
    from pil2_stark_tpu_torch.stark import prover, setup as stark_setup, verifier

    data = stark_setup.read_setup(f"all_{n_bits}")
    t0 = time.perf_counter()
    const_cols, cm_cols, publics = gadgets.build_all(data["references"], 1 << n_bits)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    setup = stark_setup.load_setup(data["starkInfo"], data["expressionsInfo"],
                                   data["verifierInfo"], const_cols.buffer, device=device)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0

    def run():
        t = time.perf_counter()
        res = prover.prove(setup["starkInfo"], setup["expressionsInfo"], const_cols.buffer,
                           setup["constTree"], (cm_cols.buffer, publics), device=device)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t

    for c in counters:
        c.launches = 0
    res, cold = run()
    launches = {c.__name__: c.launches for c in counters}
    res_warm, warm = run()
    peak = max(res_warm["peakBytes"].values())  # every allocation happens inside a phase
    same = canon(res["proof"]) == canon(res_warm["proof"])
    t0 = time.perf_counter()
    ok = verifier.verify(res_warm["proof"], res_warm["publics"], setup["constRoot"],
                         setup["starkInfo"], setup["verifierInfo"])
    t_verify = time.perf_counter() - t0
    ss = data["starkInfo"]["starkStruct"]
    emit({"phase": "prove", "machine": "all", "n_bits": ss["nBits"],
          "n_bits_ext": ss["nBitsExt"], "n_queries": ss["nQueries"],
          "verified": ok, "repeatable": same, "cold_s": cold, "warm_s": warm,
          "witness_build_s": t_build, "load_setup_s": t_setup, "verify_s": t_verify,
          "peak_device_bytes": peak, "phases_warm_s": res_warm["timings"],
          "phases_cold_s": res["timings"], "phases_peak_bytes": res_warm["peakBytes"],
          "launches": launches})
    if not (ok and same):
        raise AssertionError("the 2^20 proof does not verify or is not repeatable")
    return launches


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        from pil2_stark_tpu_torch.hash import cuda_poseidon
        from pil2_stark_tpu_torch.ops import cuda_ntt
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 2

    device = torch.device("cuda", 0)
    counters = [cuda_ntt.level_planar, cuda_ntt.base_grid, cuda_poseidon.permute]
    t_start = time.perf_counter()
    phase_build()
    rows = phase_kernels(device, N_BITS, N_BITS + 2, N_COLS)
    phase_small(device)
    launches = phase_prove(device, N_BITS, counters)
    zero = [k for k, v in launches.items() if v == 0]
    if zero:
        raise AssertionError(f"kernels never launched on the prove path: {zero}")
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(card_line(), flush=True)
    names = {"level_planar": "level_planar", "base_grid": "base_grid", "poseidon": "permute"}
    kernels = []
    for r in rows:
        row = {k: v for k, v in r.items() if k != "shape"}
        row["launches"] = launches[names[r["name"]]]
        kernels.append(row)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
