#!/usr/bin/env python3
"""Designs measured beside the kept kernels B1 and T2, on one card.

    python3 kernel_designs.py

* B1 (``cuda_ntt.base_rows``) at the 4096-row bases of the fibonacci
  2^22 / ext 2^25 prove (3·2^13, 2^14 and 2^13 lanes): the kept two
  launches through a scratch array against one launch that does both
  64-point passes in a block and exchanges the values through shared
  memory, with 2- and 4-lane tiles (128 and 256 threads; 66,560 and
  133,120 bytes of shared memory).
  Beside them: a copy of the same bytes (``torch.clone``) and each pass's
  own time (``torch.profiler``).
* T2 (``cuda_tac.gl_xdiv``) at 2^22 and 2^25 points with two openings:
  csrc/tac.cu built with 8, 12, 16 and 32 norms per thread (kBatch).
* The SASS of the kept kernels' forward 64-point passes and of T2 at two
  openings (cuobjdump): instructions per thread, those of them that issue
  to the integer ALU pipe and the IMADs.

Every variant is held against the plain version (bit for bit) before it
is timed with CUDA events.  Each prints one JSON line; then the card's
name and power limit.  Needs one CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys

import chip_smoke as c

# SASS that issues to the integer ALU pipe (64 lanes a clock on each SM);
# IMAD and its forms issue to the multiply-add pipe
ALU_OPS = ("IADD3", "ISETP", "SEL", "SHF", "LOP3", "LEA", "VIADD", "PRMT", "IABS")

# B1 in one launch at n = 4096 = 64 × 64: thread (i2, t) of a block of
# 64·tile threads loads x[i1·64 + i2] of lane t (i1 bit-reversed),
# transforms, multiplies by w^(o1·i2), writes (o1, i2, t) to shared
# memory (rows padded by one tile); after the barrier thread (o1, t) reads
# its 64 values, transforms and stores X[o1 + 64·o2].
ONE_PASS = r"""
#include <cuda_runtime.h>
#include <cstdint>
#include <utility>
#include "f3.cuh"
#include "gl.cuh"
#include "ntt_radix.cuh"

namespace {
__host__ __device__ constexpr int brevc(int r, int bits) {
  int o = 0;
  for (int b = 0; b < bits; ++b) o |= ((r >> b) & 1) << (bits - 1 - b);
  return o;
}
template <int... R>
__device__ __forceinline__ void ld_x(uint64_t* v, const uint64_t* x, long long lanes, int q,
                                     bool live, std::integer_sequence<int, R...>) {
  ((v[R] = live ? gl::canon(x[(long long)(brevc(R, 6) * 64 + q) * lanes]) : 0), ...);
}
// tw holds w^k for k < 2048 (cuda_ntt.radix_twiddles); w^(k + 2048) = −w^k
__device__ __forceinline__ uint64_t wk(const uint64_t* tw, int k) {
  const uint64_t w = __ldg(tw + (k & 2047));
  return k < 2048 ? w : (w ? gl::P - w : 0);
}
template <int... O>
__device__ __forceinline__ void twid(uint64_t* v, const uint64_t* tw, int q,
                                     std::integer_sequence<int, O...>) {
  ((v[O + 1] = f3::g::mul(v[O + 1], wk(tw, ((O + 1) * q) & 4095))), ...);
}
template <int... O>
__device__ __forceinline__ void st_sm(uint64_t* sm, const uint64_t* v, int stride,
                                      std::integer_sequence<int, O...>) {
  ((sm[O * stride] = v[O]), ...);
}
template <int LT, int... R>
__device__ __forceinline__ void ld_sm(uint64_t* v, const uint64_t* sm,
                                      std::integer_sequence<int, R...>) {
  ((v[R] = sm[brevc(R, 6) << LT]), ...);
}
template <int... O>
__device__ __forceinline__ void st_x(uint64_t* out, const uint64_t* v, long long lanes,
                                     std::integer_sequence<int, O...>) {
  ((out[(long long)(64 * O) * lanes] = v[O]), ...);
}

template <int LT, int MINB, bool INV>
__global__ void __launch_bounds__(64 << LT, MINB)
one_pass_kernel(const uint64_t* __restrict__ x, const uint64_t* __restrict__ tw,
                uint64_t* __restrict__ out, long long lanes) {
  extern __shared__ uint64_t sm[];
  constexpr int tile = 1 << LT, stride = 65 * tile;
  const int t = threadIdx.x & (tile - 1), q = threadIdx.x >> LT;
  const long long l = (long long)blockIdx.x * tile + t;
  const bool live = l < lanes;
  uint64_t v[64];
  ld_x(v, x + l, lanes, q, live, std::make_integer_sequence<int, 64>{});
  radix::dft<6, INV>(v);
  twid(v, tw, q, std::make_integer_sequence<int, 63>{});
  st_sm(sm + q * tile + t, v, stride, std::make_integer_sequence<int, 64>{});
  __syncthreads();
  ld_sm<LT>(v, sm + q * stride + t, std::make_integer_sequence<int, 64>{});
  radix::dft<6, INV>(v);
  if (live) st_x(out + q * lanes + l, v, lanes, std::make_integer_sequence<int, 64>{});
}

template <int LT, int MINB>
int launch(const uint64_t* x, const uint64_t* tw, uint64_t* out, long long lanes,
           cudaStream_t s) {
  const size_t smem = (size_t)64 * 65 * (1 << LT) * 8;
  auto k = one_pass_kernel<LT, MINB, false>;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  k<<<(unsigned)((lanes + (1 << LT) - 1) >> LT), 64 << LT, smem, s>>>(x, tw, out, lanes);
  return (int)cudaGetLastError();
}
}  // namespace

extern "C" int one_pass(const void* x, const void* tw, void* out, long long lanes,
                        int log_tile, void* stream) {
  auto xi = (const uint64_t*)x;
  auto ti = (const uint64_t*)tw;
  auto o = (uint64_t*)out;
  auto s = (cudaStream_t)stream;
  if (log_tile == 1) return launch<1, 3>(xi, ti, o, lanes, s);
  if (log_tile == 2) return launch<2, 1>(xi, ti, o, lanes, s);
  return (int)cudaErrorInvalidValue;
}
"""

T2_BATCH_LINE = "constexpr int kBatch = 16;"


def _build(texts):
    """Build the sources in `texts` (key -> CUDA text) in parallel: key ->
    (library, ptxas [label, registers, spill stores, spill loads])."""
    from pil2_stark_tpu_torch.utils import cuda_build

    names = {key: cuda_build.add_generated(text) for key, text in texts.items()}
    cuda_build.build(list(names.values()))
    return {key: (cuda_build.lib(name),
                  [e[:4] for e in c.ptxas_summary(cuda_build.build_log(name))])
            for key, name in names.items()}


def sass_rows():
    """Static SASS per thread of B1's forward passes at 4096 rows (64
    elements a thread) and of T2 at two openings (8 points a thread)."""
    from pil2_stark_tpu_torch.utils import cuda_build

    tool = c.cuobjdump()
    if tool is None:
        raise SystemExit("no cuobjdump on this machine")
    for lib_name, kernel, label, per in (
            ("ntt", "base_rows_pass_kernelILi6ELb0ELb1ELb1E", "B1 pass 1", 64),
            ("ntt", "base_rows_pass_kernelILi6ELb0ELb0ELb0E", "B1 pass 2", 64),
            ("tac", "xdiv_kernelILi2E", "T2, 2 openings", 8)):
        cuda_build.build([lib_name])
        out = subprocess.run([tool, "-sass", str(cuda_build.library_path(lib_name))],
                             capture_output=True, text=True, timeout=300, check=True).stdout
        ops, inside = [], False
        for ln in out.splitlines():
            if "Function :" in ln:
                inside = kernel in ln
            elif inside and (m := c.SASS_LINE.search(ln)):
                ops.append(m[2].split(".")[0])
        alu = sum(op in ALU_OPS for op in ops)
        imad = sum(op == "IMAD" for op in ops)
        c.emit({"sass": label, "per_thread": len(ops), "alu": alu, "imad": imad,
                "elements_per_thread": per, "alu_per_element": alu / per})


def b1_rows(device, built):
    import torch

    from pil2_stark_tpu_torch.ops import cuda_ntt

    lib, regs = built
    vp = ctypes.c_void_p
    lib.one_pass.argtypes = [vp, vp, vp, ctypes.c_longlong, ctypes.c_int, vp]
    lib.one_pass.restype = ctypes.c_int
    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
    tw = cuda_ntt.radix_twiddles(12, False, device)
    for cols in (3, 2, 1):
        lanes = cols << 13
        x = c.random_field((4096, lanes), 200 + cols, device)
        want = cuda_ntt.base_rows_plain(x, 12, False)
        row = {"kernel": "B1", "n": 4096, "lanes": lanes,
               "bound_ms": 2 * 4096 * lanes * 8 / c.HBM_BYTES_PER_S * 1e3,
               "two_passes_ms": c.cuda_ms(lambda: cuda_ntt.base_rows(x, 12, False), 20)}
        if not torch.equal(cuda_ntt.base_rows(x, 12, False), want):
            raise SystemExit("B1 two passes differ from the plain version")
        row["copy_ms"] = c.cuda_ms(lambda: x.clone(), 20)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                cuda_ntt.base_rows(x, 12, False)
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            us = getattr(ev, "device_time_total", 0) or getattr(ev, "cuda_time_total", 0)
            if "base_rows_pass_kernel" in ev.key and us:
                which = "pass1" if ", true, true>" in ev.key else "pass2"
                row[f"{which}_ms"] = us / ev.count / 1e3
        for log_tile in (1, 2):
            out = torch.empty_like(x)

            def run():
                rc = lib.one_pass(x.data_ptr(), tw.data_ptr(), out.data_ptr(), lanes, log_tile,
                                  stream)
                if rc:
                    raise SystemExit(f"one_pass launch failed: CUDA error {rc}")

            run()
            if not torch.equal(out, want):
                raise SystemExit(f"B1 one pass, {1 << log_tile}-lane tiles, differs")
            row[f"one_pass_tile{1 << log_tile}_ms"] = c.cuda_ms(run, 20)
        row["one_pass_ptxas"] = regs
        c.emit(row)
        del x, want, out
        torch.cuda.empty_cache()


def t2_sources():
    """csrc/tac.cu with kBatch set to each measured value."""
    from pil2_stark_tpu_torch.utils import cuda_build

    source = (cuda_build.CSRC / "tac.cu").read_text()
    if T2_BATCH_LINE not in source:
        raise SystemExit(f"csrc/tac.cu no longer has '{T2_BATCH_LINE}'")
    return {batch: source.replace(T2_BATCH_LINE, f"constexpr int kBatch = {batch};")
            for batch in (8, 12, 16, 32)}


def t2_rows(device, built):
    import numpy as np
    import torch

    from pil2_stark_tpu_torch.field import torch_gl as gl
    from pil2_stark_tpu_torch.ops import cuda_tac
    from pil2_stark_tpu_torch.stark import device as stark_device

    libs = {}
    for batch, (lib, regs) in built.items():
        lib.gl_xdiv.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                ctypes.c_longlong, ctypes.c_void_p]
        lib.gl_xdiv.restype = ctypes.c_int
        libs[batch] = (lib, [r for r in regs if r[0] == "xdiv_kernel<2>"])
    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
    for bits in (22, 25):
        n = 1 << bits
        x = c.random_field((n,), 400 + bits, device)
        xis = [tuple(int(v) for v in np.random.default_rng(410 + o).integers(0, c.P, 3,
                                                                             dtype=np.uint64))
               for o in range(2)]
        want = stark_device.compute_xdiv_plain(x, xis)
        words = []
        for xi in xis:
            xi3, b1, c2, c1, c0 = cuda_tac.xdiv_coefficients(xi)
            words += [*xi3, *b1, c2, c1, c0]
        coefs = (ctypes.c_longlong * len(words))(*[gl.i64(v) for v in words])
        out = torch.empty((2, 3, n), dtype=torch.int64, device=device)
        row = {"kernel": "T2", "n": n, "openings": 2,
               "bound_ms": 7 * n * 8 / c.HBM_BYTES_PER_S * 1e3}
        for batch, (lib, regs) in libs.items():
            def run():
                rc = lib.gl_xdiv(x.data_ptr(), ctypes.cast(coefs, ctypes.c_void_p), 2,
                                 out.data_ptr(), n, stream)
                if rc:
                    raise SystemExit(f"gl_xdiv launch failed: CUDA error {rc}")

            out.zero_()
            run()
            if not torch.equal(out, want):
                raise SystemExit(f"T2 with kBatch {batch} differs from the plain version")
            row[f"batch{batch}_ms"] = c.cuda_ms(run, 20 if bits <= 22 else 5)
            row[f"batch{batch}_ptxas"] = regs
        c.emit(row)
        del x, want, out
        torch.cuda.empty_cache()


def main():
    import torch

    if not torch.cuda.is_available():
        print("kernel_designs.py needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    built = _build({"one_pass": ONE_PASS, **{f"t2_{k}": v for k, v in t2_sources().items()}})
    sass_rows()
    b1_rows(device, built["one_pass"])
    t2_rows(device, {int(k[3:]): v for k, v in built.items() if k.startswith("t2_")})
    print(c.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
