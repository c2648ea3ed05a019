#!/usr/bin/env python3
"""Designs measured beside the kept kernels B1, B2 and T2, on one card.

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
* B2 (``cuda_ntt.level_planar``) and B3 (``cuda_ntt.base_grid``) at the
  planar transforms of both proves (chip_smoke.PLANAR_SHAPES): each
  pass's own time (``torch.profiler``) beside a copy of the same bytes;
  and B2's last pass built with 2, 8 and 16 consecutive oa per block
  (kLevelOa; kept: 4) and with the level twiddle read from the table for
  every NB or formed in registers, v[ob]·t·s^ob from two words of the
  table (t = w_N^(oa·i2), s = w_N^(NA·i2)), for every NB (kept: formed
  up to NB = 16, read above), each launched through the same call as the
  kept kernel, which is timed before and after them.
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


def b2_sources():
    """csrc/ntt.cu with B2's last pass changed: kLevelOa 2, 8 and 16; the
    level twiddle read from the table for every NB (kLevelChainLog 0) or
    formed in registers for every NB (6)."""
    from pil2_stark_tpu_torch.ops import cuda_ntt
    from pil2_stark_tpu_torch.utils import cuda_build

    source = (cuda_build.CSRC / "ntt.cu").read_text()
    oa_line = f"constexpr int kLevelOa = {cuda_ntt.LEVEL_OA};"
    chain_line = f"constexpr int kLevelChainLog = {cuda_ntt.LEVEL_CHAIN_LOG};"
    for line in (oa_line, chain_line):
        if line not in source:
            raise SystemExit(f"csrc/ntt.cu no longer has {line!r}")
    out = {f"oa{ta}": source.replace(oa_line, f"constexpr int kLevelOa = {ta};")
           for ta in (2, 4, 8, 16) if ta != cuda_ntt.LEVEL_OA}
    out.update({name: source.replace(chain_line, f"constexpr int kLevelChainLog = {log};")
                for name, log in (("table", 0), ("chain", 6))})
    return out


def _pass_times(prof, names):
    """{kernel name: ms per launch} from a torch.profiler run."""
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0) or getattr(ev, "cuda_time_total", 0)
        for key, pattern in names.items():
            if pattern(ev.key) and us:
                out[key] = out.get(key, 0.0) + us / ev.count / 1e3
    return out


def b2_b3_rows(device, built):
    import torch

    from pil2_stark_tpu_torch.ops import cuda_ntt, ntt
    from pil2_stark_tpu_torch.utils import cuda_build

    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for lib, _ in built.values():
        lib.gl_level_planar.argtypes = [vp, vp, vp, vp, vp, ci, ci, cl, ci, vp]
        lib.gl_level_planar.restype = ci
    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
    for (bits, inverse), cols in zip(c.PLANAR_SHAPES, (15, 15, 3)):
        n = 1 << bits
        bits1 = ntt.split_bits(bits)
        n1, n2 = 1 << bits1, n >> bits1
        x = c.random_field((cols, n), 100 + bits + cols, device)
        lt = ntt.level_twiddles(bits, bits1, inverse, device)
        want = cuda_ntt.level_planar_plain(x, bits1, n2, cols, lt, inverse)
        row = {"kernel": "B2/B3", "cols": cols, "n": n, "inverse": inverse,
               "copy_ms": c.cuda_ms(lambda: x.clone(), 20),
               "b2_ms": c.cuda_ms(lambda: cuda_ntt.level_planar(x, bits1, n2, cols, lt, inverse),
                                  20)}
        y = cuda_ntt.level_planar(x, bits1, n2, cols, lt, inverse)
        if not torch.equal(y, want):
            raise SystemExit("B2 differs from the plain version")
        row["b3_ms"] = c.cuda_ms(lambda: cuda_ntt.base_grid(y, bits - bits1, cols, inverse), 20)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                cuda_ntt.level_planar(x, bits1, n2, cols, lt, inverse)
                cuda_ntt.base_grid(y, bits - bits1, cols, inverse)
            torch.cuda.synchronize()
        row.update(_pass_times(prof, {
            "b2_pass1_ms": lambda k: "base_rows_pass_kernel" in k and f"<{bits1 - bits1 // 2}," in k,
            "b2_pass2_ms": lambda k: "level_pass_kernel" in k,
            "b3_pass1_ms": lambda k: "base_rows_pass_kernel<6" in k and "true, true>" in k,
            "b3_pass2_ms": lambda k: "base_rows_pass_kernel<6" in k and "false, false>" in k}))
        # the kept kernel through the same call as the variants, before and
        # after them (the wrapper allocates its output and scratch per call)
        scratch, out = torch.empty_like(x), torch.empty_like(y)
        tw = cuda_ntt.radix_twiddles(bits1, inverse, device)
        kept = (cuda_ntt._lib(), [e[:4] for e in c.ptxas_summary(cuda_build.build_log("ntt"))])
        for name, (lib, regs) in [("kept", kept), *built.items(), ("kept_again", kept)]:
            def run():
                rc = lib.gl_level_planar(x.data_ptr(), tw.data_ptr(), lt.data_ptr(),
                                         scratch.data_ptr(), out.data_ptr(), bits1,
                                         n2.bit_length() - 1, cols, int(inverse), stream)
                if rc:
                    raise SystemExit(f"B2 {name}: CUDA error {rc}")

            out.zero_()
            run()
            if not torch.equal(out, want):
                raise SystemExit(f"B2 {name} differs from the plain version")
            row[f"b2_{name}_ms"] = c.cuda_ms(run, 20)
            row[f"b2_{name}_ptxas"] = [r for r in regs if r[0].startswith(
                f"level_pass<{bits1 // 2},") and f"inv={int(inverse)}" in r[0]]
        c.emit(row)
        del x, y, want, scratch, out
        torch.cuda.empty_cache()


def main():
    import torch

    if not torch.cuda.is_available():
        print("kernel_designs.py needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    built = _build({"one_pass": ONE_PASS, **{f"t2_{k}": v for k, v in t2_sources().items()},
                    **{f"b2_{k}": v for k, v in b2_sources().items()}})
    sass_rows()
    b2_b3_rows(device, {k[3:]: v for k, v in built.items() if k.startswith("b2_")})
    b1_rows(device, built["one_pass"])
    t2_rows(device, {int(k[3:]): v for k, v in built.items() if k.startswith("t2_")})
    print(c.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
