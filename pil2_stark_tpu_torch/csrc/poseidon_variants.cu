// The Poseidon experiment variants over a planar batch: kernel X2.
//
// Replaces the Pallas kernel family of tools/exp_poseidon.py (build :431 ->
// pallas_call :463, body make_kernel :315).  One kernel, templated on the
// flags that build() parses from the variant's name (:432-445):
//   SQ     x^7 with dedicated squarings (three 32-bit mul.wide per square,
//          gl_lazy.cuh) unless the name says `nosq`;
//   LAZY   any-u64 representatives between operations, one canon at exit;
//   NS     2 for `dual`: each thread carries two independent states;
//   PROBE  `nomxu`, `nops` or `nofs`, the ceiling probes (poseidon_perm.cuh).
// `p4x` and `psl` choose the TPU's vector-register layout of the partial
// round's S-box on element 0; with one thread per state there is no such
// layout, so they run the base schedule.  A probe on lazy representatives
// would give an output that depends on the implementation's
// representatives, and two probes at once have no JAX counterpart that the
// tool runs: the wrapper refuses both, so they are not instantiated.
//
// Layout: planar (12, batch) u64, batch = n_blocks · block.  CTA c owns the
// `block` states [c·block, (c+1)·block), as a grid step of the Pallas
// kernel does; it runs min(256, block / NS) threads.  With NS = 1 thread t
// permutes states t, t + blockDim.x, ... of its CTA's block in turn; with
// NS = 2 it carries state i from each half of the block (i and
// block/2 + i, as _dualize splits the lanes) for i = t, t + blockDim.x, ...
// A warp's loads and stores of one row are 32 adjacent words.
//
// Bound on the H100: integer multiplies, as B4 (poseidon.cu); each probe
// drops the multiplies it skips, SQ saves one partial product per square.
#include <cuda_runtime.h>
#include <cstdint>

#include "poseidon_perm.cuh"

namespace {

constexpr int kThreads = 256;
using poseidon::T;

template <bool SQ, bool LAZY, int PROBE, int NS>
__global__ void __launch_bounds__(kThreads)
variant_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
               long long batch, int block) {
  const int half = block / NS;
  const long long base = (long long)blockIdx.x * block;
#pragma unroll 1
  for (int i = threadIdx.x; i < half; i += blockDim.x) {
    uint64_t s[NS][T];
#pragma unroll
    for (int k = 0; k < T; ++k)
#pragma unroll
      for (int n = 0; n < NS; ++n) s[n][k] = in[k * batch + base + n * half + i];
    poseidon::permute<poseidon::VariantOps<SQ, LAZY>, PROBE>(s);
#pragma unroll
    for (int k = 0; k < T; ++k)
#pragma unroll
      for (int n = 0; n < NS; ++n) out[k * batch + base + n * half + i] = s[n][k];
  }
}

using Launch = int (*)(const void*, void*, long long, int, cudaStream_t);

template <bool SQ, bool LAZY, int PROBE, int NS>
int launch(const void* in, void* out, long long batch, int block, cudaStream_t stream) {
  const int threads = block / NS < kThreads ? block / NS : kThreads;
  variant_kernel<SQ, LAZY, PROBE, NS><<<(unsigned)(batch / block), threads, 0, stream>>>(
      (const uint64_t*)in, (uint64_t*)out, batch, block);
  return (int)cudaGetLastError();
}

// One nvcc over all 20 instantiations takes minutes, so the source is
// built eight times (utils/cuda_build.py SPLITS), each with one choice of
// X2_SQ and X2_NS, and with X2_PROBES 0 (the permutation, plain and lazy)
// or 1 (the three probes).
#ifndef X2_SQ
#define X2_SQ 1
#endif
#ifndef X2_NS
#define X2_NS 1
#endif
#ifndef X2_PROBES
#define X2_PROBES 0
#endif

// mode: 0 the permutation, 1 nomxu, 2 nops, 3 nofs, 4 lazy
template <bool SQ, int NS>
Launch pick(int mode) {
#if X2_PROBES
  switch (mode) {
    case 1: return launch<SQ, false, poseidon::kNoMxu, NS>;
    case 2: return launch<SQ, false, poseidon::kNoPs, NS>;
    case 3: return launch<SQ, false, poseidon::kNoFs, NS>;
    default: return nullptr;
  }
#else
  switch (mode) {
    case 0: return launch<SQ, false, poseidon::kNone, NS>;
    case 4: return launch<SQ, true, poseidon::kNone, NS>;
    default: return nullptr;
  }
#endif
}

}  // namespace

// in/out: (12, batch) u64 on the card, batch a multiple of block, block even
// when dual.  sq and dual must be this library's X2_SQ and X2_NS == 2.
// Returns the CUDA error of the launch, or -1 for a mode or flags this
// library does not hold.
extern "C" int poseidon_variant(const void* in, void* out, long long batch, int block,
                                int sq, int dual, int mode, void* stream) {
  if (sq != X2_SQ || dual != (X2_NS == 2)) return -1;
  const Launch f = pick<X2_SQ == 1, X2_NS>(mode);
  if (f == nullptr) return -1;
  if (batch <= 0) return 0;
  return f(in, out, batch, block, (cudaStream_t)stream);
}
