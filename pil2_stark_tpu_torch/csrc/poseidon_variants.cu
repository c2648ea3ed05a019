// The Poseidon experiment variants over a planar batch: kernel X2.
//
// Replaces the Pallas kernel family of tools/exp_poseidon.py (build :431 ->
// pallas_call :463, body make_kernel :315).  One kernel, templated on the
// flags that build() parses from the variant's name (:432-445), each an
// instance of B4's schedule (poseidon_fast.cuh Schedule), so that the
// variants and probes measure the schedule every prove runs:
//   LAZY   the schedule as B4 runs it; without it every reduction is
//          followed by gl::canon (what canonical values cost);
//   SQ     x^2 and x^4 of each S-box from three 32-bit partial products
//          unless the name says `nosq` (B4 uses the general multiply);
//   NS     2 for `dual`: each thread carries two independent states,
//          interleaved step by step;
//   PROBE  `nomxu`, `nops` or `nofs`, the ceiling probes.  nops and nofs
//          drop whole S-boxes, a function of the residues; nomxu flips bit
//          0 of the representative the plain version holds (a canonical
//          S-box output plus its round constant, folded once), so its
//          output equals exp_poseidon.permute_variant_plain word for word.
// `packed-nosq-lazy` is B4's schedule on one state: the control, which
// should time as B4 does.  `p4x` and `psl` choose the TPU's vector-register
// layout of the partial round's S-box on element 0; with one thread per
// state there is no such layout, so they run the base schedule.  A probe
// on lazy representatives would give an output that depends on the
// implementation's representatives, and two probes at once have no JAX
// counterpart that the tool runs: the wrapper refuses both, so they are
// not instantiated.
//
// `packed` on the TPU put every matrix product on the MXU through 7-bit
// limbs and a quantised 128x128 int8 matrix (tools/exp_poseidon.py:217-303).
// On the card that arithmetic does not pay: one permutation has 30 such
// products (7 by M, 1 by P, 22 partial rounds), 491,520 int8 multiply-adds;
// at the data sheet's 1,979 dense int8 TOPS (989.5e12 multiply-adds/s),
// 2^22 permutations would take 2.08 ms before any limb is extracted, above
// B4's whole operations bound of 1.629 ms.  So `packed` stays the integer
// pipe's dot product here.
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
// One state per thread takes B4's launch bound (2 CTAs of 256 per SM, at
// most 128 registers); two take one CTA per SM, so that their 24 live
// state words need not spill.
#include <cuda_runtime.h>
#include <cstdint>

#include "poseidon_fast.cuh"

namespace {

constexpr int kThreads = 256;
using poseidon::T;

template <bool SQ, bool LAZY, int PROBE, int NS>
__global__ void __launch_bounds__(kThreads, NS == 1 ? 2 : 1)
variant_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
               long long batch, int block) {
  using S = poseidon_fast::Schedule<!LAZY, SQ, PROBE>;
  const int half = block / NS;
  const long long base = (long long)blockIdx.x * block;
#pragma unroll 1
  for (int i = threadIdx.x; i < half; i += blockDim.x) {
    uint64_t s[NS][T];
#pragma unroll
    for (int k = 0; k < T; ++k)
#pragma unroll
      for (int n = 0; n < NS; ++n) s[n][k] = in[k * batch + base + n * half + i];
    poseidon_fast::permute<S>(s);
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
// X2_SQ and X2_NS, and with X2_PROBES 0 (the permutation, canonical and
// lazy) or 1 (the three probes).
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
