// Width-12 Poseidon-GL permutation over a planar batch.
//
// Replaces the Pallas kernel of pil2_stark_tpu/hash/pallas_poseidon.py
// (_permute_combined :433 -> _pallas_permute :404, body _kernel :320),
// "B4".  The schedule is poseidon_perm.cuh's with canonical operations:
// output is canonical.
//
// Layout: planar (12, B) u64, one thread per state, the 12 elements in
// registers; loads and stores are coalesced (thread i reads column i of
// every row).
//
// Bound on the H100: integer multiplies.  One permutation does 1,122 GL
// multiplies (8·12·4 x^7 in the full rounds, 22·4 in the partial rounds,
// 144 for P, 22·23 for the S_r) — each a 64x64->128-bit product plus the
// reduction — while it moves only 192 bytes.  M has entries below 2^6, so
// its product runs as 32-bit-half multiply-accumulates with one reduction
// per output instead of 12 GL multiplies.
#include <cuda_runtime.h>
#include <cstdint>

#include "poseidon_perm.cuh"

namespace {

constexpr int kThreads = 256;
using poseidon::T;

__global__ void __launch_bounds__(kThreads)
poseidon_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                long long batch) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  uint64_t s[1][T];
#pragma unroll
  for (int i = 0; i < T; ++i) s[0][i] = gl::canon(in[i * batch + b]);
  poseidon::permute<poseidon::CanonicalOps, poseidon::kNone>(s);
#pragma unroll
  for (int i = 0; i < T; ++i) out[i * batch + b] = s[0][i];
}

}  // namespace

extern "C" int poseidon_permute(const void* in, void* out, long long batch,
                                void* stream) {
  if (batch <= 0) return 0;
  const long long blocks = (batch + kThreads - 1) / kThreads;
  poseidon_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)in, (uint64_t*)out, batch);
  return (int)cudaGetLastError();
}
