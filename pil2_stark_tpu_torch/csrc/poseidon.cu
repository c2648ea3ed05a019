// Width-12 Poseidon-GL permutation over a planar batch.
//
// Replaces the Pallas kernel of pil2_stark_tpu/hash/pallas_poseidon.py
// (_permute_combined :433 -> _pallas_permute :404, body _kernel :320),
// "B4".  The schedule is poseidon_fast.cuh's: lazy values, one reduction
// per dot product, carry chains; any u64 in, canonical out.
//
// Layout: planar (12, B) u64, one thread per state, the 12 elements in
// registers; loads and stores are coalesced (thread i reads column i of
// every row).
//
// Bound on the H100: the integer instruction stream.  One permutation does
// 1,122 64x64->128-bit products (8·12·4 for x^7 in the full rounds, 22·4
// in the partial rounds, 144 for P, 22·23 for the S_r) and 7 products by
// the small MDS matrix M, while it moves only 192 bytes; each product's
// reduction and carries cost more instructions than its multiply-adds.
// The partial rounds are a serial chain per state (S-box -> dot product
// -> next S-box), so the warps an SM holds decide how much of its latency
// is hidden.  The launch bound asks for 2 CTAs of 256 threads per SM:
// that caps a thread at 128 registers (24 B of spill) and holds 16 warps
// per SM; without it ptxas takes 250 registers (8 warps), 21 % slower
// (PERF.md §6).
#include <cuda_runtime.h>
#include <cstdint>

#include "poseidon_fast.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 2;  // CTAs per SM
using poseidon::T;

__global__ void __launch_bounds__(kThreads, kMinBlocks)
poseidon_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                long long batch) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  uint64_t s[1][T];
#pragma unroll
  for (int i = 0; i < T; ++i) s[0][i] = in[i * batch + b];
  poseidon_fast::permute<poseidon_fast::B4Schedule>(s);
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
