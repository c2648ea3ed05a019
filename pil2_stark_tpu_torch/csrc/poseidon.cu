// Width-12 Poseidon-GL permutation over a planar batch.
//
// Replaces the Pallas kernel of pil2_stark_tpu/hash/pallas_poseidon.py
// (_permute_combined :433 -> _pallas_permute :404, body _kernel :320),
// "B4".  Same schedule as hash/poseidon_gl.py: constant add; 4 full rounds
// (x^7 on all 12 elements, the 4th ending in the bridge matrix P instead of
// M); 22 partial rounds (x^7 on element 0, then the sparse matrix S_r);
// 4 full rounds with the MDS matrix M.  Output is canonical.
//
// Layout: planar (12, B) u64, one thread per state, the 12 elements in
// registers; loads and stores are coalesced (thread i reads column i of
// every row).  Round constants and the M, P, S matrices sit in __constant__
// memory: every thread of a warp reads the same entry at the same time, so
// the constant cache broadcasts it.
//
// Bound on the H100: integer multiplies.  One permutation does 1,122 GL
// multiplies (8·12·4 x^7 in the full rounds, 22·4 in the partial rounds,
// 144 for P, 22·23 for the S_r) — each a 64x64->128-bit product plus the
// reduction — while it moves only 192 bytes.  M has entries below 2^6, so
// its product runs as 32-bit-half multiply-accumulates with one reduction
// per output instead of 12 GL multiplies.
#include <cuda_runtime.h>
#include <cstdint>

#include "gl.cuh"
#include "poseidon_constants.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int T = 12;
constexpr int HALF_F = 4;
constexpr int RP = 22;

// out_i = Σ_j s_j · M[j][i] with M[j][i] < 2^32: accumulate the 32-bit
// halves of s_j separately (each sum < 2^42), reduce once.
__device__ __forceinline__ void mds_small(uint64_t s[T]) {
  uint64_t o[T];
#pragma unroll
  for (int i = 0; i < T; ++i) {
    uint64_t acc_lo = 0, acc_hi = 0;
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const uint64_t m = POSEIDON_M[j * T + i];
      acc_lo += (s[j] & gl::EPS) * m;
      acc_hi += (s[j] >> 32) * m;
    }
    const uint64_t lo = acc_lo + (acc_hi << 32);
    const uint64_t hi = (acc_hi >> 32) + (lo < acc_lo ? 1 : 0);
    o[i] = gl::reduce128(lo, hi);
  }
#pragma unroll
  for (int i = 0; i < T; ++i) s[i] = o[i];
}

__device__ __forceinline__ void mat_full(uint64_t s[T], const uint64_t* mat) {
  uint64_t o[T];
#pragma unroll
  for (int i = 0; i < T; ++i) {
    uint64_t acc = 0;
#pragma unroll
    for (int j = 0; j < T; ++j) acc = gl::add(acc, gl::mul(s[j], mat[j * T + i]));
    o[i] = acc;
  }
#pragma unroll
  for (int i = 0; i < T; ++i) s[i] = o[i];
}

__device__ __forceinline__ void full_round(uint64_t s[T], int c_off) {
#pragma unroll
  for (int i = 0; i < T; ++i) s[i] = gl::add(gl::pow7(s[i]), POSEIDON_C[c_off + i]);
  mds_small(s);
}

__global__ void __launch_bounds__(kThreads)
poseidon_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                long long batch) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  uint64_t s[T];
#pragma unroll
  for (int i = 0; i < T; ++i) s[i] = gl::add(gl::canon(in[i * batch + b]), POSEIDON_C[i]);

#pragma unroll 1
  for (int r = 0; r < HALF_F - 1; ++r) full_round(s, (r + 1) * T);
#pragma unroll
  for (int i = 0; i < T; ++i)
    s[i] = gl::add(gl::pow7(s[i]), POSEIDON_C[HALF_F * T + i]);
  mat_full(s, POSEIDON_P);

#pragma unroll 1
  for (int r = 0; r < RP; ++r) {
    const uint64_t* srow = POSEIDON_S + (2 * T - 1) * r;
    const uint64_t s0 = gl::add(gl::pow7(s[0]), POSEIDON_C[(HALF_F + 1) * T + r]);
    s[0] = s0;
    uint64_t new0 = 0;
#pragma unroll
    for (int j = 0; j < T; ++j) new0 = gl::add(new0, gl::mul(s[j], srow[j]));
#pragma unroll
    for (int k = 1; k < T; ++k) s[k] = gl::add(s[k], gl::mul(s0, srow[T + k - 1]));
    s[0] = new0;
  }

  const int base = (HALF_F + 1) * T + RP;
#pragma unroll 1
  for (int r = 0; r < HALF_F - 1; ++r) full_round(s, base + r * T);
#pragma unroll
  for (int i = 0; i < T; ++i) s[i] = gl::pow7(s[i]);
  mds_small(s);

#pragma unroll
  for (int i = 0; i < T; ++i) out[i * batch + b] = s[i];
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
