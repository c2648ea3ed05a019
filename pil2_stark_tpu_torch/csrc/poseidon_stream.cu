// Poseidon-GL permutation streamed through a persistent grid with
// double-buffered asynchronous copies: kernel X1.
//
// Replaces the Pallas kernel of tools/exp_stream.py (build_stream :108 ->
// pallas_call :120, body _make_stream_kernel :55), which runs B4's body on
// tiles of 2048 states in one grid step while a hand-rolled pair of DMA
// buffers streams the next tile in and the last one out (:55-104).  The
// permutation is B4's (poseidon_perm.cuh, canonical operations).
//
// Design.  One CTA per SM that fits (B4's 255 registers a thread leave
// room for one 256-thread CTA; the occupancy query decides), each walking
// the 2048-state tiles tile = cta, cta + grid, ...  A tile of 12 × 2048 u64
// is 192 KiB, and two do not fit in the 227 KiB a CTA may hold, so the
// tile streams as 8 stages of 256 states (one state per thread), each
// (12, 256) u64 = 24 KiB.  Stage s+1's copy is issued with 16-byte
// cp.async.cg into one shared buffer (commit/wait groups) while stage s is
// read from the other and permuted in registers: the Hopper counterpart of
// make_async_copy and its DMA semaphores.  The output leaves by coalesced
// stores from registers (a warp writes 32 adjacent words of each row), not
// through shared buffers: a store does not stall the thread that issues it.
//
// Bound on the H100: integer multiplies, as B4: 192 bytes move per
// permutation against 1,122 GL multiplies, so overlapping the copies can
// hide at most the load latency that B4 leaves exposed.
#include <cuda_runtime.h>
#include <cstdint>

#include "poseidon_perm.cuh"

namespace {

constexpr int kThreads = 256;     // = states per stage
constexpr int kTile = 2048;       // states per tile (exp_stream.py's BLK)
constexpr int kStages = kTile / kThreads;
constexpr int kChunks = poseidon::T * kThreads / 2;  // 16-byte chunks per stage
using poseidon::T;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__global__ void __launch_bounds__(kThreads)
stream_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
              long long batch) {
  __shared__ __align__(16) uint64_t buf[2][T][kThreads];
  const long long n_tiles = batch / kTile;
  const long long my_tiles =
      blockIdx.x < n_tiles ? (n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  const long long n_steps = my_tiles * kStages;
  // first column of this CTA's stage st
  auto col0 = [&](long long st) {
    return (blockIdx.x + (st / kStages) * gridDim.x) * kTile + (st % kStages) * kThreads;
  };
  auto issue = [&](long long st, int slot) {
    const long long c0 = col0(st);
    for (int q = threadIdx.x; q < kChunks; q += kThreads) {
      const int row = q / (kThreads / 2);
      const int col = 2 * (q % (kThreads / 2));
      cp_async16(&buf[slot][row][col], in + row * batch + c0 + col);
    }
  };

  if (n_steps > 0) issue(0, 0);
  cp_async_commit();
#pragma unroll 1
  for (long long st = 0; st < n_steps; ++st) {
    const int slot = (int)(st & 1);
    // the other buffer was last read in step st-1, before its second barrier
    if (st + 1 < n_steps) issue(st + 1, slot ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of stage st have landed
    __syncthreads();     // and every thread's
    uint64_t s[1][T];
#pragma unroll
    for (int i = 0; i < T; ++i) s[0][i] = gl::canon(buf[slot][i][threadIdx.x]);
    __syncthreads();     // buffer `slot` is free for step st+1's copy
    poseidon::permute<poseidon::CanonicalOps, poseidon::kNone>(s);
    const long long c = col0(st) + threadIdx.x;
#pragma unroll
    for (int i = 0; i < T; ++i) out[i * batch + c] = s[0][i];
  }
  cp_async_wait<0>();
}

}  // namespace

// in/out: (12, batch) u64 on the card, batch a multiple of 2048, both
// 16-byte aligned.  Returns the CUDA error of the launch.
extern "C" int poseidon_stream(const void* in, void* out, long long batch, void* stream) {
  if (batch <= 0) return 0;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stream_kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const long long n_tiles = batch / kTile;
  long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (grid > n_tiles) grid = n_tiles;
  stream_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)in, (uint64_t*)out, batch);
  return (int)cudaGetLastError();
}
