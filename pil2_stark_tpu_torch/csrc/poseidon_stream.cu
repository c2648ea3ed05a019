// Poseidon-GL permutation streamed through a persistent grid, its input
// brought in by Hopper's bulk-copy engine: kernel X1.
//
// Replaces the Pallas kernel of tools/exp_stream.py (build_stream :108 ->
// pallas_call :120, body _make_stream_kernel :55), which runs B4's body on
// tiles of 2048 states in one grid step while a hand-rolled pair of DMA
// buffers streams the next tile in and the last one out (:55-104).  The
// question it asks, whether overlapping the next tile's copies with this
// one's permutation pays, is asked here of B4's schedule
// (poseidon_fast.cuh B4Schedule: any u64 in, canonical out, so nothing is
// canonicalised on load) and of the card's copy engine.
//
// Design.  A persistent grid of one CTA of 512 threads per SM, each
// walking the 2048-state tiles tile = cta, cta + grid, ...  A tile streams
// as steps of 512 states (one state a thread), each a (12, 512) u64 stage
// in shared memory (48 KiB), through a ring of 3 stages.  Thread 0 fills a
// stage with 12 one-dimensional bulk copies, one row each (cp.async.bulk
// ... mbarrier::complete_tx::bytes; rows start at multiples of 512 words,
// so they are 16-byte aligned), completing on the stage's `full` mbarrier,
// armed with the stage's bytes (arrive.expect_tx): no other thread spends
// a register or an instruction on a copy.  Each warp, once it has read its
// columns, arrives on the stage's `empty` mbarrier, and at the start of
// step s thread 0 refills the slot of step s-1 with step s-1+ring once
// every warp has arrived: the copy runs while the CTA permutes.  A CTA
// barrier at the start of each step starts every warp's permutation
// together: warps that drift apart in the permutation's 160 KB of code ran
// 1.2–1.6× B4's time on the H100, and the barrier brings a CTA of 512 to
// B4's.  Output leaves by coalesced stores from registers (a warp writes
// 32 adjacent words of each row).  The permutation keeps B4's register
// budget (at most 128 registers: one CTA of 512 per SM).  Rings of 2 and
// 4 stages, two CTAs of 256 or one of 256 per SM, and bulk stores through
// a shared stage timed the same or slower (PERF.md §6).
//
// Bound on the H100: integer multiplies, as B4: 192 bytes move per
// permutation against 1,122 GL multiplies, so overlapping the copies can
// hide at most the load latency that B4 leaves exposed.
#include <cuda_runtime.h>
#include <cstdint>

#include "poseidon_fast.cuh"

namespace {

constexpr int kTile = 2048;    // states per tile (exp_stream.py's BLK)
constexpr int kThreads = 512;  // a CTA's threads: the states of one step
constexpr int kRing = 3;       // shared stages in the ring
using poseidon::T;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile("{\n\t.reg .pred p;\n\t"
               "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
               "selp.u32 %0, 1, 0, p;\n\t}"
               : "=r"(done)
               : "r"(smem_u32(bar)), "r"(parity)
               : "memory");
  return done != 0;
}

// Until the phase of parity `parity` has completed.  A wait of more than
// about ten seconds (a copy that never lands) traps: the launch fails
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__global__ void __launch_bounds__(kThreads, 1)
stream_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out, long long batch) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kStepsPerTile = kTile / kThreads;
  constexpr int kRowBytes = kThreads * 8;
  // kRing stages of (T, kThreads) words
  extern __shared__ __align__(128) uint64_t smem[];
  __shared__ __align__(8) uint64_t full[kRing], empty[kRing];
  const int tid = threadIdx.x;
  const long long n_tiles = batch / kTile;
  const long long my_tiles =
      blockIdx.x < n_tiles ? (n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  const long long n_steps = my_tiles * kStepsPerTile;
  // first column of this CTA's step st
  auto col0 = [&](long long st) {
    return (blockIdx.x + (st / kStepsPerTile) * gridDim.x) * kTile +
           (st % kStepsPerTile) * kThreads;
  };
  auto stage = [&](int slot) { return smem + (long long)slot * T * kThreads; };
  auto issue = [&](long long st, int slot) {  // thread 0
    mbar_expect_tx(&full[slot], T * kRowBytes);
    const long long c0 = col0(st);
#pragma unroll
    for (int i = 0; i < T; ++i)
      bulk_load(stage(slot) + i * kThreads, in + i * batch + c0, kRowBytes, &full[slot]);
  };

  if (tid == 0) {
    for (int r = 0; r < kRing; ++r) {
      mbar_init(&full[r], 1);
      mbar_init(&empty[r], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int r = 0; r < kRing && r < n_steps; ++r) issue(r, r);

#pragma unroll 1
  for (long long st = 0; st < n_steps; ++st) {
    const int slot = (int)(st % kRing);
    if (tid == 0 && st > 0 && st - 1 + kRing < n_steps) {
      const int prev = (int)((st - 1) % kRing);
      mbar_wait(&empty[prev], (uint32_t)(((st - 1) / kRing) & 1));
      issue(st - 1 + kRing, prev);
    }
    __syncthreads();  // every warp starts the step together
    mbar_wait(&full[slot], (uint32_t)((st / kRing) & 1));
    uint64_t s[1][T];
#pragma unroll
    for (int i = 0; i < T; ++i) s[0][i] = stage(slot)[i * kThreads + tid];
    __syncwarp();
    if (tid % 32 == 0) mbar_arrive(&empty[slot]);
    poseidon_fast::permute<poseidon_fast::B4Schedule>(s);
    const long long c = col0(st) + tid;
#pragma unroll
    for (int i = 0; i < T; ++i) out[i * batch + c] = s[0][i];
  }
}

}  // namespace

// in/out: (12, batch) u64 on the card, batch a multiple of 2048, both
// 16-byte aligned.  One CTA on each SM, never more CTAs than tiles.
// Returns the CUDA error of the launch.
extern "C" int poseidon_stream(const void* in, void* out, long long batch, void* stream) {
  if (batch <= 0) return 0;
  constexpr int smem = kRing * T * kThreads * 8;  // 144 KiB
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(stream_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const long long n_tiles = batch / kTile;
  const unsigned grid = (unsigned)(sms < n_tiles ? sms : n_tiles);
  stream_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>((const uint64_t*)in,
                                                                 (uint64_t*)out, batch);
  return (int)cudaGetLastError();
}
