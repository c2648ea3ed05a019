// Host build of csrc/ntt.cu (tests/test_torch_ntt_planar.py): every kernel
// runs on the CPU, the blocks of a launch one after another and the threads
// of a block as std::threads that meet at a std::barrier for
// __syncthreads.  The test rewrites each `kernel<<<grid, block, smem,
// stream>>>(args)` into emu_launch(grid, block, smem, stream, [&] {
// kernel(args); }) and the dynamic shared array into emu_smem; static
// __shared__ arrays become function statics, which the threads of the one
// block running share.  __umul64hi is the high word of a 128-bit product
// and __ldg a plain load, as in tests/tac_host_shim.h.
#pragma once
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <functional>
#include <thread>
#include <vector>

#define __device__
#define __host__
#define __forceinline__ inline
#define __global__
#define __shared__ static
#define __restrict__
#define __launch_bounds__(...)

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 blockIdx, threadIdx;
inline std::barrier<>* emu_barrier;
inline std::vector<uint64_t> emu_smem;
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }

static inline uint64_t __umul64hi(uint64_t a, uint64_t b) {
  return (uint64_t)(((unsigned __int128)a * b) >> 64);
}
template <class T>
static inline T __ldg(const T* p) { return *p; }

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
inline cudaError_t emu_error = cudaSuccess;
inline cudaError_t cudaGetLastError() {
  const cudaError_t e = emu_error;
  emu_error = cudaSuccess;
  return e;
}
template <class T>
cudaError_t cudaFuncSetAttribute(T*, cudaFuncAttribute, int bytes) {
  return bytes > 232448 ? cudaErrorInvalidValue : cudaSuccess;  // the H100's 227 KB
}
inline long emu_launches = 0;

// The launch configuration's limits as the card checks them, then every
// block; the dynamic shared array is filled with a pattern no kernel
// writes, so a read of a word no thread stored shows.
inline void emu_launch(dim3 grid, dim3 block, size_t smem, cudaStream_t,
                       const std::function<void()>& kernel) {
  if (block.x > 1024 || grid.y > 65535 || grid.z > 65535 || smem > 232448) {
    emu_error = cudaErrorInvalidConfiguration;
    return;
  }
  ++emu_launches;
  emu_smem.assign(smem / sizeof(uint64_t) + 1, 0xDEADBEEFDEADBEEFull);
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        std::barrier<> barrier(block.x);
        emu_barrier = &barrier;
        std::vector<std::thread> threads;
        for (unsigned t = 0; t < block.x; ++t)
          threads.emplace_back([&, t] {
            blockIdx = dim3(x, y, z);
            threadIdx = dim3(t);
            kernel();
          });
        for (auto& th : threads) th.join();
      }
}
