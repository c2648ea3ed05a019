// Host build of the kernel T1 row bodies that ops/tac_codegen.py generates
// (tests/test_torch_tac_codegen.py): the CUDA qualifiers become plain C++,
// __umul64hi the high word of a 128-bit product, __ldg a plain load.  The
// generated source's device-only part (kernels and launcher) sits under
// __CUDACC__, so g++ compiles only the row functions and their helpers.
#pragma once
#include <cstdint>

#define __device__
#define __forceinline__ inline
#define __constant__

static inline uint64_t __umul64hi(uint64_t a, uint64_t b) {
  return (uint64_t)(((unsigned __int128)a * b) >> 64);
}

static inline unsigned long long __ldg(const unsigned long long* p) { return *p; }
