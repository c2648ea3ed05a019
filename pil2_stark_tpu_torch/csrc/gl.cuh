// Goldilocks field (p = 2^64 - 2^32 + 1) on native 64-bit integers.
//
// Shared by ntt.cu and poseidon.cu.  Every function takes canonical
// operands (< p) and returns a canonical result, so kernels need no
// separate canonicalization pass at exit.  The 128-bit product comes from
// the native 64-bit multiply and __umul64hi; it reduces with
// 2^64 = 2^32 - 1 and 2^96 = -1 (mod p).
#pragma once
#include <cstdint>

namespace gl {

constexpr uint64_t P = 0xFFFFFFFF00000001ull;
constexpr uint64_t EPS = 0xFFFFFFFFull;  // 2^64 mod p

__device__ __forceinline__ uint64_t canon(uint64_t a) {
  return a >= P ? a - P : a;
}

__device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  // carry out of 2^64, or s >= p: the true sum is < 2p, subtract p once
  return (s < a || s >= P) ? s - P : s;
}

__device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) {
  uint64_t d = a - b;
  return a < b ? d + P : d;
}

__device__ __forceinline__ uint64_t reduce128(uint64_t lo, uint64_t hi) {
  uint64_t hh = hi >> 32;
  uint64_t hl = hi & EPS;
  uint64_t t0 = lo - hh;
  if (lo < hh) t0 -= EPS;
  uint64_t t1 = hl * EPS;
  uint64_t r = t0 + t1;
  if (r < t0) r += EPS;
  return canon(r);
}

__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
  return reduce128(a * b, __umul64hi(a, b));
}

__device__ __forceinline__ uint64_t pow7(uint64_t x) {
  uint64_t x2 = mul(x, x);
  uint64_t x3 = mul(x2, x);
  uint64_t x4 = mul(x2, x2);
  return mul(x4, x3);
}

}  // namespace gl
