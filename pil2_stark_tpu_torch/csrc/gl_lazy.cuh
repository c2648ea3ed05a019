// Goldilocks helpers that do not canonicalise, and squaring from 32-bit
// halves, for the Poseidon experiment kernel (poseidon_variants.cu).
//
// Counterparts of tools/exp_poseidon.py's _add_lazy, _reduce128_lazy,
// _mul_lazy, _sqr, _sqr_lazy, _pow7_sq and _pow7_lazy (:47-211), and of
// hash/pallas_poseidon.py's _add (:104).  A "lazy" value is any u64
// representative of its residue (x ≡ x mod p, x < 2^64 < 2p); gl::canon
// turns it canonical.  Each helper gives the same bits as its JAX
// counterpart, which works on u32 limb pairs: a wrap of the pair is a wrap
// of the u64.  gl.cuh's canonical operations stay as they are.
#pragma once
#include <cstdint>

#include "gl.cuh"

namespace gl {

// a + b with a carry out of 2^64 folded once as 2^64 ≡ EPS, no canon
// (_add_lazy).  Exact when one operand is below p: the folded sum is then
// below that operand and cannot carry again.
__device__ __forceinline__ uint64_t add_lazy(uint64_t a, uint64_t b) {
  const uint64_t s = a + b;
  return s < a ? s + EPS : s;
}

// a + b for any two u64 representatives, no canon (pallas_poseidon._add):
// the folded EPS can carry past 2^64 once more (then t < EPS), and is
// folded again.  Selects, no branches.
__device__ __forceinline__ uint64_t add_fold(uint64_t a, uint64_t b) {
  const uint64_t s = a + b;
  const uint64_t c = s < a ? EPS : 0;
  const uint64_t t = s + c;
  return t < c ? t + EPS : t;
}

// (hi·2^64 + lo) mod p as a lazy value: gl::reduce128 without its canon.
__device__ __forceinline__ uint64_t reduce128_lazy(uint64_t lo, uint64_t hi) {
  const uint64_t hh = hi >> 32;
  const uint64_t hl = hi & EPS;
  uint64_t t0 = lo - hh;
  if (lo < hh) t0 -= EPS;
  const uint64_t t1 = hl * EPS;
  uint64_t r = t0 + t1;
  if (r < t0) r += EPS;
  return r;
}

__device__ __forceinline__ uint64_t mul_lazy(uint64_t a, uint64_t b) {
  return reduce128_lazy(a * b, __umul64hi(a, b));
}

// a^2 as a 128-bit (lo, hi) from three 32x32 -> 64 products (mul.wide.u32):
// the cross product al·ah appears twice in a^2 and is computed once, so a
// squaring costs three of the four partial products of a general multiply.
//   a^2 = ah^2·2^64 + al·ah·2^33 + al^2
__device__ __forceinline__ void sqr_wide(uint64_t a, uint64_t& lo, uint64_t& hi) {
  const uint32_t al = (uint32_t)a;
  const uint32_t ah = (uint32_t)(a >> 32);
  const uint64_t ll = (uint64_t)al * al;
  const uint64_t hh = (uint64_t)ah * ah;
  const uint64_t m = (uint64_t)al * ah;
  lo = ll + (m << 33);
  hi = hh + (m >> 31) + (lo < ll ? 1 : 0);
}

__device__ __forceinline__ uint64_t sqr(uint64_t a) {
  uint64_t lo, hi;
  sqr_wide(a, lo, hi);
  return reduce128(lo, hi);
}

__device__ __forceinline__ uint64_t sqr_lazy(uint64_t a) {
  uint64_t lo, hi;
  sqr_wide(a, lo, hi);
  return reduce128_lazy(lo, hi);
}

// x^7 with dedicated squarings, canonical (_pow7_sq).
__device__ __forceinline__ uint64_t pow7_sq(uint64_t x) {
  const uint64_t x2 = sqr(x);
  const uint64_t x3 = mul(x2, x);
  const uint64_t x4 = sqr(x2);
  return mul(x4, x3);
}

// x^7 with dedicated squarings, lazy (_pow7_lazy).
__device__ __forceinline__ uint64_t pow7_lazy(uint64_t x) {
  const uint64_t x2 = sqr_lazy(x);
  const uint64_t x3 = mul_lazy(x2, x);
  const uint64_t x4 = sqr_lazy(x2);
  return mul_lazy(x4, x3);
}

}  // namespace gl
