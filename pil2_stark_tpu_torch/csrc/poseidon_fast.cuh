// Kernel B4's schedule of the width-12 Poseidon-GL permutation: lazy
// values, one reduction per dot product, carry-chain arithmetic.
//
// It computes what poseidon_perm.cuh's permute<CanonicalOps> computes (the
// schedule of hash/poseidon_gl.py), with other representatives on the way:
//   - every value between operations is "lazy", any u64 representative of
//     its residue mod p; one gl::canon per element at exit, as the TPU
//     kernel does (hash/pallas_poseidon.py:320-326).  Any u64 input is
//     such a representative, so the input is not canonicalised either.
//   - a dot product of 12 lazy values with full-width constants (each
//     output of the bridge matrix P, element 0 of each partial round) sums
//     its twelve 128-bit products in three words (< 12·2^128 < 2^132) and
//     reduces once (reduce192), instead of reducing and adding each term.
//   - a product plus a value (the S-box's last product plus its round
//     constant, the partial round's rank-1 update s_k + s_0·S_r[k]) adds
//     the value to the 128-bit product and reduces once (mad_reduce),
//     instead of a reduction and a folded add.
//   - the adds of the product chains and of the reductions are PTX carry
//     chains (mad.lo.cc / madc.hi / addc, sub.cc / subc), one asm block per
//     chain: the carry flag does not live from one asm statement to the
//     next.  hl·(2^32 - 1) is (hl << 32) - hl.
// Per permutation that is 34 reductions for the 408 dot-product terms and
// 472 + 242 + 84 for the S-boxes, rank-1 updates and MDS outputs, against
// poseidon_perm.cuh's 1,206 canonical reductions and about 770 canonical
// adds.  hash/cuda_poseidon.py mirrors each helper on python ints
// (mul128, mad_reduce, acc3_mad, reduce192, ...), and tests check them at
// the extremes.
//
// Reductions use 2^64 ≡ 2^32 - 1 (EPS), 2^96 ≡ -1 and 2^128 ≡ -2^32
// (mod p).  A lazy value is < 2^64 < 2p, so every bound below holds for
// any u64 operand.
#pragma once
#include <cstdint>

#include "gl.cuh"
#include "poseidon_constants.cuh"
#include "poseidon_perm.cuh"

namespace poseidon_fast {

using poseidon::HALF_F;
using poseidon::RP;
using poseidon::T;
using gl::EPS;

// (hh·2^96 + hl·2^64 + lo) mod p as a lazy value, hh < 2^36, hl < 2^32:
//   x ≡ lo - hh + hl·EPS.
// lo - hh borrows at most once (then lo - hh + 2^64 > 2^64 - 2^36 > EPS,
// so subtracting EPS cannot borrow again); t0 + hl·EPS carries at most
// once (the wrapped sum is below hl·EPS ≤ 2^64 - 2^33 + 1, so adding EPS
// cannot carry again).  reduce192 passes its third word in hh's upper bits.
__device__ __forceinline__ uint64_t reduce(uint64_t lo, uint64_t hh, uint32_t hl) {
  const uint64_t t1 = ((uint64_t)hl << 32) - hl;
  uint64_t r;
  asm("{\n\t.reg .u64 t0, f;\n\t.reg .u32 e;\n\t"
      "sub.cc.u64 t0, %1, %2;\n\t"
      "subc.u32 e, 0, 0;\n\t"          // e = EPS if lo < hh, else 0
      "cvt.u64.u32 f, e;\n\t"
      "sub.u64 t0, t0, f;\n\t"
      "add.cc.u64 t0, t0, %3;\n\t"
      "addc.u32 e, 0, 0;\n\t"          // carry out of 2^64
      "neg.s32 e, e;\n\t"              // EPS if it carried
      "cvt.u64.u32 f, e;\n\t"
      "add.u64 %0, t0, f;\n\t}"
      : "=l"(r)
      : "l"(lo), "l"(hh), "l"(t1));
  return r;
}

__device__ __forceinline__ uint64_t reduce128(uint64_t lo, uint64_t hi) {
  return reduce(lo, hi >> 32, (uint32_t)hi);
}

// a·b + c as a 128-bit (lo, hi): at most 2^128 - 2^64, so hi never wraps.
__device__ __forceinline__ void mad_wide(uint64_t a, uint64_t b, uint64_t c,
                                         uint64_t& lo, uint64_t& hi) {
  asm("mad.lo.cc.u64 %0, %2, %3, %4;\n\t"
      "madc.hi.u64 %1, %2, %3, 0;"
      : "=&l"(lo), "=l"(hi)
      : "l"(a), "l"(b), "l"(c));
}

// (a·b + c) mod p, lazy, one reduction.
__device__ __forceinline__ uint64_t mad_reduce(uint64_t a, uint64_t b, uint64_t c) {
  uint64_t lo, hi;
  mad_wide(a, b, c, lo, hi);
  return reduce128(lo, hi);
}

__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
  return reduce128(a * b, __umul64hi(a, b));
}

// (x^7 + c) mod p, lazy: the general multiply for x^2 (dedicated squares
// were slower on the card), the constant added to the last product.
__device__ __forceinline__ uint64_t sbox_add(uint64_t x, uint64_t c) {
  const uint64_t x2 = mul(x, x);
  const uint64_t x3 = mul(x2, x);
  const uint64_t x4 = mul(x2, x2);
  return mad_reduce(x4, x3, c);
}

__device__ __forceinline__ uint64_t pow7(uint64_t x) { return sbox_add(x, 0); }

// Three-word accumulator (a0, a1, a2) += a·b.  Twelve terms stay below
// 12·2^128, so a2 < 16.
struct Acc3 {
  uint64_t a0 = 0, a1 = 0;
  uint32_t a2 = 0;
  __device__ __forceinline__ void mad(uint64_t a, uint64_t b) {
    asm("mad.lo.cc.u64 %0, %3, %4, %0;\n\t"
        "madc.hi.cc.u64 %1, %3, %4, %1;\n\t"
        "addc.u32 %2, %2, 0;"
        : "+l"(a0), "+l"(a1), "+r"(a2)
        : "l"(a), "l"(b));
  }
  // (a2·2^128 + a1·2^64 + a0) mod p, lazy: a2·2^128 ≡ -a2·2^32 joins the
  // -hh·2^96 term as hh + a2·2^32 (< 2^36; the two occupy disjoint bits).
  __device__ __forceinline__ uint64_t reduce192() const {
    return reduce(a0, (a1 >> 32) | ((uint64_t)a2 << 32), (uint32_t)a1);
  }
};

// out_i = Σ_j s_j·M[j][i] with M[j][i] < 2^6: the 32-bit halves of s_j
// accumulate separately (each sum < 12·2^38 < 2^42), one reduction per
// output of acc_lo + acc_hi·2^32 < 2^75.  Its high word is below 2^11, so
// it reduces as lo + hi·EPS with one carry fold.
__device__ __forceinline__ void mds_small(uint64_t (&s)[T]) {
  uint64_t o[T];
#pragma unroll
  for (int i = 0; i < T; ++i) {
    uint64_t acc_lo = 0, acc_hi = 0;
#pragma unroll
    for (int j = 0; j < T; ++j) {
      // 32 x 32 -> 64-bit multiply-adds (mad.wide.u32)
      const uint32_t m = (uint32_t)POSEIDON_M[j * T + i];
      acc_lo += (uint64_t)(uint32_t)s[j] * m;
      acc_hi += (uint64_t)(uint32_t)(s[j] >> 32) * m;
    }
    uint64_t r;
    asm("{\n\t.reg .u64 lo, hi, t;\n\t.reg .u32 e;\n\t"
        "shl.b64 t, %2, 32;\n\t"
        "add.cc.u64 lo, %1, t;\n\t"
        "shr.b64 hi, %2, 32;\n\t"
        "addc.u64 hi, hi, 0;\n\t"        // hi < 2^11
        "shl.b64 t, hi, 32;\n\t"
        "sub.u64 t, t, hi;\n\t"          // hi·EPS
        "add.cc.u64 %0, lo, t;\n\t"
        "addc.u32 e, 0, 0;\n\t"
        "neg.s32 e, e;\n\t"
        "cvt.u64.u32 t, e;\n\t"
        "add.u64 %0, %0, t;\n\t}"
        : "=l"(r)
        : "l"(acc_lo), "l"(acc_hi));
    o[i] = r;
  }
#pragma unroll
  for (int i = 0; i < T; ++i) s[i] = o[i];
}

// The bridge matrix P: twelve dot products, one reduction each.
__device__ __forceinline__ void mat_p(uint64_t (&s)[T]) {
  uint64_t o[T];
#pragma unroll
  for (int i = 0; i < T; ++i) {
    Acc3 acc;
#pragma unroll
    for (int j = 0; j < T; ++j) acc.mad(s[j], POSEIDON_P[j * T + i]);
    o[i] = acc.reduce192();
  }
#pragma unroll
  for (int i = 0; i < T; ++i) s[i] = o[i];
}

// x^7 and the round constants c_off.. on all 12 elements.
__device__ __forceinline__ void full_sbox(uint64_t (&s)[T], int c_off) {
#pragma unroll
  for (int i = 0; i < T; ++i) s[i] = sbox_add(s[i], POSEIDON_C[c_off + i]);
}

// One partial round.  The chain from one round's s_0 to the next is the
// S-box, one product and reduce192: the eleven terms of new0 that do not
// depend on the S-box go into the accumulator first (their carry chain
// runs while the S-box does), the S-box's term last.
__device__ __forceinline__ void partial_round(uint64_t (&s)[T], int r) {
  const uint64_t* srow = POSEIDON_S + (2 * T - 1) * r;
  Acc3 acc;
#pragma unroll
  for (int j = 1; j < T; ++j) acc.mad(s[j], srow[j]);
  const uint64_t s0 = sbox_add(s[0], POSEIDON_C[(HALF_F + 1) * T + r]);
  acc.mad(s0, srow[0]);
#pragma unroll
  for (int k = 1; k < T; ++k) s[k] = mad_reduce(s0, srow[T + k - 1], s[k]);
  s[0] = acc.reduce192();
}

// The permutation of one state in registers: any u64 in, canonical out.
__device__ __forceinline__ void permute(uint64_t (&s)[T]) {
#pragma unroll
  for (int i = 0; i < T; ++i) {
    // s + c with c < p carries at most once; the folded sum is below c
    const uint64_t c = POSEIDON_C[i];
    const uint64_t t = s[i] + c;
    s[i] = t < c ? t + EPS : t;
  }

#pragma unroll 1
  for (int r = 0; r < HALF_F - 1; ++r) {
    full_sbox(s, (r + 1) * T);
    mds_small(s);
  }
  full_sbox(s, HALF_F * T);
  mat_p(s);

#pragma unroll 1
  for (int r = 0; r < RP; ++r) partial_round(s, r);

  const int base = (HALF_F + 1) * T + RP;
#pragma unroll 1
  for (int r = 0; r < HALF_F - 1; ++r) {
    full_sbox(s, base + r * T);
    mds_small(s);
  }
#pragma unroll
  for (int i = 0; i < T; ++i) s[i] = pow7(s[i]);
  mds_small(s);
#pragma unroll
  for (int i = 0; i < T; ++i) s[i] = gl::canon(s[i]);
}

}  // namespace poseidon_fast
