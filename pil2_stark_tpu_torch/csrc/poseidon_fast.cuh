// The width-12 Poseidon-GL permutation of one thread's states, in
// registers: kernel B4's schedule (lazy values, one reduction per dot
// product, carry-chain arithmetic), shared by B4 (poseidon.cu), the
// streaming kernel X1 (poseidon_stream.cu) and the experiment variants X2
// (poseidon_variants.cu).
//
// Schedule of hash/poseidon_gl.py: constant add; 4 full rounds (x^7 on all
// 12 elements, the 4th ending in the bridge matrix P instead of M); 22
// partial rounds (x^7 on element 0, then the sparse matrix S_r); 4 full
// rounds with the MDS matrix M.  Round constants and the M, P, S matrices
// sit in __constant__ memory: every thread of a warp reads the same entry
// at the same time, so the constant cache broadcasts it.
//
// Representatives on the way:
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
// the 1,206 canonical reductions and about 770 canonical adds of the
// schedule before it.  hash/cuda_poseidon.py mirrors each helper on python
// ints (mul128, mad_reduce, acc3_mad, reduce192, ...), and
// tools/exp_poseidon.py the whole template (permute_variant_int).
//
// The schedule is one template, Schedule<CANON, SQ, PROBE>, run on NS
// states per thread by permute<S>(s[NS][T]):
//   CANON  every reduction is followed by gl::canon, so every value is
//          canonical (X2 without `lazy`: what canonical representatives
//          cost);
//   SQ     x^2 and x^4 of each S-box from three 32x32 partial products
//          (sqr_wide) instead of the general multiply;
//   PROBE  a ceiling probe of tools/exp_poseidon.py (:315-427) that drops
//          one part of the work; kNone computes the permutation;
//   NS     states per thread (2 for X2's `dual`), interleaved step by step
//          so that their dependency chains overlap.
// B4 and X1 run Schedule<false, false, kNone> (B4Schedule) on one state.
//
// Reductions use 2^64 ≡ 2^32 - 1 (EPS), 2^96 ≡ -1 and 2^128 ≡ -2^32
// (mod p).  A lazy value is < 2^64 < 2p, so every bound below holds for
// any u64 operand.
#pragma once
#include <cstdint>

#include "gl.cuh"
#include "poseidon_constants.cuh"

namespace poseidon {

constexpr int T = 12;
constexpr int HALF_F = 4;
constexpr int RP = 22;

enum Probe {
  kNone = 0,
  kNoMxu = 1,  // every matrix product (M, P, the partial rounds' S_r) becomes x ^= 1
  kNoPs = 2,   // partial rounds add their constant to element 0 without x^7
  kNoFs = 3,   // full rounds skip x^7; the S-box before the last matrix still runs
};

}  // namespace poseidon

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

// a^2 as a 128-bit (lo, hi) from three 32x32 -> 64 products: the cross
// product al·ah appears twice in a^2 and is computed once.
//   a^2 = ah^2·2^64 + al·ah·2^33 + al^2   (hi < 2^64: a^2 < 2^128)
__device__ __forceinline__ void sqr_wide(uint64_t a, uint64_t& lo, uint64_t& hi) {
  asm("{\n\t.reg .u32 al, ah;\n\t.reg .u64 ll, hh, m, t;\n\t"
      "mov.b64 {al, ah}, %2;\n\t"
      "mul.wide.u32 ll, al, al;\n\t"
      "mul.wide.u32 hh, ah, ah;\n\t"
      "mul.wide.u32 m, al, ah;\n\t"
      "shl.b64 t, m, 33;\n\t"
      "add.cc.u64 %0, ll, t;\n\t"
      "shr.b64 t, m, 31;\n\t"
      "addc.u64 %1, hh, t;\n\t}"
      : "=l"(lo), "=l"(hi)
      : "l"(a));
}

// x + c for c < p, lazy: a carry out of 2^64 folds once as EPS (the folded
// sum is below c, so it cannot carry again).
__device__ __forceinline__ uint64_t add_c(uint64_t x, uint64_t c) {
  const uint64_t t = x + c;
  return t < c ? t + EPS : t;
}

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

// Σ_j s_j·M[j][i] with M[j][i] < 2^6 from its 32-bit halves' sums
// (acc_lo + acc_hi·2^32 < 2^75): its high word is below 2^11, so it
// reduces as lo + hi·EPS with one carry fold.
__device__ __forceinline__ uint64_t fold75(uint64_t acc_lo, uint64_t acc_hi) {
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
  return r;
}

template <bool CANON, bool SQ, int PROBE>
struct Schedule {
  // nomxu flips bit 0 of a representative, so it must flip the very
  // representative the plain version (exp_poseidon.permute_variant_plain)
  // holds: a canonical S-box output plus its round constant, folded once.
  static constexpr bool kFlip = PROBE == poseidon::kNoMxu;
  static constexpr bool kCanonical = CANON;
  static constexpr int kProbe = PROBE;

  // a reduction's result: lazy, or canonical under CANON
  static __device__ __forceinline__ uint64_t out(uint64_t x) {
    if constexpr (CANON) return gl::canon(x);
    else return x;
  }
  static __device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
    return out(poseidon_fast::mul(a, b));
  }
  // the general multiply for x^2 unless SQ (B4: dedicated squares were
  // slower on the card)
  static __device__ __forceinline__ uint64_t sqr(uint64_t a) {
    if constexpr (SQ) {
      uint64_t lo, hi;
      sqr_wide(a, lo, hi);
      return out(reduce128(lo, hi));
    } else {
      return mul(a, a);
    }
  }
  // (x^7 + c) mod p: the constant added to the last product
  static __device__ __forceinline__ uint64_t sbox_add(uint64_t x, uint64_t c) {
    const uint64_t x2 = sqr(x);
    const uint64_t x3 = mul(x2, x);
    const uint64_t x4 = sqr(x2);
    if constexpr (kFlip) return add_c(gl::canon(poseidon_fast::mul(x4, x3)), c);
    else return out(mad_reduce(x4, x3, c));
  }
  // a round constant without its S-box (nops, nofs)
  static __device__ __forceinline__ uint64_t add(uint64_t x, uint64_t c) {
    return out(add_c(x, c));
  }
};

using B4Schedule = Schedule<false, false, poseidon::kNone>;

template <int NS>
__device__ __forceinline__ void flip(uint64_t (&s)[NS][T]) {
#pragma unroll
  for (int i = 0; i < T; ++i)
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][i] ^= 1;
}

// out_i = Σ_j s_j·M[j][i] with M[j][i] < 2^6: the 32-bit halves of s_j
// accumulate separately (each sum < 12·2^38 < 2^42), one reduction per
// output (fold75).
template <class S, int NS>
__device__ __forceinline__ void mds_small(uint64_t (&s)[NS][T]) {
  if constexpr (S::kFlip) {
    flip(s);
  } else {
    uint64_t o[NS][T];
#pragma unroll
    for (int i = 0; i < T; ++i) {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        uint64_t acc_lo = 0, acc_hi = 0;
#pragma unroll
        for (int j = 0; j < T; ++j) {
          // 32 x 32 -> 64-bit multiply-adds (mad.wide.u32)
          const uint32_t m = (uint32_t)POSEIDON_M[j * T + i];
          acc_lo += (uint64_t)(uint32_t)s[n][j] * m;
          acc_hi += (uint64_t)(uint32_t)(s[n][j] >> 32) * m;
        }
        o[n][i] = S::out(fold75(acc_lo, acc_hi));
      }
    }
#pragma unroll
    for (int i = 0; i < T; ++i)
#pragma unroll
      for (int n = 0; n < NS; ++n) s[n][i] = o[n][i];
  }
}

// The bridge matrix P: twelve dot products, one reduction each.
template <class S, int NS>
__device__ __forceinline__ void mat_p(uint64_t (&s)[NS][T]) {
  if constexpr (S::kFlip) {
    flip(s);
  } else {
    uint64_t o[NS][T];
#pragma unroll
    for (int i = 0; i < T; ++i) {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        Acc3 acc;
#pragma unroll
        for (int j = 0; j < T; ++j) acc.mad(s[n][j], POSEIDON_P[j * T + i]);
        o[n][i] = S::out(acc.reduce192());
      }
    }
#pragma unroll
    for (int i = 0; i < T; ++i)
#pragma unroll
      for (int n = 0; n < NS; ++n) s[n][i] = o[n][i];
  }
}

// x^7 (unless nofs drops it) and the round constants c_off.. on all 12
// elements.
template <class S, int NS>
__device__ __forceinline__ void full_sbox(uint64_t (&s)[NS][T], int c_off) {
#pragma unroll
  for (int i = 0; i < T; ++i)
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const uint64_t c = POSEIDON_C[c_off + i];
      if constexpr (S::kProbe == poseidon::kNoFs) s[n][i] = S::add(s[n][i], c);
      else s[n][i] = S::sbox_add(s[n][i], c);
    }
}

// One partial round.  The chain from one round's s_0 to the next is the
// S-box, one product and reduce192: the eleven terms of new0 that do not
// depend on the S-box go into the accumulator first (their carry chain
// runs while the S-box does), the S-box's term last.
template <class S, int NS>
__device__ __forceinline__ void partial_round(uint64_t (&s)[NS][T], int r) {
  const uint64_t c = POSEIDON_C[(HALF_F + 1) * T + r];
  if constexpr (S::kFlip) {
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = S::sbox_add(s[n][0], c);
    flip(s);
  } else {
    const uint64_t* srow = POSEIDON_S + (2 * T - 1) * r;
    Acc3 acc[NS];
#pragma unroll
    for (int j = 1; j < T; ++j)
#pragma unroll
      for (int n = 0; n < NS; ++n) acc[n].mad(s[n][j], srow[j]);
    uint64_t s0[NS];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      if constexpr (S::kProbe == poseidon::kNoPs) s0[n] = S::add(s[n][0], c);
      else s0[n] = S::sbox_add(s[n][0], c);
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) acc[n].mad(s0[n], srow[0]);
#pragma unroll
    for (int k = 1; k < T; ++k)
#pragma unroll
      for (int n = 0; n < NS; ++n) s[n][k] = S::out(mad_reduce(s0[n], srow[T + k - 1], s[n][k]));
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = S::out(acc[n].reduce192());
  }
}

// The permutation of NS states in registers: any u64 in; canonical out,
// but for nomxu, whose output is the plain version's flipped words.
template <class S, int NS>
__device__ __forceinline__ void permute(uint64_t (&s)[NS][T]) {
#pragma unroll
  for (int i = 0; i < T; ++i)
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][i] = S::add(s[n][i], POSEIDON_C[i]);

#pragma unroll 1
  for (int r = 0; r < HALF_F - 1; ++r) {
    full_sbox<S>(s, (r + 1) * T);
    mds_small<S>(s);
  }
  full_sbox<S>(s, HALF_F * T);
  mat_p<S>(s);

#pragma unroll 1
  for (int r = 0; r < RP; ++r) partial_round<S>(s, r);

  const int base = (HALF_F + 1) * T + RP;
#pragma unroll 1
  for (int r = 0; r < HALF_F - 1; ++r) {
    full_sbox<S>(s, base + r * T);
    mds_small<S>(s);
  }
  // the S-box before the last matrix runs under every probe
  // (tools/exp_poseidon.py:419 is not gated by skip_fsbox)
#pragma unroll
  for (int i = 0; i < T; ++i)
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][i] = S::sbox_add(s[n][i], 0);
  mds_small<S>(s);
  if constexpr (!S::kCanonical && !S::kFlip) {
#pragma unroll
    for (int i = 0; i < T; ++i)
#pragma unroll
      for (int n = 0; n < NS; ++n) s[n][i] = gl::canon(s[n][i]);
  }
}

}  // namespace poseidon_fast
