// The width-12 Poseidon-GL permutation of one thread's states, in
// registers.  Shared by B4 (poseidon.cu), the streaming kernel X1
// (poseidon_stream.cu) and the experiment variants X2
// (poseidon_variants.cu).
//
// Schedule of hash/poseidon_gl.py: constant add; 4 full rounds (x^7 on all
// 12 elements, the 4th ending in the bridge matrix P instead of M); 22
// partial rounds (x^7 on element 0, then the sparse matrix S_r); 4 full
// rounds with the MDS matrix M.  Round constants and the M, P, S matrices
// sit in __constant__ memory: every thread of a warp reads the same entry
// at the same time, so the constant cache broadcasts it.
//
// permute<Ops, PROBE, NS> is templated on
//   Ops   the field operations: CanonicalOps (B4: every result canonical)
//         or VariantOps<SQ, LAZY> (the experiment's);
//   PROBE a ceiling probe of tools/exp_poseidon.py (:315-427) that drops
//         one part of the work; kNone computes the permutation;
//   NS    states per thread (2 for the experiment's `dual`), interleaved
//         op by op so that the two dependency chains overlap.
#pragma once
#include <cstdint>

#include "gl.cuh"
#include "gl_lazy.cuh"
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

// B4's operations: canonical in, canonical out.
struct CanonicalOps {
  // the round-constant add
  static __device__ __forceinline__ uint64_t add_c(uint64_t a, uint64_t c) { return gl::add(a, c); }
  // sums inside the matrix products
  static __device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) { return gl::add(a, b); }
  static __device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) { return gl::mul(a, b); }
  static __device__ __forceinline__ uint64_t reduce(uint64_t lo, uint64_t hi) {
    return gl::reduce128(lo, hi);
  }
  static __device__ __forceinline__ uint64_t sbox(uint64_t x) { return gl::pow7(x); }
  static __device__ __forceinline__ uint64_t exit(uint64_t x) { return x; }
};

// The experiment's operations (tools/exp_poseidon.py build, :432-445).
//   SQ:   x^7 with dedicated squarings (_pow7_sq, or _pow7_lazy when LAZY);
//         without it the canonical pallas_poseidon._pow7, lazy or not.
//   LAZY: round-constant adds, products and matrix products leave any-u64
//         representatives (_add_lazy, _reduce128_lazy); one canon at exit.
// Without LAZY the round-constant add is pallas_poseidon._add, which folds
// carries but does not canonicalise either; the products and the matrix
// products canonicalise.  The probes see these exact representatives (a
// nomxu flip acts on them), so they follow the JAX helpers bit for bit.
template <bool SQ, bool LAZY>
struct VariantOps {
  static __device__ __forceinline__ uint64_t add_c(uint64_t a, uint64_t c) {
    if constexpr (LAZY) return gl::add_lazy(a, c);
    else return gl::add_fold(a, c);
  }
  static __device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) {
    if constexpr (LAZY) return gl::add_fold(a, b);
    else return gl::add(a, b);
  }
  static __device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
    if constexpr (LAZY) return gl::mul_lazy(a, b);
    else return gl::mul(a, b);
  }
  static __device__ __forceinline__ uint64_t reduce(uint64_t lo, uint64_t hi) {
    if constexpr (LAZY) return gl::reduce128_lazy(lo, hi);
    else return gl::reduce128(lo, hi);
  }
  static __device__ __forceinline__ uint64_t sbox(uint64_t x) {
    if constexpr (!SQ) return gl::pow7(x);
    else if constexpr (LAZY) return gl::pow7_lazy(x);
    else return gl::pow7_sq(x);
  }
  static __device__ __forceinline__ uint64_t exit(uint64_t x) {
    if constexpr (LAZY) return gl::canon(x);
    else return x;
  }
};

template <int NS>
__device__ __forceinline__ void flip(uint64_t (&s)[NS][T]) {
#pragma unroll
  for (int i = 0; i < T; ++i)
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][i] ^= 1;
}

// out_i = Σ_j s_j · M[j][i] with M[j][i] < 2^32: accumulate the 32-bit
// halves of s_j separately (each sum < 2^42), reduce once.
template <class Ops, int PROBE, int NS>
__device__ __forceinline__ void mds_small(uint64_t (&s)[NS][T]) {
  if constexpr (PROBE == kNoMxu) {
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
          const uint64_t m = POSEIDON_M[j * T + i];
          acc_lo += (s[n][j] & gl::EPS) * m;
          acc_hi += (s[n][j] >> 32) * m;
        }
        const uint64_t lo = acc_lo + (acc_hi << 32);
        const uint64_t hi = (acc_hi >> 32) + (lo < acc_lo ? 1 : 0);
        o[n][i] = Ops::reduce(lo, hi);
      }
    }
#pragma unroll
    for (int i = 0; i < T; ++i)
#pragma unroll
      for (int n = 0; n < NS; ++n) s[n][i] = o[n][i];
  }
}

// The bridge matrix P (dense, full-width entries).
template <class Ops, int PROBE, int NS>
__device__ __forceinline__ void mat_p(uint64_t (&s)[NS][T]) {
  if constexpr (PROBE == kNoMxu) {
    flip(s);
  } else {
    uint64_t o[NS][T];
#pragma unroll
    for (int i = 0; i < T; ++i) {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        uint64_t acc = 0;
#pragma unroll
        for (int j = 0; j < T; ++j) acc = Ops::add(acc, Ops::mul(s[n][j], POSEIDON_P[j * T + i]));
        o[n][i] = acc;
      }
    }
#pragma unroll
    for (int i = 0; i < T; ++i)
#pragma unroll
      for (int n = 0; n < NS; ++n) s[n][i] = o[n][i];
  }
}

// x^7 (unless the probe drops it) and the round constants c_off.. on all
// 12 elements.
template <class Ops, bool SBOX, int NS>
__device__ __forceinline__ void sbox_add(uint64_t (&s)[NS][T], int c_off) {
#pragma unroll
  for (int i = 0; i < T; ++i)
#pragma unroll
    for (int n = 0; n < NS; ++n)
      s[n][i] = Ops::add_c(SBOX ? Ops::sbox(s[n][i]) : s[n][i], POSEIDON_C[c_off + i]);
}

template <class Ops, int PROBE, int NS>
__device__ __forceinline__ void partial_round(uint64_t (&s)[NS][T], int r) {
  const uint64_t* srow = POSEIDON_S + (2 * T - 1) * r;
  const uint64_t c = POSEIDON_C[(HALF_F + 1) * T + r];
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    const uint64_t s0 = Ops::add_c(PROBE == kNoPs ? s[n][0] : Ops::sbox(s[n][0]), c);
    s[n][0] = s0;
    if constexpr (PROBE != kNoMxu) {
      uint64_t new0 = 0;
#pragma unroll
      for (int j = 0; j < T; ++j) new0 = Ops::add(new0, Ops::mul(s[n][j], srow[j]));
#pragma unroll
      for (int k = 1; k < T; ++k) s[n][k] = Ops::add(s[n][k], Ops::mul(s0, srow[T + k - 1]));
      s[n][0] = new0;
    }
  }
  if constexpr (PROBE == kNoMxu) flip(s);
}

template <class Ops, int PROBE, int NS>
__device__ __forceinline__ void permute(uint64_t (&s)[NS][T]) {
  constexpr bool kFullSbox = PROBE != kNoFs;
#pragma unroll
  for (int i = 0; i < T; ++i)
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][i] = Ops::add_c(s[n][i], POSEIDON_C[i]);

#pragma unroll 1
  for (int r = 0; r < HALF_F - 1; ++r) {
    sbox_add<Ops, kFullSbox>(s, (r + 1) * T);
    mds_small<Ops, PROBE>(s);
  }
  sbox_add<Ops, kFullSbox>(s, HALF_F * T);
  mat_p<Ops, PROBE>(s);

#pragma unroll 1
  for (int r = 0; r < RP; ++r) partial_round<Ops, PROBE>(s, r);

  const int base = (HALF_F + 1) * T + RP;
#pragma unroll 1
  for (int r = 0; r < HALF_F - 1; ++r) {
    sbox_add<Ops, kFullSbox>(s, base + r * T);
    mds_small<Ops, PROBE>(s);
  }
  // the S-box before the last matrix runs under every probe
  // (tools/exp_poseidon.py:419 is not gated by skip_fsbox)
#pragma unroll
  for (int i = 0; i < T; ++i)
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][i] = Ops::sbox(s[n][i]);
  mds_small<Ops, PROBE>(s);
#pragma unroll
  for (int i = 0; i < T; ++i)
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][i] = Ops::exit(s[n][i]);
}

}  // namespace poseidon
