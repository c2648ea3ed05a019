// Kernel B1's transforms of up to 64 points in registers (csrc/ntt.cu).
//
// Every 2^s-th root of the port's chain for s <= 6 is a power of two:
// w_{2^s} = 2^(192 >> s) and its inverse 2^(192 - (192 >> s)) (2^192 ≡ 1,
// 2^96 ≡ −1 mod p; held against field/gl64.py by the CPU tests).  So
// every stage twiddle w_{2^s}^j of a transform of up to 64 points is
// ±2^e with e < 96, a compile-time constant.  For e < 64 its product is a
// shift, done as two 32 × 32 multiply-adds (shl_wide: they issue to the
// multiply-add pipe, not to the ALU that the adds keep busy), and one
// reduction; for e >= 64 it is one product by a 64-bit constant.  Field ops are f3.cuh's canonical ones (PTX carry
// chains on the card, gl.cuh's on the host, where the CPU tests build
// this header with g++: the host takes the C++ branch of shl_wide and
// reduce96).
#pragma once
#include <cstdint>
#include <utility>

#include "f3.cuh"

namespace radix {

namespace g = f3::g;

// The exponent of w_{2^s}^j (s <= 6) as a power of two, in [0, 192).
__host__ __device__ constexpr int tw_exp(int s, int j, bool inverse) {
  return inverse ? (192 - j * (192 >> s)) % 192 : j * (192 >> s);
}

// x·2^E = lo + h·2^64 (h < 2^E) for 0 <= E < 32, from x's 32-bit halves
// by two 32 × 32 -> 64 multiply-adds: on the card they issue to the
// multiply-add pipe, not to the integer ALU that the adds and reductions
// keep busy.
template <int E>
__device__ __forceinline__ void shl_wide(uint64_t x, uint64_t& lo, uint32_t& h) {
  const uint32_t xl = (uint32_t)x, xh = (uint32_t)(x >> 32);
#ifdef __CUDA_ARCH__
  uint64_t a, b;
  asm("mul.wide.u32 %0, %2, %4;\n\t"
      "{\n\t.reg .u32 t, u;\n\t.reg .u64 c;\n\t"
      "mov.b64 {t, u}, %0;\n\t"
      "cvt.u64.u32 c, u;\n\t"
      "mad.wide.u32 %1, %3, %4, c;\n\t}"
      : "=&l"(a), "=l"(b) : "r"(xl), "r"(xh), "n"(1u << E));
#else
  const uint64_t a = (uint64_t)xl << E;
  const uint64_t b = ((uint64_t)xh << E) + (a >> 32);
#endif
  lo = (b << 32) | (uint32_t)a;
  h = (uint32_t)(b >> 32);
}

// (lo + h·2^64) mod p, canonical, for any lo and h < 2^32: lo + h·EPS
// carries at most once, and r + EPS carries exactly when r >= p, so one
// r + EPS, taken when either carried, does both (as f3.cuh's reduce128).
__device__ __forceinline__ uint64_t reduce96(uint64_t lo, uint32_t h) {
#ifdef __CUDA_ARCH__
  uint64_t r;
  asm("{\n\t.reg .u64 t;\n\t.reg .u32 e;\n\t.reg .pred q;\n\t"
      "mul.wide.u32 t, %2, 4294967295;\n\t"
      "add.cc.u64 %0, %1, t;\n\t"
      "addc.u32 e, 0, 0;\n\t"
      "add.cc.u64 t, %0, 4294967295;\n\t"
      "addc.u32 e, e, 0;\n\t"
      "setp.ne.u32 q, e, 0;\n\t"
      "@q mov.b64 %0, t;\n\t}"
      : "=&l"(r) : "l"(lo), "r"(h));
  return r;
#else
  return gl::reduce128(lo, h);
#endif
}

// x·2^E mod p for 0 < E < 96, canonical x.  E < 32: shl_wide and
// reduce96.  32 <= E < 64: x·2^(E−32) from shl_wide is the 128-bit
// x·2^E's words 1..3.  E >= 64: 2^E ≡ 2^(E−32) − 2^(E−64) (2^64 ≡ 2^32 − 1),
// one product by that 64-bit constant.
template <int E>
__device__ __forceinline__ uint64_t mul_pow2(uint64_t x) {
  static_assert(0 < E && E < 96, "0 < E < 96");
  if constexpr (E < 32) {
    uint64_t lo;
    uint32_t h;
    shl_wide<E>(x, lo, h);
    return reduce96(lo, h);
  } else if constexpr (E < 64) {
    uint64_t lo;
    uint32_t h;
    shl_wide<E - 32>(x, lo, h);
    return g::reduce128(lo << 32, (lo >> 32) | ((uint64_t)h << 32));
  } else {
    return g::mul(x, (1ull << (E - 32)) - (1ull << (E - 64)));
  }
}

// (u, v) -> (u + w·v, u − w·v) with w = 2^E, E in [0, 192): 2^E for
// E >= 96 is −2^(E−96), which swaps the add and the sub.
template <int E>
__device__ __forceinline__ void butterfly(uint64_t& u, uint64_t& v) {
  uint64_t t;
  if constexpr (E == 0 || E == 96) {
    t = v;
  } else if constexpr (E < 96) {
    t = mul_pow2<E>(v);
  } else {
    t = mul_pow2<E - 96>(v);
  }
  const uint64_t a = g::add(u, t), b = g::sub(u, t);
  if constexpr (E < 96) {
    u = a;
    v = b;
  } else {
    u = b;
    v = a;
  }
}

template <int LOG, bool INV, int S, int... K>
__device__ __forceinline__ void stage(uint64_t* v, std::integer_sequence<int, K...>) {
  constexpr int half = 1 << (S - 1);
  (butterfly<tw_exp(S, K & (half - 1), INV)>(v[((K >> (S - 1)) << S) + (K & (half - 1))],
                                             v[((K >> (S - 1)) << S) + (K & (half - 1)) + half]),
   ...);
}

template <int LOG, bool INV, int... S>
__device__ __forceinline__ void stages(uint64_t* v, std::integer_sequence<int, S...>) {
  (stage<LOG, INV, S + 1>(v, std::make_integer_sequence<int, (1 << LOG) / 2>{}), ...);
}

// Radix-2 DIT on v[0, 2^LOG), LOG <= 6: v enters in bit-reversed order and
// leaves in natural order, v[o] = Σ_i w_{2^LOG}^(i·o) x[i] (inverse roots
// with INV, no 1/n).  Stage s pairs v[r0] and v[r0 + 2^(s−1)] with twiddle
// w_{2^s}^j, j = r0 mod 2^(s−1), as cuda_ntt.dit_brev does.
template <int LOG, bool INV>
__device__ __forceinline__ void dft(uint64_t* v) {
  static_assert(0 <= LOG && LOG <= 6, "power-of-two twiddles reach 64 points");
  stages<LOG, INV>(v, std::make_integer_sequence<int, LOG>{});
}

}  // namespace radix
