// Cubic extension F_p[x]/(x^3 - x - 1) over gl.cuh, with the mixed-dim
// semantics of field/torch_f3.py: a value is a base element (uint64_t) or
// an extension element (F3), and every op is one overload per pair of
// static dims, so a caller whose dims are known when it is written (the
// kernels ops/tac_codegen.py generates) has no dim branch left.
//
//   base + ext  touches component 0 only;
//   base - ext  negates components 1 and 2, ext - base keeps them;
//   base × ext  is the scalar action, ext × ext Karatsuba with x^3 = x + 1.
//
// Every op is canonical in and out, so a program evaluated with these in
// any order gives the plain version's bits.  The extension ops are made of
// the base-field ops of namespace g below.
#pragma once
#include <cstdint>

#include "gl.cuh"

namespace f3 {

// Canonical Goldilocks add, sub and product for T1: canonical in and out,
// so the bits of gl.cuh's, in fewer instructions on the card.  A 64-bit
// compare costs two ISETP and a 64-bit select two SEL; these take the
// carry or borrow of the 64-bit add or subtract itself (PTX add.cc /
// sub.cc, one asm block per chain: the flag does not live from one asm
// statement to the next).  From T1's SASS per row (PERF.md §6) that is
// about 8 instructions for an add, 6 for a sub and 15 for a product.  On the
// host (the CPU tests compile the generated rows with g++) they are
// gl.cuh's.
namespace g {

#ifdef __CUDA_ARCH__
// a + b = a - (p - b): without a borrow that is a + b - p, with one the
// difference is a + b + EPS (mod 2^64), and a + b = that - EPS
__device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) {
  uint64_t r;
  asm("{\n\t.reg .u64 f;\n\t.reg .u32 e;\n\t"
      "mov.u64 f, 0xFFFFFFFF00000001;\n\t"
      "sub.u64 f, f, %2;\n\t"
      "sub.cc.u64 %0, %1, f;\n\t"
      "subc.u32 e, 0, 0;\n\t"  // 2^32 - 1 on a borrow, else 0
      "cvt.u64.u32 f, e;\n\t"
      "sub.u64 %0, %0, f;\n\t}"
      : "=&l"(r) : "l"(a), "l"(b));
  return r;
}

// a - b, plus p on a borrow: d + p = d - EPS (mod 2^64)
__device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) {
  uint64_t r;
  asm("{\n\t.reg .u64 f;\n\t.reg .u32 e;\n\t"
      "sub.cc.u64 %0, %1, %2;\n\t"
      "subc.u32 e, 0, 0;\n\t"
      "cvt.u64.u32 f, e;\n\t"
      "sub.u64 %0, %0, f;\n\t}"
      : "=&l"(r) : "l"(a), "l"(b));
  return r;
}

// The 128-bit product from PTX's 64-bit mul.lo / mul.hi, which ptxas
// turns into fewer instructions than the product written in 32-bit halves
// (PERF.md §6); then gl::reduce128's steps on carry flags: lo + hi·2^64
// ≡ lo - hh + hl·EPS (hi = hh·2^32 + hl), a borrow folded as -EPS.  The
// sum r of the last add takes EPS when it carried (r + EPS is then below
// p) and becomes r - p = r + EPS when r + EPS carries (r >= p); so one
// r + EPS, taken when either add carried, does both.
__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
  uint64_t lo, hi, r;
  asm("mul.lo.u64 %0, %2, %3;\n\tmul.hi.u64 %1, %2, %3;" : "=l"(lo), "=l"(hi) : "l"(a), "l"(b));
  asm("{\n\t.reg .u64 h, f;\n\t.reg .u32 hl, hh, e;\n\t.reg .pred q;\n\t"
      "mov.b64 {hl, hh}, %2;\n\t"
      "cvt.u64.u32 h, hh;\n\t"
      "sub.cc.u64 %0, %1, h;\n\t"
      "subc.u32 e, 0, 0;\n\t"
      "cvt.u64.u32 f, e;\n\t"
      "sub.u64 %0, %0, f;\n\t"
      "mul.wide.u32 h, hl, 4294967295;\n\t"
      "add.cc.u64 %0, %0, h;\n\t"
      "addc.u32 e, 0, 0;\n\t"
      "add.cc.u64 h, %0, 4294967295;\n\t"
      "addc.u32 e, e, 0;\n\t"
      "setp.ne.u32 q, e, 0;\n\t"
      "@q mov.b64 %0, h;\n\t}"
      : "=&l"(r) : "l"(lo), "l"(hi));
  return r;
}
#else
__device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) { return gl::add(a, b); }
__device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) { return gl::sub(a, b); }
__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) { return gl::mul(a, b); }
#endif

}  // namespace g

struct F3 {
  uint64_t c0, c1, c2;
};

// An extension scalar with the pair sums Karatsuba's product takes of it
// (c0 + c1, c0 + c2, c1 + c2), computed once per run, not per row.
struct F3S {
  uint64_t c0, c1, c2, s01, s02, s12;
};

__device__ __forceinline__ F3 make(uint64_t a, uint64_t b, uint64_t c) {
  return F3{a, b, c};
}

__device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) { return g::add(a, b); }
__device__ __forceinline__ F3 add(const F3& a, uint64_t b) {
  return F3{g::add(a.c0, b), a.c1, a.c2};
}
__device__ __forceinline__ F3 add(uint64_t a, const F3& b) {
  return F3{g::add(a, b.c0), b.c1, b.c2};
}
__device__ __forceinline__ F3 add(const F3& a, const F3& b) {
  return F3{g::add(a.c0, b.c0), g::add(a.c1, b.c1), g::add(a.c2, b.c2)};
}

__device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) { return g::sub(a, b); }
__device__ __forceinline__ F3 sub(const F3& a, uint64_t b) {
  return F3{g::sub(a.c0, b), a.c1, a.c2};
}
__device__ __forceinline__ F3 sub(uint64_t a, const F3& b) {
  return F3{g::sub(a, b.c0), g::sub(0, b.c1), g::sub(0, b.c2)};
}
__device__ __forceinline__ F3 sub(const F3& a, const F3& b) {
  return F3{g::sub(a.c0, b.c0), g::sub(a.c1, b.c1), g::sub(a.c2, b.c2)};
}

__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) { return g::mul(a, b); }
__device__ __forceinline__ F3 mul(const F3& a, uint64_t b) {
  return F3{g::mul(a.c0, b), g::mul(a.c1, b), g::mul(a.c2, b)};
}
__device__ __forceinline__ F3 mul(uint64_t a, const F3& b) {
  return F3{g::mul(a, b.c0), g::mul(a, b.c1), g::mul(a, b.c2)};
}
// Karatsuba with x^3 = x + 1 (field/torch_f3.py::mul), b's pair sums given
__device__ __forceinline__ F3 mul(const F3& a, const F3S& b) {
  const uint64_t A = g::mul(g::add(a.c0, a.c1), b.s01);
  const uint64_t B = g::mul(g::add(a.c0, a.c2), b.s02);
  const uint64_t C = g::mul(g::add(a.c1, a.c2), b.s12);
  const uint64_t D = g::mul(a.c0, b.c0);
  const uint64_t E = g::mul(a.c1, b.c1);
  const uint64_t F = g::mul(a.c2, b.c2);
  const uint64_t G = g::sub(D, E);
  return F3{g::sub(g::add(C, G), F), g::sub(g::sub(g::add(A, C), g::add(E, E)), D),
            g::sub(B, G)};
}
__device__ __forceinline__ F3 mul(const F3S& a, const F3& b) { return mul(b, a); }
__device__ __forceinline__ F3 mul(const F3& a, const F3& b) {
  return mul(a, F3S{b.c0, b.c1, b.c2, g::add(b.c0, b.c1), g::add(b.c0, b.c2),
                    g::add(b.c1, b.c2)});
}

// muladd(a, b, c) = add(mul(a, b), c) (field/torch_f3.py::muladd)
template <typename A, typename B, typename C>
__device__ __forceinline__ auto muladd(const A& a, const B& b, const C& c) {
  return add(mul(a, b), c);
}

}  // namespace f3
