// The xDivXSubXi table of the prove (T2).
//
// It does not replace a pallas_call.  The JAX package computes the table in
// one jitted elementwise program (pil2_stark_tpu/stark/device.py:349
// _jit_xdiv), which XLA fuses; this kernel is the port's counterpart of
// that fusion.  (T1, the TAC programs, is generated per program by
// ops/tac_codegen.py on csrc/f3.cuh.)
//
// T2 gl_xdiv: out[o][c][i] = x_i/(x_i − xi_o) over F_p³ = F_p[t]/(t³ − t − 1)
// at each point x_i of the extended coset, 0 where x_i − xi_o is 0.  For a
// base point x the norm N(x) = Norm(x − xi) = x³ − c2·x² + c1·x − c0 is a
// monic cubic over F_p, and with the adjugate adj(x) = x² + A1·x + A0
// ((x − xi)·adj(x) = N(x)),
//   x/(x − xi) = 1 + xi·adj(x)/N(x) = 1 + (xi·x² + B1·x + c0)/N(x),
// B1 = xi·A1.  The host computes xi, B1, c2, c1 and c0 once per opening
// (ops/cuda_tac.py::xdiv_coefficients).  Per point the kernel takes x² and
// x³ once for all openings; per point and opening N = x³ + (p − c2)·x² +
// c1·x + (p − c0) as one sum of two products and two words, reduced once
// (struct Acc), and, with s = N^-1, w = x·s and w2 = x·w, component k =
// xi_k·w2 + B1_k·w (plus c0·s + 1 in component 0), each one sum reduced
// once.  N = 0 exactly when x = xi: that value enters the batch as 1 and
// its output is 0, as the plain version's inverse of 0 gives.  Products
// and adds are f3.cuh's canonical carry-chain ops.
//
// The inverses: Montgomery's batch inversion over a whole block, one
// addition-chain inverse (74 products) per block trip.  Each thread owns
// kBatch norms (kBatch / nOpenings points, strided by the block) and keeps
// their prefix products; the warp scans the thread products both ways with
// shuffles; lanes 0..7 of warp 0 multiply the other warps' products and
// thread 0 inverts the block's.  Each thread's inverse of its own product
// is that inverse times every other thread's product; it then walks its
// prefix products back (2 products per norm).
//
// Bound on the H100: bytes (8 read per point, 24 written per point and
// opening) by the count of chip_smoke.py.  The kernel is bound by its
// integer ALU stream instead (about 530 ALU instructions per point at two
// openings; the ALU pipe issues 64 lanes a clock on each SM), and by the
// serial inverse, which leaves a block's other warps waiting at the
// barrier (PERF.md §6).  kBatch = 16 measured faster than 8 and 12.
#include <cuda_runtime.h>
#include <cstdint>

#include "f3.cuh"

namespace {

namespace g = f3::g;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxOpenings = 16;
constexpr int kBatch = 16;  // norms a thread owns (PERF.md §6)

// SMs of the current card, read once per card
int sm_count() {
  constexpr int kMaxCards = 64;
  static int counts[kMaxCards] = {};
  int dev = 0, count = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < kMaxCards && counts[dev] > 0) return counts[dev];
  cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  if (dev >= 0 && dev < kMaxCards) counts[dev] = count;
  return count;
}

// x^(p-2) = x^((2^31 - 1)·2^33 + 2^32 - 1); 0 -> 0
__device__ __forceinline__ uint64_t sqn(uint64_t x, int k) {
  for (int i = 0; i < k; ++i) x = g::mul(x, x);
  return x;
}

__device__ uint64_t inv(uint64_t x) {
  const uint64_t t2 = g::mul(sqn(x, 1), x);      // 2^2 - 1
  const uint64_t t4 = g::mul(sqn(t2, 2), t2);    // 2^4 - 1
  const uint64_t t8 = g::mul(sqn(t4, 4), t4);    // 2^8 - 1
  const uint64_t t16 = g::mul(sqn(t8, 8), t8);   // 2^16 - 1
  const uint64_t t24 = g::mul(sqn(t16, 8), t8);  // 2^24 - 1
  const uint64_t t28 = g::mul(sqn(t24, 4), t4);  // 2^28 - 1
  const uint64_t t30 = g::mul(sqn(t28, 2), t2);  // 2^30 - 1
  const uint64_t t31 = g::mul(sqn(t30, 1), x);   // 2^31 - 1
  const uint64_t t32 = g::mul(sqn(t31, 1), x);   // 2^32 - 1
  return g::mul(sqn(t31, 33), t32);
}

// A sum of a few 128-bit products and words, (a2·2^128 + a1·2^64 + a0),
// reduced once: 2^64 ≡ EPS, 2^96 ≡ −1, 2^128 ≡ −2^32.  a2 stays below 8.
struct Acc {
  uint64_t a0 = 0, a1 = 0;
  uint32_t a2 = 0;
  __device__ __forceinline__ void mad(uint64_t a, uint64_t b) {
    asm("mad.lo.cc.u64 %0, %3, %4, %0;\n\t"
        "madc.hi.cc.u64 %1, %3, %4, %1;\n\t"
        "addc.u32 %2, %2, 0;"
        : "+l"(a0), "+l"(a1), "+r"(a2) : "l"(a), "l"(b));
  }
  __device__ __forceinline__ void add(uint64_t a) {
    asm("add.cc.u64 %0, %0, %3;\n\t"
        "addc.cc.u64 %1, %1, 0;\n\t"
        "addc.u32 %2, %2, 0;"
        : "+l"(a0), "+l"(a1), "+r"(a2) : "l"(a));
  }
  // a0 − hh + hl·EPS with hh = a1's high half + a2·2^32 (< 2^35) and hl its
  // low half: lo − hh borrows at most once (then subtracting EPS cannot
  // borrow again), the add of hl·EPS carries at most once (then adding EPS
  // cannot carry again); the result, below 2^64, is made canonical.
  __device__ __forceinline__ uint64_t reduce() const {
    const uint64_t hh = (a1 >> 32) | ((uint64_t)a2 << 32);
    const uint32_t hl = (uint32_t)a1;
    const uint64_t t1 = ((uint64_t)hl << 32) - hl;
    uint64_t r;
    asm("{\n\t.reg .u64 t0, f;\n\t.reg .u32 e;\n\t"
        "sub.cc.u64 t0, %1, %2;\n\t"
        "subc.u32 e, 0, 0;\n\t"
        "cvt.u64.u32 f, e;\n\t"
        "sub.u64 t0, t0, f;\n\t"
        "add.cc.u64 t0, t0, %3;\n\t"
        "addc.u32 e, 0, 0;\n\t"
        "neg.s32 e, e;\n\t"
        "cvt.u64.u32 f, e;\n\t"
        "add.u64 %0, t0, f;\n\t}"
        : "=l"(r) : "l"(a0), "l"(hh), "l"(t1));
    return r >= gl::P ? r - gl::P : r;
  }
};

// One opening: xi, B1 = xi·(xi − c2), and N(x) = x³ + c2n·x² + c1·x + c0n
// with c2n = p − c2, c0n = p − c0 (any u64 works in Acc).
struct Opening {
  uint64_t xi[3], b1[3], c2n, c1, c0, c0n;
};

struct Openings {
  Opening o[kMaxOpenings];
};

__device__ __forceinline__ uint64_t shfl_up(uint64_t v, int d) {
  return __shfl_up_sync(0xffffffffu, v, d);
}
__device__ __forceinline__ uint64_t shfl_down(uint64_t v, int d) {
  return __shfl_down_sync(0xffffffffu, v, d);
}

// A block takes kThreads·K points per trip (point k of thread t at
// base + k·kThreads + t) and inverts the norms of all of them with one
// addition-chain inverse: each thread multiplies its V = K·NOPEN norms
// (prefix products kept), the warp scans the thread products both ways
// with shuffles, thread 0 multiplies the warp products and inverts their
// product, and each thread's inverse of its own product is that inverse
// times every other thread's product; the thread then walks its prefix
// products back (Montgomery's batch inversion).
template <int NOPEN>
__global__ void __launch_bounds__(kThreads, 2)
xdiv_kernel(const uint64_t* __restrict__ x_ext, const Openings ops,
            uint64_t* __restrict__ out, long long n) {
  constexpr int K = kBatch / NOPEN > 0 ? kBatch / NOPEN : 1;  // points per thread
  constexpr int V = K * NOPEN;
  __shared__ uint64_t warp_prod[kWarps], others[kWarps], inv_all;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long span = (long long)kThreads * K;
  for (long long base = (long long)blockIdx.x * span; base < n;
       base += (long long)gridDim.x * span) {
    uint64_t x[K], den[V], pre[V];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const long long i = base + (long long)k * kThreads + threadIdx.x;
      x[k] = i < n ? x_ext[i] : 0;
      const uint64_t x2 = g::mul(x[k], x[k]), x3 = g::mul(x2, x[k]);
#pragma unroll
      for (int o = 0; o < NOPEN; ++o) {
        Acc a;
        a.add(x3);
        a.add(ops.o[o].c0n);
        a.mad(ops.o[o].c2n, x2);
        a.mad(ops.o[o].c1, x[k]);
        const uint64_t d = a.reduce();
        // a zero norm, and every point past n, enters the batch as 1
        den[k * NOPEN + o] = i < n ? d : 1;
      }
    }
    uint64_t acc = 1;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      acc = g::mul(acc, den[v] == 0 ? 1 : den[v]);
      pre[v] = acc;
    }
    // products of the threads before (lo) and after (hi) this one in its warp
    uint64_t lo = acc, hi = acc;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint64_t a = shfl_up(lo, d), b = shfl_down(hi, d);
      if (lane >= d) lo = g::mul(lo, a);
      if (lane + d < 32) hi = g::mul(hi, b);
    }
    if (lane == 0) warp_prod[warp] = hi;  // the whole warp's product
    lo = shfl_up(lo, 1);
    hi = shfl_down(hi, 1);
    if (lane == 0) lo = 1;
    if (lane == 31) hi = 1;
    __syncthreads();
    if (threadIdx.x < kWarps) {  // lane w of warp 0: the product of every warp but w
      uint64_t p = 1;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        if (w != threadIdx.x) p = g::mul(p, warp_prod[w]);
      others[threadIdx.x] = p;
      if (threadIdx.x == 0) inv_all = inv(g::mul(p, warp_prod[0]));
    }
    __syncthreads();
    // the inverse of this thread's product: 1/(the block's) · every other factor
    acc = g::mul(g::mul(lo, hi), g::mul(others[warp], inv_all));
#pragma unroll
    for (int v = V - 1; v >= 0; --v) {
      const int k = v / NOPEN, o = v % NOPEN;
      const long long i = base + (long long)k * kThreads + threadIdx.x;
      const bool zero = den[v] == 0;
      const uint64_t s = v > 0 ? g::mul(acc, pre[v - 1]) : acc;  // 1/den[v]
      if (v > 0 && !zero) acc = g::mul(acc, den[v]);
      if (i >= n) continue;
      const Opening& op = ops.o[o];
      const uint64_t w = g::mul(x[k], s), w2 = g::mul(x[k], w);  // x/N, x²/N
      uint64_t* p = out + (long long)3 * o * n + i;
      Acc a0, a1, a2;
      a0.add(1);
      a0.mad(op.xi[0], w2);
      a0.mad(op.b1[0], w);
      a0.mad(op.c0, s);
      a1.mad(op.xi[1], w2);
      a1.mad(op.b1[1], w);
      a2.mad(op.xi[2], w2);
      a2.mad(op.b1[2], w);
      p[0] = zero ? 0 : a0.reduce();
      p[n] = zero ? 0 : a1.reduce();
      p[2 * n] = zero ? 0 : a2.reduce();
    }
  }
}

template <int NOPEN>
cudaError_t launch(const uint64_t* x, const Openings& ops, uint64_t* out, long long n,
                   cudaStream_t stream) {
  constexpr int K = kBatch / NOPEN > 0 ? kBatch / NOPEN : 1;
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, xdiv_kernel<NOPEN>, kThreads, 0);
  if (e != cudaSuccess) return e;
  long long blocks = (n + (long long)kThreads * K - 1) / ((long long)kThreads * K);
  const long long resident = (long long)(per_sm > 0 ? per_sm : 1) * sm_count();
  if (blocks > resident) blocks = resident;
  xdiv_kernel<NOPEN><<<(unsigned)blocks, kThreads, 0, stream>>>(x, ops, out, n);
  return cudaGetLastError();
}

}  // namespace

// coefs: per opening xi[3], b1[3], c2, c1, c0 (canonical), as
// ops/cuda_tac.py::xdiv_coefficients gives them.
extern "C" int gl_xdiv(const void* x_ext, const void* coefs, int n_open, void* out,
                       long long n, void* stream) {
  if (n <= 0 || n_open <= 0 || n_open > kMaxOpenings) return (int)cudaErrorInvalidValue;
  Openings ops{};
  const uint64_t* src = (const uint64_t*)coefs;
  for (int o = 0; o < n_open; ++o) {
    const uint64_t* c = src + 9 * o;
    const uint64_t c2n = c[6] ? gl::P - c[6] : 0, c0n = c[8] ? gl::P - c[8] : 0;
    ops.o[o] = Opening{{c[0], c[1], c[2]}, {c[3], c[4], c[5]}, c2n, c[7], c[8], c0n};
  }
  const uint64_t* x = (const uint64_t*)x_ext;
  uint64_t* o = (uint64_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (n_open) {
#define XDIV_CASE(k) \
  case k: return (int)launch<k>(x, ops, o, n, s);
    XDIV_CASE(1) XDIV_CASE(2) XDIV_CASE(3) XDIV_CASE(4) XDIV_CASE(5) XDIV_CASE(6)
    XDIV_CASE(7) XDIV_CASE(8) XDIV_CASE(9) XDIV_CASE(10) XDIV_CASE(11) XDIV_CASE(12)
    XDIV_CASE(13) XDIV_CASE(14) XDIV_CASE(15) XDIV_CASE(16)
#undef XDIV_CASE
    default: break;
  }
  static_assert(kMaxOpenings == 16, "the switch above covers 1..kMaxOpenings");
  return (int)cudaErrorInvalidValue;
}
