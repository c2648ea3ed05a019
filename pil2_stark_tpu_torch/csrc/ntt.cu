// Goldilocks NTT kernels: the two levels of the planar four-step and the
// base transform of the row-major route.
//
// Replaces the Pallas kernels of pil2_stark_tpu/ops/pallas_ntt.py:
//   * gl_level_planar  <- level_planar  (:439, _pallas_level_planar :408), "B2"
//   * gl_base_grid     <- base_grid     (:497, _pallas_base_grid :471),    "B3"
//   * gl_base_rows     <- base_ntt_brev (:519, _pallas_base :238),         "B1"
//
// A transform of N = n1·n2 points runs on planar (C, N) data as
//   B2: Y[c·n2 + i2, o1] = w_N^(o1·i2) · Σ_i1 w_n1^(i1·o1) · x[c, i1·n2 + i2]
//   B3: Z[c·n2 + o2, o1] = Σ_i2 w_n2^(i2·o2) · Y[c·n2 + i2, o1]
// and Z read as (C, N) is the transform in natural order (flat o2·n1 + o1).
// B1 is the base of the row-major recursion (ops/ntt.py::axis0_ntt): a
// transform along axis 0 of a row-major (n, L) array, n = 2^1..2^12 and any
// lane count L, Z[o, l] = Σ_i w_n^(i·o) · x[i, l].
// All three kernels fuse the bit-reverse gather of their input into the
// load addressing (the JAX path runs it as a separate jnp.take) and write
// canonical values (the TPU B3 leaves lazy values; these do not).  The
// inverse transform runs the inverted roots and leaves out 1/n, which the
// caller folds in.
//
// B2 and B3.  Bound on the H100: bytes, each input read once and each
// output written once: 2·8·C·N for B3, and B2 also reads the (n1, n2)
// level-twiddle table once (0.311 / 0.300 ms for B2 / B3 at 15 × 2^22).
// Both run on B1's radix passes (below), so every transform of up to 64
// points takes power-of-two stage twiddles and a 4096-point one a single
// general product per element:
//   * B3 is B1's transform per column batch: the (n2, n1) slice of column
//     c is an (n, lanes) array, and the pass kernel takes the column as
//     blockIdx.z at a stride of n2·n1 words.  n2 = 2^12 runs B1's two
//     64-point passes through a scratch array.  Up to n2 = 2^6 it is pass
//     2's kernel alone; the single transform of at most 2^12 points
//     (n1 = 1, n2 = 2^bits, one lane per column) runs the same passes.
//     There each block has one live thread, so it is about twice as slow
//     as the shared tile it replaces (0.038–0.053 against 0.022–0.026 ms
//     at 3 and 15 × 2^12 on an H100, ab_trees.py), accepted because no
//     prove's main path runs a transform that small.
//   * B2 is B1's split n1 = NA·NB along the strided i1 axis: pass 1 is B1's
//     pass 1 at row stride n2 (NA-point transforms, the inner twiddle
//     w_n1^(oa·ib), into a scratch array); pass 2 (level_pass_kernel)
//     runs the NB-point transforms, multiplies by w_N^(o1·i2) and stores
//     out[(c·n2 + i2)·n1 + o1] through shared memory: a block holds 4
//     consecutive oa of 32 lanes, so each store run is a whole 32-byte
//     sector (2 oa, half sectors, measured 1.9–2.2× slower; 8 and 16, 1–7 %
//     slower).  The level twiddle is read coalesced from the table (the
//     grid runs the C columns of one tile next to each other, so they
//     share it in L2); up to NB = 16 it is formed from two table words
//     instead, one more product per value (5 % faster at n1 = 2^8, 7–8 %
//     slower at 2^10).  n1 <= 2^6 is pass 2 alone, reading x with the bit
//     reversal.
// The floor of two passes is twice the byte bound (the scratch array is
// written and read once more).  Measured at 15 × 2^22 (NVIDIA H100 80GB
// HBM3, 700 W): B2 0.816 ms, 2.6× its bound, B3 0.850 ms, 2.8× (the
// shared tile they replace: 2.350 / 2.318 ms, one 512-thread block per SM
// whose phases did not overlap); B3's pass 1 is B1's, held by its integer
// ALU stream.  planar_ntt lets B3's pass 2 write over B2's output, which
// its pass 1 has read, so with each kernel's own scratch array a planar
// transform holds three C·N arrays, as the shared tile did
// (kernel_designs.py, ab_trees.py; PERF.md §6).
//
// B1.  Bound on the H100: bytes, 2·8·n·L (0.481 / 0.321 / 0.160 ms for the
// 4096-row bases of a 2^25-point transform of 3 / 2 / 1 columns).  Close
// behind them is the integer ALU pipe, 64 lanes a clock on each SM: a
// canonical Goldilocks add, sub or reduction is 5–15 ALU instructions.
// The design:
//   * n <= 32: one thread per lane holds its n values in registers and
//     runs every stage there; a warp's loads and stores of a row are 32
//     adjacent words.
//   * n = 2^6..2^12, n = NA·NB with NA, NB <= 64: two launches of one
//     kernel through a scratch array.  Pass 1 gives each thread the NA
//     values i1·NB + i2 of one lane (batch i2), all loaded before the
//     first butterfly at offsets fixed at compile time, transforms them in
//     registers and multiplies by w_n^(o1·i2) from a row of the table the
//     block stages in shared memory; pass 2 transforms the NB values of
//     batch o1 and stores X[o1 + NA·o2] from registers.  Every stage
//     twiddle of a transform of up to 64 points is a power of two
//     (ntt_radix.cuh): its product is a shift done as two 32 × 32
//     multiply-adds, which issue to the multiply-add pipe, and one
//     reduction (for 2^e with e >= 64, one product by a constant), so a 4096-point
//     transform takes one general product per element (the twiddle)
//     instead of six.  A warp reads and writes 256 contiguous bytes of a
//     row.  Three 128-thread blocks share an SM (about 166 registers).
//     The floor is twice the byte bound (the scratch array is written and
//     read once more); at 3 columns pass 1 runs at 1.36× a copy of its
//     bytes and is held by its ALU stream (about 71 ALU instructions per
//     element), pass 2 at 1.13× (55).  Both passes in one block with the
//     exchange through shared memory measured 2.9× slower at 4096 rows: a
//     4-lane tile holds 128 KiB, so one block of 8 warps per SM whose
//     phases do not overlap (kernel_designs.py, PERF.md §6).  n = 64 is
//     pass 2's kernel alone.
// Offsets are 64-bit: the 2-point base of a 2^25 transform spans 3·2^25
// words.
#include <cuda_runtime.h>
#include <cstdint>

#include "f3.cuh"
#include "gl.cuh"
#include "ntt_radix.cuh"

namespace {

constexpr int kRowThreads = 256;   // B1's register regime
constexpr int kRegMaxBits = 5;     // B1 keeps n <= 2^5 values per thread
constexpr int kPassThreads = 128;  // the radix passes of B1, B2 and B3
constexpr int kLevelOa = 4;        // B2's pass 2: consecutive oa a block stores (32 bytes)
constexpr int kLevelChainLog = 4;  // B2's pass 2 forms the level twiddle up to 2^4 values
constexpr long long kMaxGridYZ = 65535;

__host__ __device__ constexpr int brev_const(int r, int bits) {
  int o = 0;
  for (int b = 0; b < bits; ++b) o |= ((r >> b) & 1) << (bits - 1 - b);
  return o;
}

// B1, register regime: n = 2^BITS <= 2^kRegMaxBits, thread l owns lane l of
// the (n, lanes) array; every index into v[] is a compile-time constant.
template <int BITS>
__global__ void __launch_bounds__(kRowThreads)
base_rows_reg_kernel(const uint64_t* __restrict__ x,
                     const uint64_t* __restrict__ tw,
                     uint64_t* __restrict__ out, long long lanes) {
  constexpr int N = 1 << BITS;
  const long long l = (long long)blockIdx.x * kRowThreads + threadIdx.x;
  if (l >= lanes) return;
  uint64_t v[N];
#pragma unroll
  for (int r = 0; r < N; ++r)
    v[r] = gl::canon(x[(long long)brev_const(r, BITS) * lanes + l]);
#pragma unroll
  for (int s = 1; s <= BITS; ++s) {
    const int half = 1 << (s - 1);
#pragma unroll
    for (int k = 0; k < N / 2; ++k) {
      const int j = k & (half - 1);
      const int r0 = ((k >> (s - 1)) << s) + j;
      const uint64_t u = v[r0];
      const uint64_t t = gl::mul(v[r0 + half], __ldg(tw + half - 1 + j));
      v[r0] = gl::add(u, t);
      v[r0 + half] = gl::sub(u, t);
    }
  }
#pragma unroll
  for (int r = 0; r < N; ++r) out[(long long)r * lanes + l] = v[r];
}

// The radix regime: n = NA·NB = 2^(LA+LB), LA, LB <= 6.  With
// i = i1·NB + i2 and o = o1 + NA·o2,
//   X[o] = Σ_i2 w_NB^(i2·o2) · w_n^(o1·i2) · Σ_i1 w_NA^(i1·o1) · x[i],
// in two launches of one kernel through a scratch array y:
//   pass 1: batch i2, y[o1·NB + i2] = w_n^(o1·i2) · Σ_i1 w_NA^(i1·o1) x[i1·NB + i2]
//   pass 2: batch o1, X[o1 + NA·o2] = Σ_i2 w_NB^(i2·o2) y[o1·NB + i2]
// (n <= 64 takes pass 2's kernel alone).  Block (bx, b, c) owns lanes
// [bx·128, bx·128 + 128) of batch b of column c (c·col words in): a
// thread holds the 2^LOG values of one lane at row stride in_row in
// registers, transforms them (dft: the stage twiddles are powers of two),
// multiplies by w_n^(o·b) with TW (the block's row, staged in shared
// memory from tw[k] = w_n^k, k < n/2: read straight from tw, ptxas loaded
// all 63 words up front and the pass lost a block per SM), and stores
// them at row stride out_row.
// The row offsets are template arguments, so every brev_const is folded:
// in a `#pragma unroll` loop ptxas kept the 64-value pass's bit reversal
// as a six-trip loop before each load.
template <int LOG, bool CANON, int... R>
__device__ __forceinline__ void load_rows(uint64_t* v, const uint64_t* src, long long in_row,
                                          std::integer_sequence<int, R...>) {
  ((v[R] = CANON ? gl::canon(src[brev_const(R, LOG) * in_row]) : src[brev_const(R, LOG) * in_row]),
   ...);
}

template <int... O>
__device__ __forceinline__ void twiddle_rows(uint64_t* v, const uint64_t* row,
                                             std::integer_sequence<int, O...>) {
  ((v[O + 1] = f3::g::mul(v[O + 1], row[O + 1])), ...);
}

// v[O] = v[O]·tab[O·stride]: B2's level twiddle, one row of the table each
template <int... O>
__device__ __forceinline__ void scale_rows(uint64_t* v, const uint64_t* tab, long long stride,
                                           std::integer_sequence<int, O...>) {
  ((v[O] = f3::g::mul(v[O], tab[O * stride])), ...);
}

// v[O] = v[O]·t·s^O, one more product per value and no table read: B2's
// level twiddle from two words of the table
template <int... O>
__device__ __forceinline__ void chain_rows(uint64_t* v, uint64_t t, uint64_t s,
                                           std::integer_sequence<int, O...>) {
  ((v[O] = f3::g::mul(v[O], t), t = f3::g::mul(t, s)), ...);
}

template <int... O>
__device__ __forceinline__ void store_rows(uint64_t* dst, const uint64_t* v, long long out_row,
                                           std::integer_sequence<int, O...>) {
  ((dst[O * out_row] = v[O]), ...);
}

template <int LOG, bool INV, bool TW, bool CANON>
__global__ void __launch_bounds__(kPassThreads, 3)
base_rows_pass_kernel(const uint64_t* __restrict__ x, const uint64_t* __restrict__ tw,
                      uint64_t* __restrict__ out, long long lanes, long long in_row,
                      long long in_batch, long long out_row, long long out_batch,
                      long long col, int n_mask) {
  const long long l = (long long)blockIdx.x * kPassThreads + threadIdx.x;
  const int b = blockIdx.y;
  const long long c0 = blockIdx.z * col;
  __shared__ uint64_t row[1 << LOG];  // w_n^(o·b), o < 2^LOG
  if constexpr (TW) {
    // tw holds w_n^k for k < n/2; w_n^(k + n/2) = −w_n^k
    if (threadIdx.x < (1 << LOG)) {
      const int k = (threadIdx.x * b) & n_mask, half = (n_mask + 1) >> 1;
      const uint64_t w = tw[k & (half - 1)];
      row[threadIdx.x] = k < half ? w : (w ? gl::P - w : 0);
    }
    __syncthreads();
  }
  if (l >= lanes) return;
  uint64_t v[1 << LOG];
  load_rows<LOG, CANON>(v, x + c0 + b * in_batch + l, in_row,
                        std::make_integer_sequence<int, 1 << LOG>{});
  radix::dft<LOG, INV>(v);
  if constexpr (TW)
    twiddle_rows(v, row, std::make_integer_sequence<int, (1 << LOG) - 1>{});
  store_rows(out + c0 + b * out_batch + l, v, out_row,
             std::make_integer_sequence<int, 1 << LOG>{});
}

// B2's last pass, over x or pass 1's scratch y, both (C, n1, n2) with
// n1 = NA·NB, NA = 2^la, NB = 2^LOG.  Block (c, g, z) holds oa = g·TA + a
// (a < TA) and lanes i2 = z·TL + t (TL·TA = 128 threads; a warp is 32
// lanes of one oa).  A thread loads the NB values y[c, oa·NB + ib, i2]
// (ib bit-reversed; with la = 0 that is x[c, i1, i2], canonicalised),
// transforms them into o1 = oa + NA·ob, multiplies by lt[o1, i2] (read
// per value, coalesced over i2; up to 16 values formed from two table
// words instead, which measured faster there) and stages them in shared
// memory at [t][ob][a] (rows padded by one word); then the block stores
// out[(c·n2 + i2)·n1 + o1] in runs of TA consecutive oa, whole 32-byte
// sectors (with la = 0, TA = 1 and the block's output is one contiguous
// span).
template <int LOG, int TA, bool INV, bool CANON>
__global__ void __launch_bounds__(kPassThreads, 3)
level_pass_kernel(const uint64_t* __restrict__ x, const uint64_t* __restrict__ lt,
                  uint64_t* __restrict__ out, int la, int log_n2) {
  constexpr int NB = 1 << LOG, TL = kPassThreads / TA, SROW = NB * TA + 1;
  extern __shared__ uint64_t sm[];  // TL × SROW
  const int t = threadIdx.x % TL, a = threadIdx.x / TL;
  const int log_n1 = la + LOG;
  const long long n2 = 1ll << log_n2;
  const long long c = blockIdx.x;
  const int oa0 = blockIdx.y * TA;
  const long long i20 = (long long)blockIdx.z * TL;
  const long long i2 = i20 + t;
  if (i2 < n2) {
    const int oa = oa0 + a;
    uint64_t v[NB];
    load_rows<LOG, CANON>(v, x + (c << (log_n1 + log_n2)) + ((long long)oa << (LOG + log_n2)) + i2,
                          n2, std::make_integer_sequence<int, NB>{});
    radix::dft<LOG, INV>(v);
    // w_N^(o1·i2) = w_N^(oa·i2)·(w_N^(NA·i2))^ob: rows oa and NA of lt
    if constexpr (LOG <= kLevelChainLog)
      chain_rows(v, lt[((long long)oa << log_n2) + i2], lt[(n2 << la) + i2],
                 std::make_integer_sequence<int, NB>{});
    else
      scale_rows(v, lt + ((long long)oa << log_n2) + i2, n2 << la,
                 std::make_integer_sequence<int, NB>{});
    store_rows(sm + t * SROW + a, v, TA, std::make_integer_sequence<int, NB>{});
  }
  __syncthreads();
  uint64_t* dst = out + (((c << log_n2) + i20) << log_n1) + oa0;
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const unsigned idx = k * kPassThreads + threadIdx.x;
    const unsigned a2 = idx % TA, ob = (idx / TA) % NB, t2 = idx / (TA * NB);
    if (i20 + t2 < n2)
      dst[((long long)t2 << log_n1) + ((long long)ob << la) + a2] = sm[t2 * SROW + ob * TA + a2];
  }
}

template <int BITS>
cudaError_t launch_base_rows_reg(const uint64_t* x, const uint64_t* tw,
                                 uint64_t* out, long long lanes,
                                 cudaStream_t stream) {
  const long long blocks = (lanes + kRowThreads - 1) / kRowThreads;
  if (blocks > 0x7fffffffll) return cudaErrorInvalidConfiguration;
  base_rows_reg_kernel<BITS><<<(unsigned)blocks, kRowThreads, 0, stream>>>(
      x, tw, out, lanes);
  return cudaGetLastError();
}

// `cols` arrays of (n, lanes) words, `col` words apart (B1: one).
struct Cols {
  long long lanes;
  long long cols;
  long long col;
};

template <int LOG, bool INV, bool TW, bool CANON>
cudaError_t launch_pass(const uint64_t* x, const uint64_t* tw, uint64_t* out, Cols g,
                        int batches, long long in_row, long long in_batch, long long out_row,
                        long long out_batch, int n_mask, cudaStream_t stream) {
  const long long blocks = (g.lanes + kPassThreads - 1) / kPassThreads;
  if (blocks > 0x7fffffffll || g.cols > kMaxGridYZ) return cudaErrorInvalidConfiguration;
  base_rows_pass_kernel<LOG, INV, TW, CANON>
      <<<dim3((unsigned)blocks, batches, (unsigned)g.cols), kPassThreads, 0, stream>>>(
          x, tw, out, g.lanes, in_row, in_batch, out_row, out_batch, g.col, n_mask);
  return cudaGetLastError();
}

// Pass 1 over NB batches of NA-point transforms, with the twiddle.
template <int LA, bool INV>
cudaError_t launch_pass1(const uint64_t* x, const uint64_t* tw, uint64_t* y, Cols g, int lb,
                         cudaStream_t s) {
  const long long nb = 1ll << lb, lanes = g.lanes;
  return launch_pass<LA, INV, true, true>(x, tw, y, g, (int)nb, nb * lanes, lanes, nb * lanes,
                                          lanes, (1 << (LA + lb)) - 1, s);
}

// Pass 2 over NA batches of NB-point transforms (the whole transform when
// NA = 1, whose input is not canonical yet).
template <int LB, bool INV>
cudaError_t launch_pass2(const uint64_t* y, uint64_t* out, Cols g, int la, cudaStream_t s) {
  const long long na = 1ll << la, nb = 1ll << LB, lanes = g.lanes;
  return la == 0
      ? launch_pass<LB, INV, false, true>(y, nullptr, out, g, 1, lanes, 0, lanes, 0, 0, s)
      : launch_pass<LB, INV, false, false>(y, nullptr, out, g, (int)na, lanes, nb * lanes,
                                           na * lanes, lanes, 0, s);
}

// (LA, LB) of a 2^bits-point transform: one pass up to 2^6 points, else
// NA = 2^(bits − bits/2) and NB = 2^(bits/2) (ops/cuda_ntt.py::radix_split).
constexpr int split_a(int bits) { return bits > 6 ? bits - bits / 2 : 0; }
constexpr int split_b(int bits) { return bits > 6 ? bits / 2 : bits; }

// A transform along the n = 2^bits rows (bits <= 12) of each column: pass
// 1 into y (bits > 6), then pass 2.
template <bool INV>
cudaError_t launch_radix(int bits, const uint64_t* x, const uint64_t* tw, uint64_t* y,
                         uint64_t* out, Cols g, cudaStream_t s) {
  const int la = split_a(bits), lb = split_b(bits);
  cudaError_t e = cudaSuccess;
  if (la) {
    switch (la) {
      case 4: e = launch_pass1<4, INV>(x, tw, y, g, lb, s); break;
      case 5: e = launch_pass1<5, INV>(x, tw, y, g, lb, s); break;
      case 6: e = launch_pass1<6, INV>(x, tw, y, g, lb, s); break;
      default: return cudaErrorInvalidValue;
    }
    if (e != cudaSuccess) return e;
    x = y;
  }
  switch (lb) {
    case 0: return launch_pass2<0, INV>(x, out, g, la, s);
    case 1: return launch_pass2<1, INV>(x, out, g, la, s);
    case 2: return launch_pass2<2, INV>(x, out, g, la, s);
    case 3: return launch_pass2<3, INV>(x, out, g, la, s);
    case 4: return launch_pass2<4, INV>(x, out, g, la, s);
    case 5: return launch_pass2<5, INV>(x, out, g, la, s);
    case 6: return launch_pass2<6, INV>(x, out, g, la, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int LOG, int TA, bool INV, bool CANON>
cudaError_t launch_level(const uint64_t* x, const uint64_t* lt, uint64_t* out, int la,
                         int log_n2, long long cols, cudaStream_t s) {
  constexpr int TL = kPassThreads / TA;
  const int smem = TL * ((1 << LOG) * TA + 1) * (int)sizeof(uint64_t);
  const long long lane_blocks = ((1ll << log_n2) + TL - 1) / TL;
  if (lane_blocks > kMaxGridYZ || cols > 0x7fffffffll) return cudaErrorInvalidConfiguration;
  auto kernel = level_pass_kernel<LOG, TA, INV, CANON>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((unsigned)cols, (1 << la) / TA, (unsigned)lane_blocks), kPassThreads, smem, s>>>(
      x, lt, out, la, log_n2);
  return cudaGetLastError();
}

// B2: n1 = 2^bits1 <= 2^6 in one pass over x; above, B1's pass 1 into y
// at row stride n2, then level_pass_kernel over y.
template <bool INV>
cudaError_t launch_level_planar(int bits1, const uint64_t* x, const uint64_t* tw,
                                const uint64_t* lt, uint64_t* y, uint64_t* out, int log_n2,
                                long long cols, cudaStream_t s) {
  const int la = split_a(bits1), lb = split_b(bits1);
  if (la == 0) {
    switch (lb) {
      case 1: return launch_level<1, 1, INV, true>(x, lt, out, 0, log_n2, cols, s);
      case 2: return launch_level<2, 1, INV, true>(x, lt, out, 0, log_n2, cols, s);
      case 3: return launch_level<3, 1, INV, true>(x, lt, out, 0, log_n2, cols, s);
      case 4: return launch_level<4, 1, INV, true>(x, lt, out, 0, log_n2, cols, s);
      case 5: return launch_level<5, 1, INV, true>(x, lt, out, 0, log_n2, cols, s);
      case 6: return launch_level<6, 1, INV, true>(x, lt, out, 0, log_n2, cols, s);
      default: return cudaErrorInvalidValue;
    }
  }
  const Cols g{1ll << log_n2, cols, (1ll << log_n2) << bits1};
  cudaError_t e;
  switch (la) {
    case 4: e = launch_pass1<4, INV>(x, tw, y, g, lb, s); break;
    case 5: e = launch_pass1<5, INV>(x, tw, y, g, lb, s); break;
    case 6: e = launch_pass1<6, INV>(x, tw, y, g, lb, s); break;
    default: return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return e;
  static_assert(kLevelOa <= 16, "NA >= 16 whenever pass 1 runs");
  switch (lb) {
    case 3: return launch_level<3, kLevelOa, INV, false>(y, lt, out, la, log_n2, cols, s);
    case 4: return launch_level<4, kLevelOa, INV, false>(y, lt, out, la, log_n2, cols, s);
    case 5: return launch_level<5, kLevelOa, INV, false>(y, lt, out, la, log_n2, cols, s);
    case 6: return launch_level<6, kLevelOa, INV, false>(y, lt, out, la, log_n2, cols, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// B2.  x (C, n1·n2) natural order -> out (C·n2, n1); tw: w_n1^k for
// k < n1/2 (bits1 > 6, else unused); lt: the (n1, n2) level twiddles;
// y: a scratch array of C·n1·n2 words (bits1 > 6, else unused).
extern "C" int gl_level_planar(const void* x, const void* tw, const void* lt, void* y,
                               void* out, int bits1, int log_n2, long long n_cols,
                               int inverse, void* stream) {
  if (bits1 < 1 || bits1 > 12 || log_n2 < 0 || n_cols <= 0) return (int)cudaErrorInvalidValue;
  const auto xi = (const uint64_t*)x;
  const auto twi = (const uint64_t*)tw;
  const auto lti = (const uint64_t*)lt;
  const auto yi = (uint64_t*)y;
  const auto o = (uint64_t*)out;
  const auto s = (cudaStream_t)stream;
  return (int)(inverse ? launch_level_planar<true>(bits1, xi, twi, lti, yi, o, log_n2, n_cols, s)
                       : launch_level_planar<false>(bits1, xi, twi, lti, yi, o, log_n2, n_cols, s));
}

// B3.  y (C·n2, n1) -> out, each column's n2 = 2^bits2 rows transformed;
// tw: w_n2^k for k < n2/2 (bits2 > 6, else unused); scratch: C·n2·n1
// words (bits2 > 6, else unused).  out may be y when bits2 > 6: pass 2
// reads only the scratch array.
extern "C" int gl_base_grid(const void* y, const void* tw, void* scratch, void* out, int bits2,
                            long long n1, long long n_cols, int inverse, void* stream) {
  if (bits2 < 0 || bits2 > 12 || n1 <= 0 || n_cols <= 0) return (int)cudaErrorInvalidValue;
  const Cols g{n1, n_cols, n1 << bits2};
  const auto yi = (const uint64_t*)y;
  const auto twi = (const uint64_t*)tw;
  const auto si = (uint64_t*)scratch;
  const auto o = (uint64_t*)out;
  const auto s = (cudaStream_t)stream;
  return (int)(inverse ? launch_radix<true>(bits2, yi, twi, si, o, g, s)
                       : launch_radix<false>(bits2, yi, twi, si, o, g, s));
}

// B1.  tw: the stage twiddles (bits <= kRegMaxBits) or w_n^k for k < n/2,
// the last stage's part of that table (above); y: a scratch array of n ×
// lanes words for bits > 6 (else unused).
extern "C" int gl_base_rows(const void* x, const void* tw, void* y, void* out, int bits,
                            long long lanes, int inverse, void* stream) {
  if (lanes <= 0 || bits < 1 || bits > 12) return (int)cudaErrorInvalidValue;
  const uint64_t* xi = (const uint64_t*)x;
  const uint64_t* twi = (const uint64_t*)tw;
  uint64_t* o = (uint64_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (bits) {
    case 1: return (int)launch_base_rows_reg<1>(xi, twi, o, lanes, s);
    case 2: return (int)launch_base_rows_reg<2>(xi, twi, o, lanes, s);
    case 3: return (int)launch_base_rows_reg<3>(xi, twi, o, lanes, s);
    case 4: return (int)launch_base_rows_reg<4>(xi, twi, o, lanes, s);
    case 5: return (int)launch_base_rows_reg<5>(xi, twi, o, lanes, s);
    default: break;
  }
  static_assert(kRegMaxBits == 5, "the switch above covers bits 1..kRegMaxBits");
  uint64_t* yi = (uint64_t*)y;
  const Cols g{lanes, 1, 0};
  return (int)(inverse ? launch_radix<true>(bits, xi, twi, yi, o, g, s)
                       : launch_radix<false>(bits, xi, twi, yi, o, g, s));
}
