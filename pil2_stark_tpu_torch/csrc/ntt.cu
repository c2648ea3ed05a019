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
// B2 and B3.  Bound on the H100: bytes.  Each reads its input once and
// writes its output once (B2 also reads the (n1, n2) level-twiddle
// table).  A block holds a (rows × tile) tile in shared memory (tile
// adjacent lanes, so global loads and stores are coalesced; each row
// padded by one word so the transposed B2 write is free of bank
// conflicts), and all log2(n) radix-2 stages run there between
// __syncthreads.
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

constexpr int kThreads = 512;
constexpr int kRowThreads = 256;   // B1's register regime
constexpr int kRegMaxBits = 5;     // B1 keeps n <= 2^5 values per thread
constexpr int kPassThreads = 128;  // B1's radix regime

__device__ __forceinline__ int brev(int r, int bits) {
  return bits == 0 ? 0 : (int)(__brev((unsigned)r) >> (32 - bits));
}

__host__ __device__ constexpr int brev_const(int r, int bits) {
  int o = 0;
  for (int b = 0; b < bits; ++b) o |= ((r >> b) & 1) << (bits - 1 - b);
  return o;
}

// Radix-2 DIT on the n = 2^bits rows of sm[row·tp + lane], lanes < 2^log_tile.
// Rows enter bit-reversed and leave in natural order.  Stage s uses
// tw[2^(s-1) - 1 + j] = w_{2^s}^j, j < 2^(s-1).
__device__ void butterflies(uint64_t* sm, int bits, int log_tile, int tp,
                            const uint64_t* __restrict__ tw) {
  const int tile_mask = (1 << log_tile) - 1;
  const int total = (1 << (bits - 1)) << log_tile;
  for (int s = 1; s <= bits; ++s) {
    const int half = 1 << (s - 1);
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
      const int t = idx & tile_mask;
      const int k = idx >> log_tile;
      const int j = k & (half - 1);
      const int r0 = ((k >> (s - 1)) << s) + j;
      const int r1 = r0 + half;
      const uint64_t u = sm[r0 * tp + t];
      const uint64_t v = gl::mul(sm[r1 * tp + t], tw[half - 1 + j]);
      sm[r0 * tp + t] = gl::add(u, v);
      sm[r1 * tp + t] = gl::sub(u, v);
    }
    __syncthreads();
  }
}

// B2.  Block b owns lanes [b·tile, (b+1)·tile) of the (n1, C·n2) view of x.
__global__ void __launch_bounds__(kThreads)
level_planar_kernel(const uint64_t* __restrict__ x,
                    const uint64_t* __restrict__ tw,
                    const uint64_t* __restrict__ lt, uint64_t* __restrict__ out,
                    int bits1, int log_n2, int log_tile) {
  extern __shared__ uint64_t sm[];
  const int n1 = 1 << bits1;
  const int tile = 1 << log_tile;
  const int tp = tile + 1;
  const long long n2 = 1ll << log_n2;
  const long long lane0 = (long long)blockIdx.x << log_tile;
  const long long c = lane0 >> log_n2;
  const long long i2_0 = lane0 & (n2 - 1);
  const uint64_t* xc = x + (c << (bits1 + log_n2)) + i2_0;
  const int total = n1 << log_tile;

  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int t = idx & (tile - 1);
    const int r = idx >> log_tile;
    sm[r * tp + t] = gl::canon(xc[((long long)brev(r, bits1) << log_n2) + t]);
  }
  __syncthreads();
  butterflies(sm, bits1, log_tile, tp, tw);

  // level twiddle w^(o1·i2): row pass, coalesced over the tile's lanes
  const uint64_t* ltc = lt + i2_0;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int t = idx & (tile - 1);
    const int o1 = idx >> log_tile;
    sm[o1 * tp + t] = gl::mul(sm[o1 * tp + t], ltc[((long long)o1 << log_n2) + t]);
  }
  __syncthreads();

  // transposed write: out[(lane0 + t)·n1 + o1], coalesced over o1
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int o1 = idx & (n1 - 1);
    const int t = idx >> bits1;
    out[((lane0 + t) << bits1) + o1] = sm[o1 * tp + t];
  }
}

// B3.  Block b owns column batch c and lanes [l0, l0 + tile) of (C·n2, n1).
__global__ void __launch_bounds__(kThreads)
base_grid_kernel(const uint64_t* __restrict__ y, const uint64_t* __restrict__ tw,
                 uint64_t* __restrict__ out, int bits2, int log_n1,
                 int log_tile) {
  extern __shared__ uint64_t sm[];
  const int tile = 1 << log_tile;
  const int tp = tile + 1;
  const int tiles_per_col = 1 << (log_n1 - log_tile);
  const long long c = blockIdx.x / tiles_per_col;
  const long long l0 = (long long)(blockIdx.x % tiles_per_col) << log_tile;
  const long long base = (c << (bits2 + log_n1)) + l0;
  const int total = (1 << bits2) << log_tile;

  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int t = idx & (tile - 1);
    const int r = idx >> log_tile;
    sm[r * tp + t] = gl::canon(y[base + ((long long)brev(r, bits2) << log_n1) + t]);
  }
  __syncthreads();
  if (bits2 > 0) butterflies(sm, bits2, log_tile, tp, tw);

  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int t = idx & (tile - 1);
    const int r = idx >> log_tile;
    out[base + ((long long)r << log_n1) + t] = sm[r * tp + t];
  }
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

// B1, radix regime: n = NA·NB = 2^(LA+LB) > 32 rows, LA, LB <= 6.  With
// i = i1·NB + i2 and o = o1 + NA·o2,
//   X[o] = Σ_i2 w_NB^(i2·o2) · w_n^(o1·i2) · Σ_i1 w_NA^(i1·o1) · x[i],
// in two launches of one kernel through a scratch array y:
//   pass 1: batch i2, y[o1·NB + i2] = w_n^(o1·i2) · Σ_i1 w_NA^(i1·o1) x[i1·NB + i2]
//   pass 2: batch o1, X[o1 + NA·o2] = Σ_i2 w_NB^(i2·o2) y[o1·NB + i2]
// (n = 64 takes pass 2's kernel alone).  Block (bx, b) owns lanes
// [bx·128, bx·128 + 128) of batch b: a thread holds the 2^LOG values of
// one lane at row stride in_row in registers, transforms them (dft: the
// stage twiddles are powers of two), multiplies by w_n^(o·b) with TW (the
// block's row, staged in shared memory from tw[k] = w_n^k, k < n/2: read
// straight from tw, ptxas loaded all 63 words up front and the pass lost
// a block per SM), and stores them at row stride out_row.
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
                      int n_mask) {
  const long long l = (long long)blockIdx.x * kPassThreads + threadIdx.x;
  const int b = blockIdx.y;
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
  load_rows<LOG, CANON>(v, x + b * in_batch + l, in_row,
                        std::make_integer_sequence<int, 1 << LOG>{});
  radix::dft<LOG, INV>(v);
  if constexpr (TW)
    twiddle_rows(v, row, std::make_integer_sequence<int, (1 << LOG) - 1>{});
  store_rows(out + b * out_batch + l, v, out_row, std::make_integer_sequence<int, 1 << LOG>{});
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

template <int LOG, bool INV, bool TW, bool CANON>
cudaError_t launch_pass(const uint64_t* x, const uint64_t* tw, uint64_t* out, long long lanes,
                        int batches, long long in_row, long long in_batch, long long out_row,
                        long long out_batch, int n_mask, cudaStream_t stream) {
  const long long blocks = (lanes + kPassThreads - 1) / kPassThreads;
  if (blocks > 0x7fffffffll) return cudaErrorInvalidConfiguration;
  base_rows_pass_kernel<LOG, INV, TW, CANON>
      <<<dim3((unsigned)blocks, batches), kPassThreads, 0, stream>>>(
          x, tw, out, lanes, in_row, in_batch, out_row, out_batch, n_mask);
  return cudaGetLastError();
}

// Pass 1 over NB batches of NA-point transforms, with the twiddle.
template <int LA, bool INV>
cudaError_t launch_pass1(const uint64_t* x, const uint64_t* tw, uint64_t* y, long long lanes,
                         int lb, cudaStream_t s) {
  const long long nb = 1ll << lb;
  return launch_pass<LA, INV, true, true>(x, tw, y, lanes, (int)nb, nb * lanes, lanes,
                                          nb * lanes, lanes, (1 << (LA + lb)) - 1, s);
}

// Pass 2 over NA batches of NB-point transforms (the whole transform when
// NA = 1, whose input is not canonical yet).
template <int LB, bool INV>
cudaError_t launch_pass2(const uint64_t* y, uint64_t* out, long long lanes, int la,
                         cudaStream_t s) {
  const long long na = 1ll << la, nb = 1ll << LB;
  return la == 0
      ? launch_pass<LB, INV, false, true>(y, nullptr, out, lanes, 1, lanes, 0, lanes, 0, 0, s)
      : launch_pass<LB, INV, false, false>(y, nullptr, out, lanes, (int)na, lanes, nb * lanes,
                                           na * lanes, lanes, 0, s);
}

template <bool INV>
cudaError_t launch_base_rows_radix(int bits, const uint64_t* x, const uint64_t* tw,
                                   uint64_t* y, uint64_t* out, long long lanes,
                                   cudaStream_t s) {
  const int la = bits - bits / 2, lb = bits / 2;
  cudaError_t e = cudaSuccess;
  if (bits > 6) {
    switch (la) {
      case 4: e = launch_pass1<4, INV>(x, tw, y, lanes, lb, s); break;
      case 5: e = launch_pass1<5, INV>(x, tw, y, lanes, lb, s); break;
      case 6: e = launch_pass1<6, INV>(x, tw, y, lanes, lb, s); break;
      default: return cudaErrorInvalidValue;
    }
    if (e != cudaSuccess) return e;
  } else {
    y = (uint64_t*)x;
  }
  switch (bits > 6 ? lb : bits) {
    case 3: return launch_pass2<3, INV>(y, out, lanes, la, s);
    case 4: return launch_pass2<4, INV>(y, out, lanes, la, s);
    case 5: return launch_pass2<5, INV>(y, out, lanes, la, s);
    case 6: return launch_pass2<6, INV>(y, out, lanes, bits > 6 ? la : 0, s);
    default: return cudaErrorInvalidValue;
  }
}

size_t smem_bytes(int row_bits, int log_tile) {
  return ((size_t)1 << row_bits) * ((size_t)(1 << log_tile) + 1) * sizeof(uint64_t);
}

}  // namespace

extern "C" int gl_level_planar(const void* x, const void* tw, const void* lt,
                               void* out, int bits1, int log_n2, int n_cols,
                               int log_tile, void* stream) {
  const size_t smem = smem_bytes(bits1, log_tile);
  cudaError_t e = cudaFuncSetAttribute(
      level_planar_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = ((long long)n_cols << log_n2) >> log_tile;
  level_planar_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint64_t*)x, (const uint64_t*)tw, (const uint64_t*)lt,
      (uint64_t*)out, bits1, log_n2, log_tile);
  return (int)cudaGetLastError();
}

extern "C" int gl_base_grid(const void* y, const void* tw, void* out, int bits2,
                            int log_n1, int n_cols, int log_tile, void* stream) {
  const size_t smem = smem_bytes(bits2, log_tile);
  cudaError_t e = cudaFuncSetAttribute(
      base_grid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)n_cols << (log_n1 - log_tile);
  base_grid_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint64_t*)y, (const uint64_t*)tw, (uint64_t*)out, bits2, log_n1,
      log_tile);
  return (int)cudaGetLastError();
}


// tw: the stage twiddles (bits <= kRegMaxBits) or w_n^k for k < n/2, the
// last stage's part of that table (above);
// y: a scratch array of n × lanes words for bits > 6 (else unused).
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
  return (int)(inverse ? launch_base_rows_radix<true>(bits, xi, twi, yi, o, lanes, s)
                       : launch_base_rows_radix<false>(bits, xi, twi, yi, o, lanes, s));
}
