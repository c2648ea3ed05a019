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
// load (the JAX path runs it as a separate jnp.take), run the radix-2 DIT
// network on values held on chip, and write canonical values (the TPU B3
// leaves lazy values; these do not).  The inverse transform runs the
// inverted roots and leaves out 1/n, which the caller folds in.
//
// Bound on the H100: bytes.  Each kernel reads its input once and writes
// its output once (B2 also reads the (n1, n2) level-twiddle table); the
// butterflies cost log2(n)/2 GL multiplies per element, far below the
// integer multiply rate.  The design does one global read and one global
// write per element: a block holds a (rows × tile) tile in shared memory
// (tile adjacent lanes, so global loads and stores are coalesced; each row
// padded by one word so the transposed B2 write is free of bank
// conflicts), and all log2(n) stages run there between __syncthreads.
// B1 with n <= 32 (the FRI folds have n = 8, the 2^25 route a 2-point
// base) needs no shared memory: one thread owns one lane, holds its n
// values in registers and runs every stage there, and a warp's loads and
// stores of a row are 32 adjacent words.  Larger n take B3's shared tile,
// whose lane count is masked at the ragged edge since L need not be a
// power of two (the FRI folds transform 3·2^k lanes).  Offsets are 64-bit:
// the 2-point base of a 2^25 transform spans 3·2^25 words.
#include <cuda_runtime.h>
#include <cstdint>

#include "gl.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kRowThreads = 256;  // B1's register regime
constexpr int kRegMaxBits = 5;    // B1 keeps n <= 2^5 values per thread

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

// B1, shared regime: block b owns lanes [b·tile, (b+1)·tile) of (n, lanes);
// lanes past the end load as zero and are not stored.
__global__ void __launch_bounds__(kThreads)
base_rows_smem_kernel(const uint64_t* __restrict__ x,
                      const uint64_t* __restrict__ tw,
                      uint64_t* __restrict__ out, int bits, long long lanes,
                      int log_tile) {
  extern __shared__ uint64_t sm[];
  const int tile = 1 << log_tile;
  const int tp = tile + 1;
  const long long l0 = (long long)blockIdx.x << log_tile;
  const int total = (1 << bits) << log_tile;

  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int t = idx & (tile - 1);
    const int r = idx >> log_tile;
    const long long l = l0 + t;
    sm[r * tp + t] =
        l < lanes ? gl::canon(x[(long long)brev(r, bits) * lanes + l]) : 0;
  }
  __syncthreads();
  butterflies(sm, bits, log_tile, tp, tw);

  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int t = idx & (tile - 1);
    const int r = idx >> log_tile;
    const long long l = l0 + t;
    if (l < lanes) out[(long long)r * lanes + l] = sm[r * tp + t];
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

extern "C" int gl_base_rows(const void* x, const void* tw, void* out, int bits,
                            long long lanes, int log_tile, void* stream) {
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
  const size_t smem = smem_bytes(bits, log_tile);
  cudaError_t e = cudaFuncSetAttribute(
      base_rows_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (lanes + (1ll << log_tile) - 1) >> log_tile;
  if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidConfiguration;
  base_rows_smem_kernel<<<(unsigned)blocks, kThreads, smem, s>>>(
      xi, twi, o, bits, lanes, log_tile);
  return (int)cudaGetLastError();
}
