// The xDivXSubXi table of the prove (T2).
//
// It does not replace a pallas_call.  The JAX package computes the table in
// one jitted elementwise program (pil2_stark_tpu/stark/device.py:349
// _jit_xdiv), which XLA fuses; this kernel is the port's counterpart of
// that fusion.  (T1, the TAC programs, is generated per program by
// ops/tac_codegen.py on csrc/f3.cuh.)
//
// T2 gl_xdiv: one thread per point x of the extended coset; for each
// opening o, out[o][c][i] = (x − xi_o)^-1 · x with the closed-form cubic
// inverse (field/torch_f3.py::inv) and one base-field inverse by an
// addition chain for p − 2 (64 squarings, 10 products); 0 maps to 0.
// That is 94 GL products per point and opening.  The function needs far
// fewer: the norm and adjugate of x − xi are polynomials in x, and one
// inverse serves a batch of points, so its bound is by bytes (8 read per
// point, 24 written per point and opening).
#include <cuda_runtime.h>
#include <cstdint>

#include "gl.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxOpenings = 16;

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  }
  return count;
}

// x^(p-2) = x^((2^31 - 1)·2^33 + 2^32 - 1); 0 -> 0
__device__ __forceinline__ uint64_t sqn(uint64_t x, int k) {
  for (int i = 0; i < k; ++i) x = gl::mul(x, x);
  return x;
}

__device__ uint64_t inv(uint64_t x) {
  const uint64_t t2 = gl::mul(sqn(x, 1), x);      // 2^2 - 1
  const uint64_t t4 = gl::mul(sqn(t2, 2), t2);    // 2^4 - 1
  const uint64_t t8 = gl::mul(sqn(t4, 4), t4);    // 2^8 - 1
  const uint64_t t16 = gl::mul(sqn(t8, 8), t8);   // 2^16 - 1
  const uint64_t t24 = gl::mul(sqn(t16, 8), t8);  // 2^24 - 1
  const uint64_t t28 = gl::mul(sqn(t24, 4), t4);  // 2^28 - 1
  const uint64_t t30 = gl::mul(sqn(t28, 2), t2);  // 2^30 - 1
  const uint64_t t31 = gl::mul(sqn(t30, 1), x);   // 2^31 - 1
  const uint64_t t32 = gl::mul(sqn(t31, 1), x);   // 2^32 - 1
  return gl::mul(sqn(t31, 33), t32);
}

struct Openings {
  uint64_t xi[3 * kMaxOpenings];
};

__global__ void __launch_bounds__(kThreads)
xdiv_kernel(const uint64_t* __restrict__ x_ext, Openings op, int n_open,
            uint64_t* __restrict__ out, long long n) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    const uint64_t x = x_ext[i];
    for (int o = 0; o < n_open; ++o) {
      // den = x - xi (field/torch_f3.py::sub, base - ext)
      const uint64_t a0 = gl::sub(x, op.xi[3 * o]);
      const uint64_t a1 = gl::sub(0, op.xi[3 * o + 1]);
      const uint64_t a2 = gl::sub(0, op.xi[3 * o + 2]);
      // closed-form inverse (field/torch_f3.py::inv)
      const uint64_t aa = gl::mul(a0, a0), ac = gl::mul(a0, a2), ba = gl::mul(a1, a0);
      const uint64_t bb = gl::mul(a1, a1), bc = gl::mul(a1, a2), cc = gl::mul(a2, a2);
      const uint64_t aaa = gl::mul(aa, a0), aac = gl::mul(aa, a2), abc = gl::mul(ba, a2);
      const uint64_t abb = gl::mul(ba, a1), acc = gl::mul(ac, a2), bbb = gl::mul(bb, a1);
      const uint64_t bcc = gl::mul(bc, a2), ccc = gl::mul(cc, a2);
      const uint64_t t = gl::sub(
          gl::add(gl::add(gl::add(abc, abc), abc), gl::add(abb, bcc)),
          gl::add(gl::add(gl::add(aaa, aac), gl::add(aac, acc)), gl::add(bbb, ccc)));
      const uint64_t tinv = inv(t);
      const uint64_t i1 =
          gl::mul(gl::sub(gl::add(bc, bb), gl::add(gl::add(aa, ac), gl::add(ac, cc))), tinv);
      const uint64_t i2 = gl::mul(gl::sub(ba, cc), tinv);
      const uint64_t i3 = gl::mul(gl::sub(gl::add(ac, cc), bb), tinv);
      uint64_t* p = out + (long long)3 * o * n + i;
      p[0] = gl::mul(i1, x);
      p[n] = gl::mul(i2, x);
      p[2 * n] = gl::mul(i3, x);
    }
  }
}

}  // namespace

extern "C" int gl_xdiv(const void* x_ext, const void* xis, int n_open, void* out,
                       long long n, void* stream) {
  if (n <= 0 || n_open <= 0 || n_open > kMaxOpenings) return (int)cudaErrorInvalidValue;
  Openings op{};
  const uint64_t* src = (const uint64_t*)xis;
  for (int i = 0; i < 3 * n_open; ++i) op.xi[i] = src[i];
  int per_sm = 0;
  cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, xdiv_kernel, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long resident = (long long)(per_sm > 0 ? per_sm : 1) * sm_count();
  if (blocks > resident) blocks = resident;
  xdiv_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)x_ext, op, n_open, (uint64_t*)out, n);
  return (int)cudaGetLastError();
}
