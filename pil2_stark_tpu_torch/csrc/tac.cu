// The prove's constraint and FRI arithmetic: a TAC program evaluated row
// by row (T1) and the xDivXSubXi table (T2).
//
// Neither replaces a pallas_call.  The JAX package traces each TAC program
// into one XLA computation (pil2_stark_tpu/ops/jax_tac.py:53
// make_executor), which XLA fuses, and the xDivXSubXi table into one
// jitted elementwise program (pil2_stark_tpu/stark/device.py:349
// _jit_xdiv).  These two kernels are the port's counterparts of those
// fusions.
//
// T1 tac_eval.  ops/torch_tac.py compiles a program into instructions of
// five 64-bit words: a head (op | result dim << 8), the dest and up to
// three sources.  An operand word is kind | dim << 2 | index << 8 |
// shift << 32, the kind one of
//   slot    a per-thread temporary (3 words, the value's first dim used);
//   col     a column: cols[index] is the device address of its first
//           component, component c sits n words further on (planar
//           sections, the (nOpenings, 3, N) xDivXSubXi table and written
//           buffers all have that layout); row i reads row (i + shift) mod n;
//   scalar  scalars[index .. index + dim).
// A dest is a slot or a col (a written buffer): row i's value goes to row
// (i + shift) mod n, a dim-1 value stored to a dim-3 buffer zero-padded.
// Mixed dims follow field/torch_f3.py: base + ext touches component 0
// only, base - ext negates components 1 and 2, base × ext is the scalar
// action.  Every field op is canonical, so the values equal the plain
// version's bit for bit whatever the order of operations.
//
// Structure: one thread per row, grid-stride, 64-bit offsets.  A block
// copies the instructions, the column table and the scalar table into
// shared memory once; each instruction is then decoded from uniform
// shared-memory words, and each column load is coalesced across the warp.
// The slots are a per-thread array of 3 × NSLOT words indexed at run time,
// so they live in local memory (L1); the kernel is compiled for NSLOT = 8,
// 16, 32 and 64 and the compiler assigns slots by liveness, so NSLOT is the
// program's peak of live temporaries rounded up.
//
// Bound on the H100: bytes for the programs of the committed machines
// (each column read once, each output written once; a few GL products per
// word moved), except where a program's products outnumber its columns.
// This first version interprets the program per row; fusion across rows
// and lazy reductions are left for later.
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
constexpr int kWords = 5;
constexpr int kMaxOpenings = 16;

enum { OP_COPY = 0, OP_ADD = 1, OP_SUB = 2, OP_MUL = 3, OP_MULADD = 4 };
enum { K_SLOT = 0, K_COL = 1, K_SCALAR = 2 };  // kind 3 marks an unused source

__device__ __forceinline__ int f3_add(const uint64_t* a, int da, const uint64_t* b, int db,
                                      uint64_t* r) {
  r[0] = gl::add(a[0], b[0]);
  if (da == 3 && db == 3) {
    r[1] = gl::add(a[1], b[1]);
    r[2] = gl::add(a[2], b[2]);
  } else if (da == 3) {
    r[1] = a[1];
    r[2] = a[2];
  } else if (db == 3) {
    r[1] = b[1];
    r[2] = b[2];
  } else {
    return 1;
  }
  return 3;
}

__device__ __forceinline__ int f3_sub(const uint64_t* a, int da, const uint64_t* b, int db,
                                      uint64_t* r) {
  r[0] = gl::sub(a[0], b[0]);
  if (da == 3 && db == 3) {
    r[1] = gl::sub(a[1], b[1]);
    r[2] = gl::sub(a[2], b[2]);
  } else if (da == 3) {
    r[1] = a[1];
    r[2] = a[2];
  } else if (db == 3) {
    r[1] = gl::sub(0, b[1]);
    r[2] = gl::sub(0, b[2]);
  } else {
    return 1;
  }
  return 3;
}

// Karatsuba with x^3 = x + 1 (field/torch_f3.py::mul)
__device__ __forceinline__ void f3_mul33(const uint64_t* a, const uint64_t* b, uint64_t* r) {
  const uint64_t A = gl::mul(gl::add(a[0], a[1]), gl::add(b[0], b[1]));
  const uint64_t B = gl::mul(gl::add(a[0], a[2]), gl::add(b[0], b[2]));
  const uint64_t C = gl::mul(gl::add(a[1], a[2]), gl::add(b[1], b[2]));
  const uint64_t D = gl::mul(a[0], b[0]);
  const uint64_t E = gl::mul(a[1], b[1]);
  const uint64_t F = gl::mul(a[2], b[2]);
  const uint64_t G = gl::sub(D, E);
  r[0] = gl::sub(gl::add(C, G), F);
  r[1] = gl::sub(gl::sub(gl::add(A, C), gl::add(E, E)), D);
  r[2] = gl::sub(B, G);
}

__device__ __forceinline__ int f3_mul(const uint64_t* a, int da, const uint64_t* b, int db,
                                      uint64_t* r) {
  if (da == 3 && db == 3) {
    f3_mul33(a, b, r);
  } else if (da == 3) {
    r[0] = gl::mul(a[0], b[0]);
    r[1] = gl::mul(a[1], b[0]);
    r[2] = gl::mul(a[2], b[0]);
  } else if (db == 3) {
    r[0] = gl::mul(a[0], b[0]);
    r[1] = gl::mul(a[0], b[1]);
    r[2] = gl::mul(a[0], b[2]);
  } else {
    r[0] = gl::mul(a[0], b[0]);
    return 1;
  }
  return 3;
}

struct Ctx {
  const uint64_t* cols;  // device addresses
  const uint64_t* scalars;
  long long n;
  long long row;
};

__device__ __forceinline__ long long shifted(const Ctx& c, uint64_t w) {
  long long r = c.row + (long long)(w >> 32);
  return r >= c.n ? r - c.n : r;
}

__device__ __forceinline__ int load(const Ctx& c, const uint64_t* slots, uint64_t w,
                                    uint64_t* v) {
  const int kind = (int)(w & 3);
  const int d = (int)((w >> 2) & 3);
  const unsigned idx = (unsigned)((w >> 8) & 0xFFFFFF);
  const uint64_t* p;
  long long stride = 1;
  if (kind == K_SLOT) {
    p = slots + 3 * idx;
  } else if (kind == K_COL) {
    p = reinterpret_cast<const uint64_t*>(c.cols[idx]) + shifted(c, w);
    stride = c.n;
  } else {
    p = c.scalars + idx;
  }
  v[0] = p[0];
  if (d == 3) {
    v[1] = p[stride];
    v[2] = p[2 * stride];
  }
  return d;
}

__device__ __forceinline__ void store(const Ctx& c, uint64_t* slots, uint64_t w,
                                      const uint64_t* r, int dr) {
  if ((w & 3) == K_SLOT) {
    uint64_t* p = slots + 3 * (unsigned)((w >> 8) & 0xFFFFFF);
    p[0] = r[0];
    if (dr == 3) {
      p[1] = r[1];
      p[2] = r[2];
    }
    return;
  }
  const int d = (int)((w >> 2) & 3);
  uint64_t* p = reinterpret_cast<uint64_t*>(c.cols[(w >> 8) & 0xFFFFFF]) + shifted(c, w);
  p[0] = r[0];
  if (d == 3) {
    p[c.n] = dr == 3 ? r[1] : 0;
    p[2 * c.n] = dr == 3 ? r[2] : 0;
  }
}

template <int NSLOT>
__global__ void __launch_bounds__(kThreads)
tac_kernel(const uint64_t* __restrict__ prog, int n_ins, const uint64_t* __restrict__ cols,
           int n_cols, const uint64_t* __restrict__ scalars, int n_scalars, long long n) {
  extern __shared__ uint64_t sm[];
  uint64_t* s_prog = sm;
  uint64_t* s_cols = sm + (size_t)kWords * n_ins;
  uint64_t* s_scal = s_cols + n_cols;
  for (int i = threadIdx.x; i < kWords * n_ins; i += blockDim.x) s_prog[i] = prog[i];
  for (int i = threadIdx.x; i < n_cols; i += blockDim.x) s_cols[i] = cols[i];
  for (int i = threadIdx.x; i < n_scalars; i += blockDim.x) s_scal[i] = scalars[i];
  __syncthreads();

  uint64_t slots[3 * NSLOT];
  Ctx c{s_cols, s_scal, n, 0};
  const long long step = (long long)gridDim.x * blockDim.x;
  for (c.row = (long long)blockIdx.x * blockDim.x + threadIdx.x; c.row < n; c.row += step) {
    for (int k = 0; k < n_ins; ++k) {
      const uint64_t* ins = s_prog + kWords * k;
      const int op = (int)(ins[0] & 0xFF);
      uint64_t a[3], b[3], r[3];
      int da = load(c, slots, ins[2], a);
      int dr;
      if (op == OP_COPY) {
        r[0] = a[0];
        r[1] = a[1];
        r[2] = a[2];
        dr = da;
      } else {
        const int db = load(c, slots, ins[3], b);
        if (op == OP_ADD) {
          dr = f3_add(a, da, b, db, r);
        } else if (op == OP_SUB) {
          dr = f3_sub(a, da, b, db, r);
        } else {
          dr = f3_mul(a, da, b, db, r);
          if (op == OP_MULADD) {
            const int dc = load(c, slots, ins[4], b);
            a[0] = r[0];
            a[1] = r[1];
            a[2] = r[2];
            dr = f3_add(a, dr, b, dc, r);
          }
        }
      }
      store(c, slots, ins[1], r, dr);
    }
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  }
  return count;
}

template <int NSLOT>
cudaError_t launch_tac(const uint64_t* prog, int n_ins, const uint64_t* cols, int n_cols,
                       const uint64_t* scalars, int n_scalars, long long n,
                       cudaStream_t stream) {
  const size_t smem = sizeof(uint64_t) * ((size_t)kWords * n_ins + n_cols + n_scalars);
  cudaError_t e = cudaFuncSetAttribute(
      tac_kernel<NSLOT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tac_kernel<NSLOT>, kThreads,
                                                    smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long resident = (long long)per_sm * sm_count();
  if (blocks > resident) blocks = resident;
  tac_kernel<NSLOT><<<(unsigned)blocks, kThreads, smem, stream>>>(
      prog, n_ins, cols, n_cols, scalars, n_scalars, n);
  return cudaGetLastError();
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

extern "C" int tac_eval(const void* prog, int n_ins, const void* cols, int n_cols,
                        const void* scalars, int n_scalars, long long n, int slot_cap,
                        void* stream) {
  if (n <= 0 || n_ins <= 0) return (int)cudaErrorInvalidValue;
  const uint64_t* p = (const uint64_t*)prog;
  const uint64_t* cl = (const uint64_t*)cols;
  const uint64_t* sc = (const uint64_t*)scalars;
  cudaStream_t s = (cudaStream_t)stream;
  switch (slot_cap) {
    case 8: return (int)launch_tac<8>(p, n_ins, cl, n_cols, sc, n_scalars, n, s);
    case 16: return (int)launch_tac<16>(p, n_ins, cl, n_cols, sc, n_scalars, n, s);
    case 32: return (int)launch_tac<32>(p, n_ins, cl, n_cols, sc, n_scalars, n, s);
    case 64: return (int)launch_tac<64>(p, n_ins, cl, n_cols, sc, n_scalars, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

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
