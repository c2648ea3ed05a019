// Host runtime of the PyTorch/CUDA port: Goldilocks vector arithmetic, a
// batched Poseidon permutation, the linear hash and Merkle levels, in C++
// with a C interface.  A copy of the JAX package's runtime/pil2stark_runtime.cpp,
// itself the counterpart of pil2-stark-js src/helpers/glwasm.js (Goldilocks
// mul/reduce, poseidon, linearHash, merkelizeLevel).
//
// utils/host_build.py compiles it with the host's C++ compiler into
// _build/host/ at first use; runtime/native.py loads it with ctypes.  It
// serves the host paths that do not belong on the card: the Fiat-Shamir
// transcript, Merkle path verification and host trees
// (hash/transcript.py, hash/merkle.py).
//
// Semantics are bit-identical to field/gl64.py and hash/poseidon_gl.py
// (the plain versions the tests hold it against).

#include <cstdint>
#include <cstring>
#include <cstddef>

#include "poseidon_constants.h"

namespace {

constexpr uint64_t P = 0xFFFFFFFF00000001ULL;
constexpr uint64_t EPSILON = 0xFFFFFFFFULL;  // 2^64 mod p

inline uint64_t gl_add(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  if (s < a) {  // wrapped: add 2^64 mod p
    s += EPSILON;
  }
  if (s >= P) s -= P;
  return s;
}

inline uint64_t gl_sub(uint64_t a, uint64_t b) {
  uint64_t d = a - b;
  if (a < b) d -= EPSILON;  // borrow: subtract 2^64 mod p
  return d;
}

inline uint64_t gl_reduce128(__uint128_t x) {
  uint64_t lo = (uint64_t)x;
  uint64_t hi = (uint64_t)(x >> 64);
  uint64_t hi_hi = hi >> 32;
  uint64_t hi_lo = hi & 0xFFFFFFFFULL;
  // t0 = lo - hi_hi (mod p adjustments), t1 = hi_lo * EPSILON
  uint64_t t0 = lo - hi_hi;
  if (lo < hi_hi) t0 -= EPSILON;
  uint64_t t1 = hi_lo * EPSILON;
  uint64_t t2 = t0 + t1;
  if (t2 < t0) t2 += EPSILON;
  if (t2 >= P) t2 -= P;
  return t2;
}

inline uint64_t gl_mul(uint64_t a, uint64_t b) {
  return gl_reduce128((__uint128_t)a * b);
}

constexpr int T = 12;
constexpr int HALF_F = 4;
constexpr int RP = 22;

inline void pow7_all(uint64_t* s, int n) {
  for (int i = 0; i < n; i++) {
    uint64_t x = s[i];
    uint64_t x2 = gl_mul(x, x);
    uint64_t x3 = gl_mul(x2, x);
    uint64_t x4 = gl_mul(x2, x2);
    s[i] = gl_mul(x4, x3);
  }
}

inline void mat_mul(uint64_t* s, const uint64_t* m) {
  // out_i = sum_j s_j * m[j*T + i]
  uint64_t out[T] = {0};
  for (int j = 0; j < T; j++) {
    uint64_t sj = s[j];
    if (sj == 0) continue;
    const uint64_t* row = m + j * T;
    for (int i = 0; i < T; i++) {
      out[i] = gl_add(out[i], gl_mul(sj, row[i]));
    }
  }
  std::memcpy(s, out, sizeof(out));
}

void poseidon_permute_one(uint64_t* st) {
  for (int i = 0; i < T; i++) st[i] = gl_add(st[i], POSEIDON_C[i]);

  for (int r = 0; r < HALF_F - 1; r++) {
    pow7_all(st, T);
    for (int i = 0; i < T; i++)
      st[i] = gl_add(st[i], POSEIDON_C[(r + 1) * T + i]);
    mat_mul(st, POSEIDON_M);
  }
  pow7_all(st, T);
  for (int i = 0; i < T; i++)
    st[i] = gl_add(st[i], POSEIDON_C[HALF_F * T + i]);
  mat_mul(st, POSEIDON_P);

  for (int r = 0; r < RP; r++) {
    uint64_t x0 = st[0];
    uint64_t x2 = gl_mul(x0, x0);
    uint64_t x3 = gl_mul(x2, x0);
    uint64_t x4 = gl_mul(x2, x2);
    x0 = gl_mul(x4, x3);
    x0 = gl_add(x0, POSEIDON_C[(HALF_F + 1) * T + r]);
    st[0] = x0;
    const uint64_t* srow = POSEIDON_S + (2 * T - 1) * r;
    uint64_t new0 = 0;
    for (int j = 0; j < T; j++) new0 = gl_add(new0, gl_mul(st[j], srow[j]));
    for (int k = 1; k < T; k++)
      st[k] = gl_add(st[k], gl_mul(x0, srow[T + k - 1]));
    st[0] = new0;
  }

  int base = (HALF_F + 1) * T + RP;
  for (int r = 0; r < HALF_F - 1; r++) {
    pow7_all(st, T);
    for (int i = 0; i < T; i++)
      st[i] = gl_add(st[i], POSEIDON_C[base + r * T + i]);
    mat_mul(st, POSEIDON_M);
  }
  pow7_all(st, T);
  mat_mul(st, POSEIDON_M);
}

}  // namespace

extern "C" {

void gl64_add_vec(const uint64_t* a, const uint64_t* b, uint64_t* out, size_t n) {
  for (size_t i = 0; i < n; i++) out[i] = gl_add(a[i], b[i]);
}

void gl64_sub_vec(const uint64_t* a, const uint64_t* b, uint64_t* out, size_t n) {
  for (size_t i = 0; i < n; i++) out[i] = gl_sub(a[i], b[i]);
}

void gl64_mul_vec(const uint64_t* a, const uint64_t* b, uint64_t* out, size_t n) {
  for (size_t i = 0; i < n; i++) out[i] = gl_mul(a[i], b[i]);
}

// In-place batched Poseidon permutation over (n, 12) states.
void poseidon_permute_batch(uint64_t* states, size_t n) {
  for (size_t i = 0; i < n; i++) poseidon_permute_one(states + i * T);
}

// Linear hash of (height, width) rows into (height, 4) digests
// (linearhash.js semantics: width<=4 copied, else 8-element absorb with
// 4-element chaining capacity).
void linear_hash(const uint64_t* rows, size_t height, size_t width, uint64_t* out) {
  if (width <= 4) {
    for (size_t i = 0; i < height; i++) {
      for (size_t j = 0; j < 4; j++)
        out[i * 4 + j] = j < width ? rows[i * width + j] : 0;
    }
    return;
  }
  size_t n_chunks = (width + 7) / 8;
  for (size_t i = 0; i < height; i++) {
    uint64_t cap[4] = {0, 0, 0, 0};
    for (size_t c = 0; c < n_chunks; c++) {
      uint64_t st[T];
      for (size_t j = 0; j < 8; j++) {
        size_t col = c * 8 + j;
        st[j] = col < width ? rows[i * width + col] : 0;
      }
      std::memcpy(st + 8, cap, 4 * sizeof(uint64_t));
      poseidon_permute_one(st);
      std::memcpy(cap, st, 4 * sizeof(uint64_t));
    }
    std::memcpy(out + i * 4, cap, 4 * sizeof(uint64_t));
  }
}

// One Merkle level: hash n_out pairs of 4-element digests (in has
// 2*n_out digests) into n_out digests.
void merkle_level(const uint64_t* in, size_t n_out, uint64_t* out) {
  for (size_t i = 0; i < n_out; i++) {
    uint64_t st[T];
    std::memcpy(st, in + i * 8, 8 * sizeof(uint64_t));
    std::memset(st + 8, 0, 4 * sizeof(uint64_t));
    poseidon_permute_one(st);
    std::memcpy(out + i * 4, st, 4 * sizeof(uint64_t));
  }
}

}  // extern "C"
