"""Kernel B1's radix regime (csrc/ntt.cu, csrc/ntt_radix.cuh) on the CPU.

* A plain-torch model of the kernel's decomposition, n = NA·NB: the split of
  ``cuda_ntt.radix_split``, NA-point transforms on power-of-two twiddles
  from ``pow2_exponents`` (each product by shifts and one reduction, as the
  kernel's) times w_n^(o1·i2) from ``radix_twiddles`` (the half table the
  wrapper hands the kernel, negated for k >= n/2) into a flat scratch
  array, then NB-point transforms, each pass at the kernel's own strides
  and batches.
  It must equal ``base_rows_plain`` for bits 1..12 at 1, 4 and 1001 lanes,
  in both directions.
* 2^e equals every stage twiddle of a transform of up to 64 points,
  forward and inverse.
* The header itself, built with the host's g++ through
  tests/tac_host_shim.h (on the host, f3.cuh's ops are gl.cuh's C++):
  radix::mul_pow2 against python ints for every e < 192 at values near 0,
  2^32, 2^63 and p; radix::tw_exp against ``pow2_exponents``; and
  radix::dft<LOG, INV> against ``base_rows_plain`` for LOG 0..6.
Tolerance: none, bit for bit."""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from pil2_stark_tpu_torch.field import gl64, torch_gl
from pil2_stark_tpu_torch.ops import cuda_ntt
from pil2_stark_tpu_torch.utils import cuda_build

P = gl64.P_INT
TESTS = Path(__file__).resolve().parent
VALUES = [0, 1, 2, (1 << 32) - 1, 1 << 32, (1 << 32) + 1, (1 << 63) - 1, 1 << 63,
          (1 << 63) + 1, P - (1 << 32), P - 2, P - 1]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch's threaded int64 ops are slow on a shared CPU (see
    tests/test_torch_ntt_rows.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(shape, seed):
    a = np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)
    flat = a.reshape(-1)
    k = min(len(VALUES), flat.size)
    flat[:k] = np.array(VALUES[:k], dtype=np.uint64)
    return a


def _times_pow2(v, e):
    """v·2^e mod p, 0 <= e < 192, by shifts as the kernel does it: e < 64 a
    128-bit shift and one reduction, 64 <= e < 96 as 2^(e−32) − 2^(e−64),
    e >= 96 as −2^(e−96)."""
    if e >= 96:
        return torch_gl.neg(_times_pow2(v, e - 96))
    if e >= 64:
        return torch_gl.sub(_times_pow2(v, e - 32), _times_pow2(v, e - 64))
    if e == 0:
        return v
    return torch_gl._reduce128(v << e, (v >> (64 - e)) & ((1 << e) - 1))


def _dft_pow2(v, log, inverse):
    """Radix-2 DIT along dim 0 of v (rows bit-reversed), every stage
    twiddle 2^e with e from pow2_exponents."""
    exps = cuda_ntt.pow2_exponents(log, inverse)
    n = 1 << log
    rest = v.shape[1:]
    for s in range(1, log + 1):
        half = 1 << (s - 1)
        u = v.reshape(n >> s, 2, half, -1)
        t = torch.stack([_times_pow2(u[:, 1, j], int(e))
                         for j, e in enumerate(exps[half - 1:2 * half - 1])], dim=1)
        v = torch.stack([torch_gl.add(u[:, 0], t), torch_gl.sub(u[:, 0], t)], dim=1)
    return v.reshape(n, *rest)


def _pass(x, log, inverse, lanes, batches, in_row, in_batch, out_row, out_batch, tw=None):
    """One launch of the pass kernel on flat arrays: thread (b, l) reads
    x[b·in_batch + brev(r)·in_row + l], r < 2^log, transforms, multiplies
    row o by tw[(o·b) mod n] if tw is given, writes out[b·out_batch +
    o·out_row + l]."""
    b = torch.arange(batches)[:, None, None]
    r = torch.as_tensor(cuda_ntt.bit_reverse_indices(log))[None, :, None]
    lane = torch.arange(lanes)[None, None, :]
    v = x[b * in_batch + r * in_row + lane].permute(1, 0, 2)  # (r, b, lane)
    v = _dft_pow2(v, log, inverse)
    o = torch.arange(1 << log)[:, None]
    if tw is not None:
        v = torch_gl.mul(v, tw[(o * torch.arange(batches)[None, :]) % tw.numel()][:, :, None])
    out = torch.zeros_like(x)
    out[b * out_batch + o[None, :, :] * out_row + lane] = v.permute(1, 0, 2)
    return out


def radix_model(x, bits, inverse):
    """B1 on an (n, L) int64 tensor as the kernel runs it: flat arrays, the
    kernel's strides and batches, a scratch array between the passes."""
    n, lanes = x.shape
    if bits <= 5:  # the register regime: one thread holds the lane
        return _dft_pow2(torch_gl.canon(x[cuda_ntt.bit_reverse_indices(bits)]), bits, inverse)
    la, lb = cuda_ntt.radix_split(bits)
    assert la <= 6 and lb <= 6 and la + lb == bits
    na, nb = 1 << la, 1 << lb
    flat = torch_gl.canon(x).reshape(-1)
    if la == 0:
        return _pass(flat, lb, inverse, lanes, 1, lanes, 0, lanes, 0).reshape(n, lanes)
    tw = cuda_ntt.radix_twiddles(bits, inverse, "cpu")  # w_n^k, k < n/2
    tw = torch.cat([tw, torch_gl.neg(tw)])  # the kernel's w_n^(k + n/2) = −w_n^k
    y = _pass(flat, la, inverse, lanes, nb, nb * lanes, lanes, nb * lanes, lanes, tw)
    return _pass(y, lb, inverse, lanes, na, lanes, nb * lanes, na * lanes, lanes).reshape(n, lanes)


def _input_and_forward(bits, lanes):
    """x (2^bits, lanes) with x[:, l] = base[:, l mod 7] + l, every lane
    distinct, and its forward transform from the plain version run on the
    (at most 7) base columns only: by linearity a lane's added constant l
    adds n·l to its row 0 and nothing else."""
    n = 1 << bits
    k = min(lanes, 7)
    base = torch_gl.from_u64(_rand((n, k), 17 * bits + lanes))
    cols = torch.arange(lanes) % k
    shift = torch_gl.from_u64(np.arange(lanes, dtype=np.uint64))
    x = torch_gl.add(base[:, cols], shift[None, :])
    want = cuda_ntt.base_rows_plain(base, bits, False)[:, cols]
    want[0] = torch_gl.add(want[0], torch_gl.mul(shift, n))
    return x, want


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("lanes", [1, 4, 1001])
def test_radix_model_equals_plain(lanes, inverse):
    """Against the plain version (run on all lanes where that is cheap);
    the inverse transform is the forward one at rows (n − o) mod n."""
    for bits in range(1, 13):
        x, want = _input_and_forward(bits, lanes)
        if inverse:
            want = want[(-torch.arange(1 << bits)) % (1 << bits)]
        if bits <= 6 or lanes <= 4:
            assert torch.equal(want, cuda_ntt.base_rows_plain(x, bits, inverse)), f"bits {bits}"
        assert torch.equal(radix_model(x, bits, inverse), want), f"bits {bits}"


@pytest.mark.parametrize("inverse", [False, True])
def test_pow2_exponents_are_the_stage_twiddles(inverse):
    for bits in range(1, 7):
        exps = cuda_ntt.pow2_exponents(bits, inverse)
        assert exps.min() >= 0 and exps.max() < 192
        want = cuda_ntt.stage_twiddles_u64(bits, inverse)
        assert [pow(2, int(e), P) for e in exps] == [int(w) for w in want]


HOST_SOURCE = """\
#include "tac_host_shim.h"
#include "ntt_radix.cuh"

namespace {
template <int E>
uint64_t times_pow2(uint64_t x) {  // x·2^E, E < 192, as butterfly takes it
  if constexpr (E == 0) return x;
  else if constexpr (E == 96) return gl::sub(0, x);
  else if constexpr (E < 96) return radix::mul_pow2<E>(x);
  else return gl::sub(0, radix::mul_pow2<E - 96>(x));
}
template <int... E>
void all_pow2(const uint64_t* x, int n, uint64_t* out, std::integer_sequence<int, E...>) {
  ((void)[&] { for (int i = 0; i < n; ++i) out[E * n + i] = times_pow2<E>(x[i]); }(), ...);
}
template <int LOG, bool INV>
void dft_rows(uint64_t* v, long long count) {
  for (long long c = 0; c < count; ++c) radix::dft<LOG, INV>(v + (c << LOG));
}
}  // namespace

extern "C" void mul_pow2_all(const uint64_t* x, int n, uint64_t* out) {
  all_pow2(x, n, out, std::make_integer_sequence<int, 192>{});
}

extern "C" int tw_exps(int bits, int inverse, int* out) {
  int k = 0;
  for (int s = 1; s <= bits; ++s)
    for (int j = 0; j < (1 << (s - 1)); ++j) out[k++] = radix::tw_exp(s, j, inverse != 0);
  return k;
}

// count transforms of 2^log values each, bit-reversed in, natural out
extern "C" int dft(int log, int inverse, uint64_t* v, long long count) {
#define DFT_CASE(L) \\
  case L: inverse ? dft_rows<L, true>(v, count) : dft_rows<L, false>(v, count); return 0;
  switch (log) {
    DFT_CASE(0) DFT_CASE(1) DFT_CASE(2) DFT_CASE(3) DFT_CASE(4) DFT_CASE(5) DFT_CASE(6)
  }
  return 1;
}
"""


@pytest.fixture(scope="module")
def header(tmp_path_factory):
    """csrc/ntt_radix.cuh built with the host's g++ into a shared library."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    root = tmp_path_factory.mktemp("ntt_radix")
    src = root / "ntt_radix_host.cpp"
    src.write_text(HOST_SOURCE)
    lib = root / "ntt_radix_host.so"
    cmd = [gxx, "-std=c++17", "-O0", "-shared", "-fPIC", "-I", str(cuda_build.CSRC),
           "-I", str(TESTS), "-o", str(lib), str(src)]
    out = subprocess.run(cmd, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-4000:]
    h = ctypes.CDLL(str(lib))
    vp = ctypes.c_void_p
    h.mul_pow2_all.argtypes = [vp, ctypes.c_int, vp]
    h.tw_exps.argtypes = [ctypes.c_int, ctypes.c_int, vp]
    h.tw_exps.restype = ctypes.c_int
    h.dft.argtypes = [ctypes.c_int, ctypes.c_int, vp, ctypes.c_longlong]
    h.dft.restype = ctypes.c_int
    return h


def test_mul_pow2_equals_python_ints(header):
    xs = sorted({v % P for c in (0, 1 << 32, 1 << 63, P) for d in range(-3, 4)
                 for v in [c + d]})
    x = np.array(xs, dtype=np.uint64)
    out = np.zeros((192, len(xs)), dtype=np.uint64)
    header.mul_pow2_all(x.ctypes.data, len(xs), out.ctypes.data)
    want = [[v * pow(2, e, P) % P for v in xs] for e in range(192)]
    assert out.tolist() == want


@pytest.mark.parametrize("inverse", [False, True])
def test_tw_exp_equals_the_wrappers_table(header, inverse):
    for bits in range(1, 7):
        got = np.zeros(1 << bits, dtype=np.int32)
        k = header.tw_exps(bits, int(inverse), got.ctypes.data)
        assert got[:k].tolist() == cuda_ntt.pow2_exponents(bits, inverse).tolist()


@pytest.mark.parametrize("inverse", [False, True])
def test_header_dft_equals_plain(header, inverse):
    lanes = 7
    for log in range(0, 7):
        x = _rand((1 << log, lanes), 5 + log)
        v = np.ascontiguousarray(x[cuda_ntt.bit_reverse_indices(log)].T)  # lane-major
        assert header.dft(log, int(inverse), v.ctypes.data, lanes) == 0
        if log == 0:
            np.testing.assert_array_equal(v.T, x)
            continue
        want = torch_gl.to_u64(cuda_ntt.base_rows_plain(torch_gl.from_u64(x), log, inverse))
        np.testing.assert_array_equal(v.T, want, err_msg=f"log {log}")
