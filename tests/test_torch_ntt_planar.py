"""Kernels B2 and B3 of the planar four-step NTT (csrc/ntt.cu) on the CPU.

A plain-torch model of the kernels' decomposition, at their own strides,
batches and grids, on flat arrays:

* B3 (``gl_base_grid``) is B1's radix passes with a column stride of
  n2·n1 words: above 2^6 rows pass 1 (NA-point transforms on power-of-two
  twiddles, times w_n2^(oa·ib) from ``radix_twiddles``) into a scratch
  array and pass 2 (NB-point transforms); up to 2^6 rows pass 2 alone,
  canonicalising on load.
* B2 (``gl_level_planar``) is B1's pass 1 along the strided i1 axis (row
  stride n2) into a scratch array, then ``level_pass_kernel``: NB-point
  transforms, the level twiddle lt[o1, i2] (up to NB = 16 formed as
  lt[oa, i2]·lt[NA, i2]^ob, a product a step) and the staged transposed
  store, modelled block by block: each thread's values go to shared
  memory at [t][ob][a] (rows of NB·TA + 1 words) and the block's 128
  threads store them in NB rounds at out[(c·n2 + i2)·n1 + o1].  Up to
  n1 = 2^6 that pass alone, on x.

The model runs the blocks of a few lane tiles (the first two and the last)
and must equal ``level_planar_plain`` / ``base_grid_plain`` bit for bit on
those lanes (every lane is its own transform in both, so the plain version
of the lanes' sub-array gives the same rows), leaving every other word of
its output untouched, for bits1 in {1, 4, 6, 7, 10} with n2 = 2^12, C in
{1, 3}, both directions, on values that are not all canonical.
Then csrc/ntt.cu itself, built with the host's g++ through
tests/ntt_host_shim.h (blocks in turn, a block's threads as std::threads
meeting at a barrier): B2 then B3 with one scratch array and B3
writing over B2's output, the single transform of up to 2^12
points and B1, each against its plain version, with the launches counted.
Tolerance: none, bit for bit."""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from pil2_stark_tpu_torch.field import gl64, torch_gl
from pil2_stark_tpu_torch.ops import cuda_ntt, ntt
from pil2_stark_tpu_torch.utils import cuda_build
from test_torch_ntt_radix import _dft_pow2

P = gl64.P_INT
THREADS = 128  # csrc/ntt.cu kPassThreads
LEVEL_OA = cuda_ntt.LEVEL_OA
SENTINEL = -12345


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch's threaded int64 ops are slow on a shared CPU (see
    tests/test_torch_ntt_rows.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _input(shape, seed):
    """u64 values, a quarter of them at or above p (the kernels and the
    plain versions take any u64 as its residue)."""
    a = np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)
    flat = a.reshape(-1)
    flat[::4] = np.random.default_rng(seed + 1).integers(P, 1 << 64, size=flat[::4].shape,
                                                         dtype=np.uint64)
    k = min(4, flat.size)
    flat[:k] = [0, 1, P - 1, P - 2][:k]
    return torch_gl.from_u64(a)


def _twiddle_table(bits, inverse):
    """w_n^k for all k < n as pass 1 forms it from the half table the
    wrappers hand the kernel (w_n^(k + n/2) = −w_n^k)."""
    tw = cuda_ntt.radix_twiddles(bits, inverse, "cpu")
    return torch.cat([tw, torch_gl.neg(tw)])


def _pass(x, out, log, inverse, lanes, batches, cols, col, in_row, in_batch, out_row,
          out_batch, canon, tw=None):
    """One launch of base_rows_pass_kernel on flat arrays, for the given
    lanes: thread (lane l, batch b, column c) reads x[c·col + b·in_batch +
    brev(r)·in_row + l], r < 2^log, transforms, multiplies row o by
    tw[(o·b) mod n] if tw is given and writes out[c·col + b·out_batch +
    o·out_row + l]."""
    c = torch.arange(cols)[:, None, None, None]
    b = torch.arange(batches)[None, :, None, None]
    r = torch.as_tensor(cuda_ntt.bit_reverse_indices(log))[None, None, :, None]
    lane = lanes[None, None, None, :]
    v = x[c * col + b * in_batch + r * in_row + lane]  # (c, b, r, lane)
    if canon:
        v = torch_gl.canon(v)
    v = _dft_pow2(v.permute(2, 0, 1, 3), log, inverse).permute(1, 2, 0, 3)
    o = torch.arange(1 << log)[None, None, :, None]
    if tw is not None:
        v = torch_gl.mul(v, tw[(o * b) % tw.numel()])
    out[c * col + b * out_batch + o * out_row + lane] = v
    return out


def _rows(x, bits, inverse, lanes, n_lanes, cols, col, scratch, out):
    """B1's transform of every column's 2^bits rows (csrc/ntt.cu
    launch_radix), at row stride n_lanes."""
    la, lb = cuda_ntt.radix_split(bits)
    if la == 0:
        return _pass(x, out, lb, inverse, lanes, 1, cols, col, n_lanes, 0, n_lanes, 0, True)
    nb = 1 << lb
    _pass(x, scratch, la, inverse, lanes, nb, cols, col, nb * n_lanes, n_lanes, nb * n_lanes,
          n_lanes, True, _twiddle_table(bits, inverse))
    return _pass(scratch, out, lb, inverse, lanes, 1 << la, cols, col, n_lanes, nb * n_lanes,
                 (1 << la) * n_lanes, n_lanes, False)


def _level_pass(src, lt, out, la, lb, log_n2, cols, inverse, canon, zs):
    """level_pass_kernel's blocks (c, g, z) for z in zs: loads, transforms
    and scales per thread, stages in a shared array per block, stores."""
    ta = LEVEL_OA if la else 1
    tl, nb, srow = THREADS // ta, 1 << lb, (1 << lb) * ta + 1
    log_n1, n2 = la + lb, 1 << log_n2
    c = torch.arange(cols)[:, None, None, None, None]
    g = torch.arange((1 << la) // ta)[None, :, None, None, None]
    z = torch.as_tensor(zs)[None, None, :, None, None]
    thread = torch.arange(THREADS)[None, None, None, :, None]
    t, a = thread % tl, thread // tl
    i2, oa = z * tl + t, g * ta + a
    assert bool((i2 < n2).all())  # n2 = 2^12: every lane of these blocks is live
    r = torch.as_tensor(cuda_ntt.bit_reverse_indices(lb))
    v = src[(c << (log_n1 + log_n2)) + (oa << (lb + log_n2)) + i2 + r * n2]  # (..., r)
    if canon:
        v = torch_gl.canon(v)
    v = _dft_pow2(v.permute(4, 0, 1, 2, 3), lb, inverse).permute(1, 2, 3, 4, 0)  # (..., ob)
    ob = torch.arange(nb)
    rows = (oa << log_n2) + i2  # lt[oa, i2]
    if lb <= cuda_ntt.LEVEL_CHAIN_LOG:  # t·s^ob, s = lt[NA, i2], a product a step
        w, s, factors = lt[rows], lt[(n2 << la) + i2], []
        for _ in range(nb):
            factors.append(w)
            w = torch_gl.mul(w, s)
        v = torch_gl.mul(v, torch.cat(factors, dim=-1))
    else:
        v = torch_gl.mul(v, lt[rows + ob * (n2 << la)])
    sm = torch.full((cols, g.shape[1], len(zs), tl * srow), SENTINEL, dtype=torch.int64)
    sm.scatter_(3, (t * srow + ob * ta + a).expand(v.shape).reshape(*sm.shape[:3], -1),
                v.reshape(*sm.shape[:3], -1))
    idx = (torch.arange(nb)[:, None] * THREADS + torch.arange(THREADS)[None, :]).reshape(-1)
    a2, ob2, t2 = idx % ta, (idx // ta) % nb, idx // (ta * nb)
    c, g, z = c[..., 0], g[..., 0], z[..., 0]
    dst = ((((c << log_n2) + z * tl) << log_n1) + g * ta
           + (t2 << log_n1) + (ob2 << la) + a2)
    vals = sm[..., t2 * srow + ob2 * ta + a2]
    assert not bool((vals == SENTINEL).any())  # every word stored was staged
    out[dst.reshape(-1)] = vals.reshape(-1)
    return out


def b2_model(x, bits1, log_n2, cols, lt, inverse, zs):
    """gl_level_planar on flat arrays for the lane blocks zs of the last
    pass: (out (C·n2, n1), the lanes those blocks hold)."""
    la, lb = cuda_ntt.radix_split(bits1)
    n1, n2 = 1 << bits1, 1 << log_n2
    flat = x.reshape(-1)
    out = torch.full((cols * n2 * n1,), SENTINEL, dtype=torch.int64)
    tl = THREADS // (LEVEL_OA if la else 1)
    lanes = torch.cat([torch.arange(z * tl, (z + 1) * tl) for z in zs])
    if la:
        scratch = torch.full_like(flat, SENTINEL)
        nb = 1 << lb
        _pass(flat, scratch, la, inverse, lanes, nb, cols, n1 * n2, nb * n2, n2, nb * n2, n2,
              True, _twiddle_table(bits1, inverse))
        flat = scratch
    _level_pass(flat, lt.reshape(-1), out, la, lb, log_n2, cols, inverse, la == 0, zs)
    return out.reshape(cols * n2, n1), lanes


def b3_model(y, bits2, cols, inverse, lanes):
    """gl_base_grid on flat arrays for the given lanes of each column batch."""
    n1 = y.shape[1]
    flat = y.reshape(-1)
    out = torch.full_like(flat, SENTINEL)
    _rows(flat, bits2, inverse, lanes, n1, cols, n1 << bits2, torch.full_like(flat, SENTINEL),
          out)
    return out.reshape(y.shape)


LOG_N2 = 12


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("cols", [1, 3])
@pytest.mark.parametrize("bits1", [1, 4, 6, 7, 10])
def test_b2_b3_model_equals_plain(bits1, cols, inverse):
    n1, n2 = 1 << bits1, 1 << LOG_N2
    bits = bits1 + LOG_N2
    x = _input((cols, n1 * n2), 31 * bits1 + cols + inverse)
    lt = ntt.level_twiddles(bits, bits1, inverse, "cpu")
    tl = THREADS // (LEVEL_OA if cuda_ntt.radix_split(bits1)[0] else 1)
    y, lanes = b2_model(x, bits1, LOG_N2, cols, lt, inverse, [0, 1, n2 // tl - 1])

    x_sub = x.reshape(cols, n1, n2)[:, :, lanes].reshape(cols, -1)
    want = cuda_ntt.level_planar_plain(x_sub, bits1, len(lanes), cols, lt[:, lanes].contiguous(),
                                       inverse)
    got = y.reshape(cols, n2, n1)
    assert torch.equal(got[:, lanes].reshape(cols * len(lanes), n1), want)
    others = torch.ones(n2, dtype=torch.bool)
    others[lanes] = False
    assert bool((got[:, others] == SENTINEL).all())

    # B3 over B2's output: the first and the last 64 lanes o1 (all n1
    # lanes when n1 <= 128)
    y = got.reshape(cols * n2, n1).clone()
    y[y == SENTINEL] = 7  # the lanes the model left out, as inputs
    o1 = torch.arange(n1)
    b3_lanes = o1 if n1 <= THREADS else torch.cat([o1[:THREADS // 2], o1[-THREADS // 2:]])
    z = b3_model(y, LOG_N2, cols, inverse, b3_lanes)
    want3 = cuda_ntt.base_grid_plain(y[:, b3_lanes].contiguous(), LOG_N2, cols, inverse)
    assert torch.equal(z[:, b3_lanes], want3)
    rest = torch.ones(n1, dtype=torch.bool)
    rest[b3_lanes] = False
    assert bool((z[:, rest] == SENTINEL).all())


@pytest.mark.parametrize("bits2", [0, 1, 5, 6, 7, 12])
def test_b3_single_transform_model_equals_plain(bits2):
    """planar_ntt's path up to 2^12 points: n1 = 1, one lane per column."""
    cols = 3
    y = _input((cols << bits2, 1), 70 + bits2)
    for inverse in (False, True):
        got = b3_model(y, bits2, cols, inverse, torch.arange(1))
        assert torch.equal(got, cuda_ntt.base_grid_plain(y, bits2, cols, inverse))


def test_level_constants_match_the_source():
    """The model above and chip_smoke.py's ptxas labels read B2's last-pass
    constants from ops/cuda_ntt.py; they are csrc/ntt.cu's."""
    src = (cuda_build.CSRC / "ntt.cu").read_text()
    for name, value in (("kLevelOa", cuda_ntt.LEVEL_OA),
                        ("kLevelChainLog", cuda_ntt.LEVEL_CHAIN_LOG)):
        assert re.findall(rf"constexpr int {name} = (\d+);", src) == [str(value)]


def test_radix_split():
    """One pass up to 2^6 points; above, NA = 2^(bits − bits/2) and NB =
    2^(bits/2), each at most 64 (csrc/ntt.cu split_a / split_b)."""
    assert [cuda_ntt.radix_split(b) for b in range(0, 7)] == [(0, b) for b in range(0, 7)]
    assert [cuda_ntt.radix_split(b) for b in range(7, 13)] == [
        (4, 3), (4, 4), (5, 4), (5, 5), (6, 5), (6, 6)]


@pytest.mark.parametrize("bits", [7, 13, 14])
def test_planar_ntt_shares_its_scratch_array(bits, monkeypatch):
    """planar_ntt lets B3 write over B2's output (each wrapper allocates
    its own scratch array, so three C·N arrays are live at most); the
    result equals the host transform."""
    seen = []
    level, grid = cuda_ntt.level_planar, cuda_ntt.base_grid

    def spy_level(*args, **kw):
        y = level(*args, **kw)
        seen.append(("level", kw, y))
        return y

    def spy_grid(*args, **kw):
        seen.append(("grid", kw, args[0]))
        return grid(*args, **kw)

    monkeypatch.setattr(cuda_ntt, "level_planar", spy_level)
    monkeypatch.setattr(cuda_ntt, "base_grid", spy_grid)
    x = _input((2, 1 << bits), bits)
    got = ntt.planar_ntt(x, bits, False)
    want = ntt.ntt_host_u64(torch_gl.to_u64(x).T.copy(), bits).T
    np.testing.assert_array_equal(torch_gl.to_u64(got), want)
    if bits <= ntt.BASE_BITS:
        assert [k for k, _, _ in seen] == ["grid"] and seen[0][1] == {}
    else:
        (_, kw_level, y), (_, kw_grid, y_in) = seen
        assert kw_level == {} and y_in is y and kw_grid == {"out": y}
        assert got.data_ptr() == y.data_ptr()


def test_wrappers_refuse_bad_buffers():
    """B3's out is a contiguous int64 array of y's shape and may be y only
    when two passes run (its first pass has read y by the time the second
    writes).  Checked before the device dispatch, so on the CPU too, where
    the result goes into out as on the card."""
    y = _input((2 << 12, 2), 6)
    for bad in (torch.empty(2, 1 << 13, dtype=torch.int64),
                torch.empty((2 << 12, 2), dtype=torch.int32)):
        with pytest.raises(ValueError):
            cuda_ntt.base_grid(y, 12, 2, False, out=bad)
    small = _input((3 << 5, 4), 7)
    with pytest.raises(ValueError):
        cuda_ntt.base_grid(small, 5, 3, False, out=small)
    want = cuda_ntt.base_grid_plain(y, 12, 2, False)
    out = torch.empty_like(y)
    assert cuda_ntt.base_grid(y, 12, 2, False, out=out) is out
    assert torch.equal(out, want)
    assert cuda_ntt.base_grid(y, 12, 2, False, out=y) is y
    assert torch.equal(y, want)


LAUNCH = re.compile(r"([\w:]+(?:<[^<>;]*>)?)\s*<<<(.*?)>>>\s*\((.*?)\);", re.S)


@pytest.fixture(scope="module")
def host_ntt(tmp_path_factory):
    """csrc/ntt.cu built with the host's g++ into a shared library, each
    launch rewritten into tests/ntt_host_shim.h's emu_launch."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    src = (cuda_build.CSRC / "ntt.cu").read_text()
    src = src.replace("#include <cuda_runtime.h>", '#include "ntt_host_shim.h"')
    src = src.replace("extern __shared__ uint64_t sm[];", "uint64_t* sm = emu_smem.data();")
    src, launches = LAUNCH.subn(r"emu_launch(\2, [&] { \1(\3); });", src)
    assert launches >= 3 and "<<<" not in src
    src += '\nextern "C" long emu_launch_count() { return emu_launches; }\n'
    root = tmp_path_factory.mktemp("ntt_host")
    (root / "ntt_host.cpp").write_text(src)
    lib = root / "ntt_host.so"
    out = subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                          "-I", str(cuda_build.CSRC), "-I", str(Path(__file__).resolve().parent),
                          "-o", str(lib), str(root / "ntt_host.cpp")],
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-4000:]
    h = ctypes.CDLL(str(lib))
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    h.gl_level_planar.argtypes = [vp, vp, vp, vp, vp, ci, ci, cl, ci, vp]
    h.gl_base_grid.argtypes = [vp, vp, vp, vp, ci, cl, cl, ci, vp]
    h.gl_base_rows.argtypes = [vp, vp, vp, vp, ci, cl, ci, vp]
    for fn in (h.gl_level_planar, h.gl_base_grid, h.gl_base_rows):
        fn.restype = ci
    h.emu_launch_count.argtypes = []
    h.emu_launch_count.restype = ctypes.c_long
    return h


def _ptr(t):
    return None if t is None else t.data_ptr()


def _half_table(bits, inverse):
    """What the wrappers hand a two-pass kernel: w_n^k for k < n/2."""
    return cuda_ntt.radix_twiddles(bits, inverse, "cpu").contiguous() if bits > 6 else None


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("bits1,bits2,cols", [(3, 5, 2), (7, 5, 2), (10, 3, 1), (6, 7, 1)])
def test_host_build_b2_b3_equal_plain(host_ntt, bits1, bits2, cols, inverse):
    """(10, 3): B2's last pass with n2 below a block's 32 lanes; (6, 7):
    B2 in one pass, B3 in two over 64 lanes."""
    n1, n2 = 1 << bits1, 1 << bits2
    x = _input((cols, n1 * n2), 40 + bits1 + bits2)
    lt = ntt.level_twiddles(bits1 + bits2, bits1, inverse, "cpu")
    scratch = torch.full_like(x, SENTINEL)
    y = torch.full((cols * n2, n1), SENTINEL, dtype=torch.int64)
    before = host_ntt.emu_launch_count()
    assert host_ntt.gl_level_planar(x.data_ptr(), _ptr(_half_table(bits1, inverse)),
                                    lt.data_ptr(), scratch.data_ptr(), y.data_ptr(), bits1,
                                    bits2, cols, int(inverse), None) == 0
    want = cuda_ntt.level_planar_plain(x, bits1, n2, cols, lt, inverse)
    assert torch.equal(y, want)
    assert host_ntt.gl_base_grid(y.data_ptr(), _ptr(_half_table(bits2, inverse)),
                                 scratch.data_ptr(), y.data_ptr(), bits2, n1, cols,
                                 int(inverse), None) == 0
    assert torch.equal(y, cuda_ntt.base_grid_plain(want, bits2, cols, inverse))
    passes = sum(1 + (cuda_ntt.radix_split(b)[0] > 0) for b in (bits1, bits2))
    assert host_ntt.emu_launch_count() - before == passes


@pytest.mark.parametrize("bits", [0, 1, 6, 7])
def test_host_build_single_transform_equals_plain(host_ntt, bits):
    """planar_ntt up to 2^12 points: B3 with n1 = 1."""
    cols = 2
    y = _input((cols << bits, 1), 60 + bits)
    for inverse in (False, True):
        out = torch.full_like(y, SENTINEL)
        scratch = torch.full_like(y, SENTINEL)
        assert host_ntt.gl_base_grid(y.data_ptr(), _ptr(_half_table(bits, inverse)),
                                     scratch.data_ptr(), out.data_ptr(), bits, 1, cols,
                                     int(inverse), None) == 0
        assert torch.equal(out, cuda_ntt.base_grid_plain(y, bits, cols, inverse))


@pytest.mark.parametrize("bits,lanes", [(3, 5), (6, 130), (7, 3), (12, 2)])
def test_host_build_b1_equals_plain(host_ntt, bits, lanes):
    """B1 in each regime: registers, pass 2 alone, two passes (the
    largest: 64 × 64), with a ragged block at 130 lanes."""
    x = _input((1 << bits, lanes), 80 + bits)
    tw = (cuda_ntt.stage_twiddles(bits, False, "cpu") if bits <= 5
          else cuda_ntt.radix_twiddles(bits, False, "cpu").contiguous())
    y, out = torch.full_like(x, SENTINEL), torch.full_like(x, SENTINEL)
    assert host_ntt.gl_base_rows(x.data_ptr(), tw.data_ptr(), y.data_ptr(), out.data_ptr(),
                                 bits, lanes, 0, None) == 0
    assert torch.equal(out, cuda_ntt.base_rows_plain(x, bits, False))


def test_host_build_refuses_what_the_card_refuses(host_ntt):
    """Shapes outside the kernels' range return an error, launch nothing."""
    x = torch.zeros(4, dtype=torch.int64)
    before = host_ntt.emu_launch_count()
    assert host_ntt.gl_level_planar(x.data_ptr(), None, x.data_ptr(), None, x.data_ptr(), 13,
                                    1, 1, 0, None) != 0
    assert host_ntt.gl_base_grid(x.data_ptr(), None, None, x.data_ptr(), 13, 1, 1, 0,
                                 None) != 0
    assert host_ntt.gl_base_rows(x.data_ptr(), None, None, x.data_ptr(), 0, 4, 0,
                                 None) != 0
    assert host_ntt.emu_launch_count() == before
