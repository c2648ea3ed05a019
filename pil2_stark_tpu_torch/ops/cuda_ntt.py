"""Kernels B1, B2 and B3 of the NTT (csrc/ntt.cu), each beside its plain
PyTorch version.

  * ``level_planar`` replaces pallas_ntt.level_planar (pallas_ntt.py:439):
    step 1 of a four-step level — bit-reverse gather over i1, radix-2 DIT
    over n1, the level twiddle w_N^(o1·i2), transpose to (C·n2, n1).
  * ``base_grid`` replaces pallas_ntt.base_grid (pallas_ntt.py:497): step 2
    — per column batch, bit-reverse gather over i2 and a length-n2 DIT
    along the rows of a (C·n2, n1) array.
  * ``base_rows`` replaces pallas_ntt.base_ntt_brev (pallas_ntt.py:519): the
    base of the row-major route — a length-n DIT along axis 0 of an (n, L)
    array, n = 2^1..2^12, any L.  Bound on the card: bytes (read once,
    write once); n <= 32 runs in registers, larger n as n = NA·NB
    (``radix_split``) in two launches through a scratch array: NA-point
    transforms in registers times the twiddle w_n^(o1·i2) (from
    ``radix_twiddles``, the last stage's part of the stage table), then
    NB-point transforms in registers (n = 64: one launch).  Transforms of
    up to 64 points take power-of-two stage twiddles (``pow2_exponents``):
    shifts, or for 2^e with e >= 64 one product by a constant.

Unlike the Pallas kernels, all three take natural-order input (the gather
is fused into the kernels' loads) and return canonical values.  The
inverse direction runs inverted roots with no 1/n.

A wrapper given a CPU tensor computes the plain version; given a CUDA tensor
it launches the kernel (building it at first use) or raises.  Each wrapper
counts its kernel launches in ``<wrapper>.launches`` (``base_rows``: two
for n > 64, and by shape in ``base_rows.shapes``).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..field import gl64
from ..field import torch_gl as gl
from ..utils import cuda_build

_SMEM_WORDS = 16384  # rows × tile u64 words a block holds (128 KiB)
_MAX_TILE = 32
_REG_MAX_BITS = 5  # B1 runs n <= 2^5 in registers, larger n in the radix regime


def bit_reverse_indices(bits: int) -> np.ndarray:
    n = 1 << bits
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def stage_twiddles_u64(bits: int, inverse: bool) -> np.ndarray:
    """Stage s (half = 2^(s-1)) at [half - 1, 2·half - 1): w_{2^s}^j."""
    parts = [
        gl64.powers(gl64.w_inv(s) if inverse else gl64.w(s), 1 << (s - 1))
        for s in range(1, bits + 1)
    ]
    return np.concatenate(parts) if parts else np.zeros(0, dtype=np.uint64)


_TW_CACHE: dict = {}


def stage_twiddles(bits: int, inverse: bool, device) -> torch.Tensor:
    key = (bits, inverse, str(device))
    t = _TW_CACHE.get(key)
    if t is None:
        t = gl.from_u64(stage_twiddles_u64(bits, inverse), device)
        _TW_CACHE[key] = t
    return t


def dit_brev(x: torch.Tensor, bits: int, inverse: bool) -> torch.Tensor:
    """Plain radix-2 DIT along dim -2 of (..., n, L), input rows already
    bit-reversed, output in natural order (the butterfly network both
    kernels run)."""
    n = 1 << bits
    lead = x.shape[:-2]
    lanes = x.shape[-1]
    tw = stage_twiddles(bits, inverse, x.device)
    for s in range(1, bits + 1):
        half = 1 << (s - 1)
        v = x.reshape(*lead, n >> s, 2, half, lanes)
        u = v[..., 0, :, :]
        t = gl.mul(v[..., 1, :, :], tw[half - 1: 2 * half - 1, None])
        x = torch.stack([gl.add(u, t), gl.sub(u, t)], dim=-3)
    return x.reshape(*lead, n, lanes)


def _tile(row_bits: int, lanes: int) -> int:
    return min(_MAX_TILE, max(1, _SMEM_WORDS >> row_bits), lanes)


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _check(t: torch.Tensor, shape, what: str):
    if t.dtype != torch.int64 or not t.is_contiguous() or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{what}: want a contiguous int64 tensor of shape {tuple(shape)}, "
            f"got {t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}")


def _lib():
    lib = cuda_build.lib("ntt")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.gl_level_planar.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, vp]
        lib.gl_level_planar.restype = ci
        lib.gl_base_grid.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp]
        lib.gl_base_grid.restype = ci
        lib.gl_base_rows.argtypes = [vp, vp, vp, vp, ci, ctypes.c_longlong, ci, vp]
        lib.gl_base_rows.restype = ci
        lib._typed = True
    return lib


# ---------------------------------------------------------------------------
# B2


def level_planar_plain(x, bits1: int, n2: int, n_cols: int, level_tw,
                       inverse: bool) -> torch.Tensor:
    """x (C, n1·n2) natural order, level_tw (n1, n2) -> (C·n2, n1)."""
    n1 = 1 << bits1
    rev = torch.as_tensor(bit_reverse_indices(bits1), device=x.device)
    xr = gl.canon(x.reshape(n_cols, n1, n2)[:, rev, :])
    y = gl.mul(dit_brev(xr, bits1, inverse), level_tw[None])
    return y.permute(0, 2, 1).reshape(n_cols * n2, n1)


def level_planar(x, bits1: int, n2: int, n_cols: int, level_tw,
                 inverse: bool) -> torch.Tensor:
    if x.device.type == "cpu":
        return level_planar_plain(x, bits1, n2, n_cols, level_tw, inverse)
    if x.device.type != "cuda":
        raise ValueError(f"level_planar: unsupported device {x.device}")
    n1 = 1 << bits1
    if not (1 <= bits1 <= 12) or n2 & (n2 - 1) or n2 < 1:
        raise ValueError(f"level_planar: unsupported shape n1=2^{bits1}, n2={n2}")
    _check(x, (n_cols, n1 * n2), "level_planar x")
    _check(level_tw, (n1, n2), "level_planar level_tw")
    tile = _tile(bits1, n2)
    tw = stage_twiddles(bits1, inverse, x.device)
    out = torch.empty((n_cols * n2, n1), dtype=torch.int64, device=x.device)
    rc = _lib().gl_level_planar(
        x.data_ptr(), tw.data_ptr(), level_tw.data_ptr(), out.data_ptr(),
        bits1, n2.bit_length() - 1, n_cols, tile.bit_length() - 1, _stream(x))
    if rc != 0:
        raise RuntimeError(f"gl_level_planar launch failed: CUDA error {rc}")
    level_planar.launches += 1
    return out


level_planar.launches = 0


# ---------------------------------------------------------------------------
# B3


def base_grid_plain(y, bits2: int, n_cols: int, inverse: bool) -> torch.Tensor:
    """y (C·n2, n1), rows in natural order -> (C·n2, n1) transformed along
    the n2 rows of each column batch."""
    n2 = 1 << bits2
    n1 = y.shape[1]
    rev = torch.as_tensor(bit_reverse_indices(bits2), device=y.device)
    yr = gl.canon(y.reshape(n_cols, n2, n1)[:, rev, :])
    return dit_brev(yr, bits2, inverse).reshape(n_cols * n2, n1)


def base_grid(y, bits2: int, n_cols: int, inverse: bool) -> torch.Tensor:
    if y.device.type == "cpu":
        return base_grid_plain(y, bits2, n_cols, inverse)
    if y.device.type != "cuda":
        raise ValueError(f"base_grid: unsupported device {y.device}")
    n2 = 1 << bits2
    n1 = y.shape[1]
    if not (0 <= bits2 <= 12) or n1 & (n1 - 1) or n1 < 1:
        raise ValueError(f"base_grid: unsupported shape n2=2^{bits2}, n1={n1}")
    _check(y, (n_cols * n2, n1), "base_grid y")
    tile = _tile(bits2, n1)
    tw = stage_twiddles(max(bits2, 1), inverse, y.device)
    out = torch.empty_like(y)
    rc = _lib().gl_base_grid(
        y.data_ptr(), tw.data_ptr(), out.data_ptr(), bits2,
        n1.bit_length() - 1, n_cols, tile.bit_length() - 1, _stream(y))
    if rc != 0:
        raise RuntimeError(f"gl_base_grid launch failed: CUDA error {rc}")
    base_grid.launches += 1
    return out


base_grid.launches = 0


# ---------------------------------------------------------------------------
# B1


def base_rows_plain(x, bits: int, inverse: bool) -> torch.Tensor:
    """x (n, L) natural order -> (n, L) transformed along axis 0."""
    rev = torch.as_tensor(bit_reverse_indices(bits), device=x.device)
    return dit_brev(gl.canon(x[rev]), bits, inverse)


def radix_split(bits: int) -> tuple[int, int]:
    """(LA, LB) of B1's radix regime: n = 2^bits = NA·NB, each at most 64;
    pass 1 runs NB batches of NA-point transforms, pass 2 NA batches of
    NB-point ones (csrc/ntt.cu, launch_base_rows_radix; n = 64 is (0, 6),
    pass 2 alone)."""
    return (0, 6) if bits == 6 else (bits - bits // 2, bits // 2)


def pow2_exponents(bits: int, inverse: bool) -> np.ndarray:
    """e with w_{2^s}^j = 2^e (e < 192), stage s <= bits <= 6 at
    [2^(s-1) - 1 + j], the layout of stage_twiddles_u64: the exponents
    csrc/ntt_radix.cuh's tw_exp gives."""
    out = []
    for s in range(1, bits + 1):
        j = np.arange(1 << (s - 1), dtype=np.int64)
        e = j * (192 >> s)
        out.append((192 - e) % 192 if inverse else e)
    return np.concatenate(out) if out else np.zeros(0, dtype=np.int64)


def radix_twiddles(bits: int, inverse: bool, device) -> torch.Tensor:
    """w_n^k for k < n/2, n = 2^bits: the last stage of stage_twiddles (a
    view, no table of its own).  Pass 1 of B1's radix regime takes
    w_n^(o1·i2) from it, as −w_n^(k − n/2) for k >= n/2."""
    return stage_twiddles(bits, inverse, device)[(1 << (bits - 1)) - 1:]


def base_rows(x, bits: int, inverse: bool) -> torch.Tensor:
    if x.device.type == "cpu":
        return base_rows_plain(x, bits, inverse)
    if x.device.type != "cuda":
        raise ValueError(f"base_rows: unsupported device {x.device}")
    if not 1 <= bits <= 12 or x.dim() != 2:
        raise ValueError(f"base_rows: unsupported shape n=2^{bits}, x {tuple(x.shape)}")
    lanes = x.shape[1]
    _check(x, (1 << bits, lanes), "base_rows x")
    out = torch.empty_like(x)
    y = None
    if bits <= _REG_MAX_BITS:
        tw = stage_twiddles(bits, inverse, x.device)
    else:
        tw = radix_twiddles(bits, inverse, x.device)
        if radix_split(bits)[0]:
            y = torch.empty_like(x)
    rc = _lib().gl_base_rows(x.data_ptr(), tw.data_ptr(), 0 if y is None else y.data_ptr(),
                             out.data_ptr(), bits, lanes, int(inverse), _stream(x))
    if rc != 0:
        raise RuntimeError(f"gl_base_rows launch failed: CUDA error {rc}")
    launches = 1 if y is None else 2
    base_rows.launches += launches
    key = (1 << bits, lanes)
    base_rows.shapes[key] = base_rows.shapes.get(key, 0) + launches
    return out


base_rows.launches = 0
base_rows.shapes = {}  # (rows, lanes) -> kernel launches
