"""NTT / iNTT / low-degree extension over Goldilocks on planar tensors.

Counterpart of pil2_stark_tpu/ops/ntt.py: its planar path (``_planar_ntt``
:294-327, ``lde_planar`` :445) and its row-major path (``_axis0_ntt``
:225-265, ``_axis0_base`` :187-222).  Data is planar: a (C, N) int64 tensor,
one column per row, the domain along the contiguous axis.  A transform of
N = 2^bits points runs the four-step split of ``split_bits`` (one factor
kept at 2^12 up to 2^24, halves above, as ``_split_bits`` :169 does):

  bits <= 12:       B3 alone (base_grid with n1 = 1);
  12 < bits <= 24:  B2 over n1 = 2^(bits-12), then B3 over n2 = 2^12, both
                    on B1's radix passes, sharing one scratch array;
  bits > 24:        the row route: transpose to (N, C), ``axis0_ntt``,
                    transpose back (as ``_jit_lde_planar`` :416-425 falls
                    back).

``axis0_ntt`` is the row-major recursion: each level transforms axis 0 of
an (n1, n2·L) view, multiplies by w_N^(o1·i2), transposes (n1, n2, L) ->
(n2, n1, L) and transforms the n2 axis; its bases (n <= 2^12) are kernel B1
(base_rows).  ``ntt``/``intt`` are natural order in and out and
bit-identical to the reference's DFT (roots from the f3g w[] chain);
``intt`` runs the inverse network and scales by 1/n.  ``lde_planar``
mirrors fft_p.interpolate: iNTT(N) -> coset scale by 7^i (1/n folded in,
as ``_lde_parts`` :367-391) -> zero-pad -> NTT(extN).  The FRI group
transforms (``intt_rows``) run the row route too.
"""
from __future__ import annotations

import numpy as np
import torch

from ..field import gl64
from ..field import torch_gl as gl
from . import cuda_ntt

BASE_BITS = 12
MAX_BITS = 2 * BASE_BITS  # the planar route's ceiling; larger transforms take rows


def split_bits(bits: int) -> int:
    """log2 of the first four-step factor n1 (0: a single base pass)."""
    if bits <= BASE_BITS:
        return 0
    if bits <= 2 * BASE_BITS:
        return bits - BASE_BITS
    return bits // 2


_LEVEL_TW: dict = {}
_LDE_SCALE: dict = {}


def level_twiddles(bits: int, bits1: int, inverse: bool, device) -> torch.Tensor:
    """w_N^(o1·i2) as an (n1, n2) tensor, built once per (bits, inverse,
    device) on the device (32 MB at 2^22)."""
    key = (bits, bits1, inverse, str(device))
    t = _LEVEL_TW.get(key)
    if t is None:
        n = 1 << bits
        n1, n2 = 1 << bits1, 1 << (bits - bits1)
        w = gl64.w_inv(bits) if inverse else gl64.w(bits)
        pw = gl.powers(w, n, device)
        o1 = torch.arange(n1, dtype=torch.int64, device=device)
        i2 = torch.arange(n2, dtype=torch.int64, device=device)
        t = pw[(o1[:, None] * i2[None, :]) & (n - 1)].contiguous()
        _LEVEL_TW[key] = t
    return t


def planar_ntt(xp: torch.Tensor, bits: int, inverse: bool) -> torch.Tensor:
    """Transform along axis 1 of a (C, 2^bits) tensor, natural order in and
    out, no 1/n scale."""
    c = xp.shape[0]
    n = 1 << bits
    if c == 0:
        return xp
    if bits > MAX_BITS:
        return axis0_ntt(xp.T, bits, inverse).T.contiguous()
    xp = xp.contiguous()
    bits1 = split_bits(bits)
    if bits1 == 0:
        return cuda_ntt.base_grid(xp.reshape(c * n, 1), bits, c, inverse).reshape(c, n)
    n2 = 1 << (bits - bits1)
    lt = level_twiddles(bits, bits1, inverse, xp.device)
    # B3's second pass writes over B2's output, which its first pass has
    # read, so with each kernel's scratch array three C·N arrays are live
    y = cuda_ntt.level_planar(xp, bits1, n2, c, lt, inverse)
    return cuda_ntt.base_grid(y, bits - bits1, c, inverse, out=y).reshape(c, n)


def ntt(xp: torch.Tensor, bits: int) -> torch.Tensor:
    return planar_ntt(xp, bits, False)


def intt(xp: torch.Tensor, bits: int) -> torch.Tensor:
    n_inv = pow(1 << bits, gl64.P_INT - 2, gl64.P_INT)
    return gl.mul(planar_ntt(xp, bits, True), n_inv)


def _lde_scale(bits: int, shift: int, device) -> torch.Tensor:
    key = (bits, shift, str(device))
    t = _LDE_SCALE.get(key)
    if t is None:
        n_inv = pow(1 << bits, gl64.P_INT - 2, gl64.P_INT)
        t = gl.powers(shift, 1 << bits, device, start=n_inv)
        _LDE_SCALE[key] = t
    return t


def lde_planar(xp: torch.Tensor, bits: int, ext_bits: int, shift: int = 7) -> torch.Tensor:
    """(C, N) -> (C, extN): evaluations on the coset shift·H_ext."""
    c = xp.shape[0]
    coefs = gl.mul(planar_ntt(xp, bits, True), _lde_scale(bits, shift, xp.device)[None, :])
    padded = torch.zeros((c, 1 << ext_bits), dtype=torch.int64, device=xp.device)
    padded[:, : 1 << bits] = coefs
    return planar_ntt(padded, ext_bits, False)


def axis0_ntt(x: torch.Tensor, bits: int, inverse: bool) -> torch.Tensor:
    """Transform along axis 0 of a (2^bits, L) tensor, natural order in and
    out, no 1/n scale."""
    if bits <= BASE_BITS:
        return cuda_ntt.base_rows(x.contiguous(), bits, inverse)
    bits1 = split_bits(bits)
    n1, n2 = 1 << bits1, 1 << (bits - bits1)
    b = x.shape[1]
    y = axis0_ntt(x.reshape(n1, n2 * b), bits1, inverse).reshape(n1, n2, b)
    y = gl.mul(y, level_twiddles(bits, bits1, inverse, x.device)[:, :, None])
    y = y.permute(1, 0, 2).reshape(n2, n1 * b)
    return axis0_ntt(y, bits - bits1, inverse).reshape(n1 * n2, b)


def intt_rows(x: torch.Tensor, bits: int) -> torch.Tensor:
    """iNTT along axis 0 of an (n, L) tensor, with 1/n (the FRI group
    transforms)."""
    return gl.mul(axis0_ntt(x, bits, True), pow(1 << bits, gl64.P_INT - 2, gl64.P_INT))


# ---------------------------------------------------------------------------
# numpy host transform (small n: FRI verification, polutils)


def ntt_host_u64(x: np.ndarray, bits: int, inverse: bool = False) -> np.ndarray:
    """Pure-numpy radix-2 NTT along axis 0."""
    n = 1 << bits
    x = np.asarray(x, dtype=np.uint64)
    shape = x.shape
    cols = x.reshape(n, -1)
    out = cols[cuda_ntt.bit_reverse_indices(bits)].copy()
    for s in range(1, bits + 1):
        m = 1 << s
        half = m >> 1
        w = gl64.w_inv(s) if inverse else gl64.w(s)
        tw = gl64.powers(w, half)[None, :, None]
        v = out.reshape(n // m, m, -1)
        u = v[:, :half]
        t = gl64.mul(tw, v[:, half:])
        out = np.concatenate([gl64.add(u, t), gl64.sub(u, t)], axis=1).reshape(
            n, -1
        )
    if inverse:
        n_inv = pow(n, gl64.P_INT - 2, gl64.P_INT)
        out = gl64.mul(out, np.uint64(n_inv))
    return out.reshape(shape)
