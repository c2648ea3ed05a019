"""NTT / iNTT / low-degree extension over Goldilocks on planar tensors.

Counterpart of pil2_stark_tpu/ops/ntt.py's planar path (``_planar_ntt``
:294-327, ``lde_planar`` :445).  Data is planar: a (C, N) int64 tensor, one
column per row, the domain along the contiguous axis.  A transform of
N = 2^bits points runs the four-step split of ``split_bits`` (one factor
kept at 2^12, as ``_split_bits`` :169 does):

  bits <= 12:       one B3 pass (base_grid with n1 = 1);
  12 < bits <= 24:  B2 over n1 = 2^(bits-12), then B3 over n2 = 2^12.

``ntt``/``intt`` are natural order in and out and bit-identical to the
reference's DFT (roots from the f3g w[] chain); ``intt`` runs the inverse
network and scales by 1/n.  ``lde_planar`` mirrors fft_p.interpolate:
iNTT(N) -> coset scale by 7^i (1/n folded in, as ``_lde_parts`` :367-391) ->
zero-pad -> NTT(extN).  The small FRI group transforms along axis 0 run as
plain torch ops (``intt_rows``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..field import gl64
from ..field import torch_gl as gl
from . import cuda_ntt

BASE_BITS = 12
MAX_BITS = 2 * BASE_BITS


def split_bits(bits: int) -> int:
    """log2 of the B2 factor n1 (0: a single B3 pass)."""
    if bits <= BASE_BITS:
        return 0
    if bits <= MAX_BITS:
        return bits - BASE_BITS
    raise ValueError(f"NTT of 2^{bits} points: at most 2^{MAX_BITS} supported")


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
    xp = xp.contiguous()
    bits1 = split_bits(bits)
    if bits1 == 0:
        return cuda_ntt.base_grid(xp.reshape(c * n, 1), bits, c, inverse).reshape(c, n)
    n2 = 1 << (bits - bits1)
    lt = level_twiddles(bits, bits1, inverse, xp.device)
    y = cuda_ntt.level_planar(xp, bits1, n2, c, lt, inverse)
    z = cuda_ntt.base_grid(y, bits - bits1, c, inverse)
    return z.reshape(c, n)


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


def intt_rows(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Plain-torch iNTT along axis 0 of an (n, L) tensor, with 1/n (the FRI
    group transforms, n = 2^bits small)."""
    rev = torch.as_tensor(cuda_ntt.bit_reverse_indices(bits), device=x.device)
    y = cuda_ntt.dit_brev(x[rev], bits, True)
    return gl.mul(y, pow(1 << bits, gl64.P_INT - 2, gl64.P_INT))


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
