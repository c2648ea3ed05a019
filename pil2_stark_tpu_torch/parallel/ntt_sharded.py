"""The NTT and the LDE over a mesh: the four-step network with three
exchanges.

Counterpart of pil2_stark_tpu/parallel/ntt_sharded.py (``make_sharded_ntt``
:98, ``make_sharded_lde`` :169), on the port's planar layout.  A transform
of N = N1·N2 points, input x[i1·N2 + i2] sharded by columns, so that rank r
holds the i1 block r as (C, N1/d, N2):

  1. exchange the i2 blocks: rank r holds (C, N1, N2/d), its i2 block;
  2. the N1-point transforms along i1, times w_N^(o1·i2) for its i2 block,
     stored transposed: (C, N2/d, N1) — kernel B2 (``level_planar``) with
     n2 = N2/d and rank r's columns of the level twiddles;
  3. exchange the o1 blocks: rank r holds (C, N2, N1/d);
  4. the N2-point transforms along i2: (C, N2 [o2], N1/d [o1]) — kernel B3
     (``base_grid``) with n1 = N1/d;
  5. exchange the o2 blocks: rank r holds (C, N2/d, N1), which is its block
     of the natural-order output Y[o2·N1 + o1].

The factors are those of the single-device route (ops/ntt.py
``split_bits``: N1 = 2^(bits-12) up to 2^24 points), and transforms of at
most 2^12 points split at bits // 2, as the reference does; the mesh size d
must divide both factors.  Above the planar ceiling (ops.ntt.MAX_BITS) a
factor exceeds 2^12 and each local transform takes the row route,
``ops.ntt.axis0_ntt`` on kernel B1, as the reference's ``_local_ntt_cols``
:39 takes ``_axis0_ntt``.  Every local transform is the port's own kernel;
an unsupported shape raises, and nothing falls back to one device.

``sharded_lde`` runs the inverse network, scales each rank's block by its
slice of n⁻¹·shift^i, moves the N coefficients to the ranks that own the
first N rows of the extended domain (rank 0 alone when extN/d >= N) and
runs the forward network there.  ``relayout`` is that move in general: the
Q split (stark/prover.py) moves its qDeg chunks with it.
"""
from __future__ import annotations

import torch

from ..field import torch_gl as gl
from ..ops import cuda_ntt
from ..ops import ntt as ntt_ops

_RANK_TW: dict = {}


def factor_bits(bits: int) -> tuple[int, int]:
    """(log2 N1, log2 N2) of a sharded transform of 2^bits points."""
    bits1 = bits // 2 if bits <= ntt_ops.BASE_BITS else ntt_ops.split_bits(bits)
    return bits1, bits - bits1


def check_shape(bits: int, d: int) -> None:
    """Raise unless a mesh of d ranks divides both factors."""
    bits1, bits2 = factor_bits(bits)
    if d & (d - 1) or (1 << bits1) % d or (1 << bits2) % d:
        raise ValueError(f"a transform of 2^{bits} points splits as 2^{bits1} x 2^{bits2}: "
                         f"a mesh of {d} ranks must divide both factors")


def rank_twiddles(bits: int, inverse: bool, d: int, rank: int, device) -> torch.Tensor:
    """w_N^(o1·i2) for every o1 and the i2 block `rank` of d: the (N1, N2/d)
    contiguous columns of ops.ntt.level_twiddles, cached per rank."""
    bits1, bits2 = factor_bits(bits)
    key = (bits, bits1, inverse, str(device), d, rank)
    t = _RANK_TW.get(key)
    if t is None:
        m2 = (1 << bits2) // d
        full = ntt_ops.level_twiddles(bits, bits1, inverse, device)
        t = full[:, rank * m2:(rank + 1) * m2].contiguous()
        _RANK_TW[key] = t
    return t


def _level(a, bits, inverse, d, rank):
    """Step 2 on rank `rank`: a (C, N1, N2/d) -> (C, N2/d, N1)."""
    bits1 = factor_bits(bits)[0]
    c, n1, m2 = a.shape
    lt = rank_twiddles(bits, inverse, d, rank, a.device)
    if bits <= ntt_ops.MAX_BITS:
        y = cuda_ntt.level_planar(a.reshape(c, n1 * m2), bits1, m2, c, lt, inverse)
        return y.reshape(c, m2, n1)
    y = ntt_ops.axis0_ntt(a.permute(1, 0, 2).reshape(n1, c * m2), bits1, inverse)
    return gl.mul(y.reshape(n1, c, m2), lt[:, None, :]).permute(1, 2, 0)


def _base(z, bits, inverse):
    """Step 4: z (C, N2, N1/d) -> (C, N2 [o2], N1/d [o1])."""
    bits2 = factor_bits(bits)[1]
    c, n2, m1 = z.shape
    if bits <= ntt_ops.MAX_BITS:
        return cuda_ntt.base_grid(z.reshape(c * n2, m1), bits2, c, inverse).reshape(c, n2, m1)
    y = ntt_ops.axis0_ntt(z.permute(1, 0, 2).reshape(n2, c * m1), bits2, inverse)
    return y.reshape(n2, c, m1).permute(1, 0, 2)


def sharded_ntt(shards: list, bits: int, mesh, inverse: bool = False) -> list:
    """The transform of a sharded (C, 2^bits) array, natural order in and
    out, no 1/n scale (the inverse runs the same network on inverted
    roots): equal to ops.ntt.planar_ntt of the whole array."""
    d = mesh.size
    check_shape(bits, d)
    bits1, bits2 = factor_bits(bits)
    n1, n2 = 1 << bits1, 1 << bits2
    m1, m2 = n1 // d, n2 // d
    ranks, local = range(d), mesh.local_ranks
    c = shards[local[0]].shape[0]
    if c == 0:
        return shards
    # 1. send the i2 blocks
    x = {s: shards[s].reshape(c, m1, n2) for s in local}
    recv = mesh.all_to_all([[x[s][:, :, t * m2:(t + 1) * m2] for t in ranks]
                            if s in local else None for s in ranks])
    # 2. the N1 transforms and the level twiddles, transposed
    y = {r: _level(torch.cat(recv[r], dim=1), bits, inverse, d, r) for r in local}
    del x, recv
    # 3. send the o1 blocks
    recv = mesh.all_to_all([[y[s][:, :, t * m1:(t + 1) * m1] for t in ranks]
                            if s in local else None for s in ranks])
    del y
    # 4. the N2 transforms
    z = {r: _base(torch.cat(recv[r], dim=1), bits, inverse) for r in local}
    del recv
    # 5. send the o2 blocks: rank t's natural-order rows
    recv = mesh.all_to_all([[z[s][:, t * m2:(t + 1) * m2, :] for t in ranks]
                            if s in local else None for s in ranks])
    del z
    return [torch.cat(recv[r], dim=2).reshape(c, m2 * n1) if r in local else None
            for r in ranks]


def relayout(mesh, shards: list, n_dst: int, rows_dst: int, moves) -> list:
    """A sharded (rows_dst, n_dst) array, zero but where `moves` put the
    columns of the sharded (h, n_src) `shards`: each move (src_col,
    dst_row, dst_col, width, factor) takes source columns [src_col,
    src_col + width), all h rows, into rows [dst_row, dst_row + h) and
    columns [dst_col, dst_col + width), times the field element `factor`
    (None: as they are).  Each move is cut at the blocks of both layouts;
    each pair of ranks exchanges its pieces once, flattened."""
    d = mesh.size
    local = mesh.local_ranks
    h, bs = shards[local[0]].shape
    bd = n_dst // d
    pieces = {}  # (src rank, dst rank) -> [(src off, dst row, dst off, width, factor)]
    for c0, r0, e0, w, factor in moves:
        pos = 0
        while pos < w:
            a, b = c0 + pos, e0 + pos
            step = min(w - pos, bs - a % bs, bd - b % bd)
            pieces.setdefault((a // bs, b // bd), []).append((a % bs, r0, b % bd, step, factor))
            pos += step
    sends = {(s, t): torch.cat([shards[s][:, o:o + w].reshape(-1) for o, _, _, w, _ in p])
             for (s, t), p in pieces.items() if s in local}
    shapes = {(s, t): (sum(h * w for _, _, _, w, _ in p),)
              for (s, t), p in pieces.items() if t in local}
    got = mesh.exchange(sends, shapes)
    out = [torch.zeros((rows_dst, bd), dtype=torch.int64, device=mesh.device(t))
           if t in local else None for t in range(d)]
    for (s, t), p in pieces.items():
        if t not in local:
            continue
        flat, pos = got[(s, t)], 0
        for _, r0, e0, w, factor in p:
            piece = flat[pos:pos + h * w].reshape(h, w)
            out[t][r0:r0 + h, e0:e0 + w] = piece if factor is None else gl.mul(piece, factor)
            pos += h * w
    return out


def sharded_lde(shards: list, bits: int, ext_bits: int, mesh, shift: int = 7) -> list:
    """(C, N) -> (C, extN) over the mesh: evaluations on the coset
    shift·H_ext, equal to ops.ntt.lde_planar of the whole array."""
    n = 1 << bits
    b = n // mesh.size
    check_shape(ext_bits, mesh.size)
    coefs = sharded_ntt(shards, bits, mesh, inverse=True)
    c = coefs[mesh.local_ranks[0]].shape[0]
    for r in mesh.local_ranks:
        scale = ntt_ops._lde_scale(bits, shift, coefs[r].device)[r * b:(r + 1) * b]
        coefs[r] = gl.mul(coefs[r], scale[None, :])
    padded = relayout(mesh, coefs, 1 << ext_bits, c, [(0, 0, 0, n, None)])
    return sharded_ntt(padded, ext_bits, mesh)
