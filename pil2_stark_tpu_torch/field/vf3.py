"""Vectorized cubic extension F_p[x]/(x^3 - x - 1) over numpy uint64.

Batch counterpart of field.f3 (scalar) built on gl64 primitives: a dim-1
value is any-shaped uint64 array; a dim-3 value has a trailing axis of 3.
Formulas mirror the reference (f3g.js mul :84-104, inv :136-171); all
intermediate arithmetic is mod-p (the polynomial identities are the same).

Used by the prover's vectorized TAC executor and hint kernels; the device
(JAX) twin lives in ops/jax_vf3 for the hot paths.
"""
from __future__ import annotations

import numpy as np

from . import gl64


def is3(a) -> bool:
    return a.ndim > 0 and a.shape[-1] == 3


def as3(a):
    """Promote dim-1 -> dim-3 (zeros in c1/c2)."""
    if is3(a):
        return a
    out = np.zeros(a.shape + (3,), dtype=np.uint64)
    out[..., 0] = a
    return out


def _mk3(c0, c1, c2):
    shape = np.broadcast_shapes(c0.shape, c1.shape, c2.shape)
    out = np.empty(shape + (3,), dtype=np.uint64)
    out[..., 0] = c0
    out[..., 1] = c1
    out[..., 2] = c2
    return out


def add(a, b):
    if is3(a):
        if is3(b):
            return gl64.add(a, b)
        b = np.asarray(b, dtype=np.uint64)
        return _mk3(
            gl64.add(a[..., 0], b),
            np.broadcast_to(a[..., 1], np.broadcast_shapes(a[..., 1].shape, b.shape)),
            np.broadcast_to(a[..., 2], np.broadcast_shapes(a[..., 2].shape, b.shape)),
        )
    if is3(b):
        return add(b, a)
    return gl64.add(a, b)


def sub(a, b):
    if is3(a):
        if is3(b):
            return gl64.sub(a, b)
        b = np.asarray(b, dtype=np.uint64)
        return _mk3(
            gl64.sub(a[..., 0], b),
            np.broadcast_to(a[..., 1], np.broadcast_shapes(a[..., 1].shape, b.shape)),
            np.broadcast_to(a[..., 2], np.broadcast_shapes(a[..., 2].shape, b.shape)),
        )
    if is3(b):
        return _mk3(
            gl64.sub(a, b[..., 0]),
            gl64.neg(np.broadcast_to(b[..., 1], np.broadcast_shapes(np.asarray(a).shape, b[..., 1].shape))),
            gl64.neg(np.broadcast_to(b[..., 2], np.broadcast_shapes(np.asarray(a).shape, b[..., 2].shape))),
        )
    return gl64.sub(a, b)


def neg(a):
    return gl64.neg(a)


def mul(a, b):
    if is3(a):
        if is3(b):
            a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
            b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
            A = gl64.mul(gl64.add(a0, a1), gl64.add(b0, b1))
            B = gl64.mul(gl64.add(a0, a2), gl64.add(b0, b2))
            C = gl64.mul(gl64.add(a1, a2), gl64.add(b1, b2))
            D = gl64.mul(a0, b0)
            E = gl64.mul(a1, b1)
            F = gl64.mul(a2, b2)
            G = gl64.sub(D, E)
            return _mk3(
                gl64.sub(gl64.add(C, G), F),
                gl64.sub(gl64.add(A, C), gl64.add(gl64.add(E, E), D)),
                gl64.sub(B, G),
            )
        return gl64.mul(a, np.asarray(b, dtype=np.uint64)[..., None])
    if is3(b):
        return gl64.mul(np.asarray(a, dtype=np.uint64)[..., None], b)
    return gl64.mul(a, b)


def square(a):
    return mul(a, a)


def inv(a):
    if not is3(a):
        return gl64.inv(a)
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    aa = gl64.mul(a0, a0)
    ac = gl64.mul(a0, a2)
    ba = gl64.mul(a1, a0)
    bb = gl64.mul(a1, a1)
    bc = gl64.mul(a1, a2)
    cc = gl64.mul(a2, a2)
    aaa = gl64.mul(aa, a0)
    aac = gl64.mul(aa, a2)
    abc = gl64.mul(ba, a2)
    abb = gl64.mul(ba, a1)
    acc = gl64.mul(ac, a2)
    bbb = gl64.mul(bb, a1)
    bcc = gl64.mul(bc, a2)
    ccc = gl64.mul(cc, a2)
    t = gl64.sub(
        gl64.add(
            gl64.sub(
                gl64.add(gl64.add(gl64.add(abc, abc), abc), abb),
                gl64.add(gl64.add(aaa, aac), aac),
            ),
            bcc,
        ),
        gl64.add(gl64.add(acc, bbb), ccc),
    )
    tinv = gl64.inv(t)
    i1 = gl64.mul(
        gl64.sub(gl64.add(bc, bb), gl64.add(gl64.add(aa, ac), gl64.add(ac, cc))), tinv
    )
    i2 = gl64.mul(gl64.sub(ba, cc), tinv)
    i3 = gl64.mul(gl64.sub(gl64.add(ac, cc), bb), tinv)
    return _mk3(i1, i2, i3)


def div(a, b):
    return mul(a, inv(b))


def from_scalar(x):
    """python scalar / tuple -> numpy value."""
    if isinstance(x, (tuple, list)):
        return np.array([v % gl64.P_INT for v in x], dtype=np.uint64)
    return np.uint64(int(x) % gl64.P_INT)


def to_scalar(a):
    """numpy 0-d/1-d(3) -> python int / tuple."""
    a = np.asarray(a)
    if a.ndim == 0:
        return int(a)
    return (int(a[0]), int(a[1]), int(a[2]))
