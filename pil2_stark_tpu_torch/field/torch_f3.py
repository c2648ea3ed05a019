"""Cubic extension F_p[x]/(x^3 - x - 1) over torch_gl tensors.

Counterpart of pil2_stark_tpu/field/jax_f3.py.  A value is an int64 tensor
with a leading axis of size d in {1, 3}: d=1 is a base-field vector, d=3 an
extension vector, (3, N) in the planar layout.  Mixed-dim op semantics
mirror the reference's dual representation (f3g.js:47-131): base + ext
touches only component 0.
"""
from __future__ import annotations

import torch

from . import torch_gl as gl


def dim(a) -> int:
    return a.shape[0]


def stack(rows):
    """Stack component vectors, broadcasting to a common shape."""
    shape = torch.broadcast_shapes(*[r.shape for r in rows])
    return torch.stack([r.expand(shape) for r in rows])


def add(a, b):
    da, db = dim(a), dim(b)
    if da == db:
        return gl.add(a, b)
    if da == 1:
        a, b = b, a  # a is now dim3
    return stack([gl.add(a[0], b[0]), a[1], a[2]])


def sub(a, b):
    da, db = dim(a), dim(b)
    if da == db:
        return gl.sub(a, b)
    if da == 3:  # ext - base
        return stack([gl.sub(a[0], b[0]), a[1], a[2]])
    # base - ext
    return stack([gl.sub(a[0], b[0]), gl.neg(b[1]), gl.neg(b[2])])


def neg(a):
    return gl.neg(a)


def mul(a, b):
    if dim(a) == 1 or dim(b) == 1:
        return gl.mul(a, b)  # broadcasting (1,...)×(d,...) scalar action
    a0, a1, a2 = a[0], a[1], a[2]
    b0, b1, b2 = b[0], b[1], b[2]
    # Karatsuba with x^3 = x + 1 folding (f3g.js:94-102)
    A = gl.mul(gl.add(a0, a1), gl.add(b0, b1))
    B = gl.mul(gl.add(a0, a2), gl.add(b0, b2))
    C = gl.mul(gl.add(a1, a2), gl.add(b1, b2))
    D = gl.mul(a0, b0)
    E = gl.mul(a1, b1)
    F = gl.mul(a2, b2)
    G = gl.sub(D, E)
    c0 = gl.sub(gl.add(C, G), F)
    c1 = gl.sub(gl.sub(gl.add(A, C), gl.add(E, E)), D)
    c2 = gl.sub(B, G)
    return stack([c0, c1, c2])


def square(a):
    return mul(a, a)


def muladd(a, b, c):
    return add(mul(a, b), c)


def inv(a):
    """Closed-form cubic inverse (f3g.js:136-171) of a (3, ...) value; one
    base-field inversion per element."""
    a0, a1, a2 = a[0], a[1], a[2]
    aa = gl.mul(a0, a0)
    ac = gl.mul(a0, a2)
    ba = gl.mul(a1, a0)
    bb = gl.mul(a1, a1)
    bc = gl.mul(a1, a2)
    cc = gl.mul(a2, a2)

    aaa = gl.mul(aa, a0)
    aac = gl.mul(aa, a2)
    abc = gl.mul(ba, a2)
    abb = gl.mul(ba, a1)
    acc = gl.mul(ac, a2)
    bbb = gl.mul(bb, a1)
    bcc = gl.mul(bc, a2)
    ccc = gl.mul(cc, a2)

    t = gl.sub(
        gl.add(gl.add(gl.add(abc, abc), abc), gl.add(abb, bcc)),
        gl.add(gl.add(gl.add(aaa, aac), gl.add(aac, acc)), gl.add(bbb, ccc)),
    )
    tinv = gl.inv(t)
    i1 = gl.mul(gl.sub(gl.add(bc, bb), gl.add(gl.add(aa, ac), gl.add(ac, cc))), tinv)
    i2 = gl.mul(gl.sub(ba, cc), tinv)
    i3 = gl.mul(gl.sub(gl.add(ac, cc), bb), tinv)
    return torch.stack([i1, i2, i3])


def from_scalar(v, device=None) -> torch.Tensor:
    """python int / 3-tuple -> (3, 1) tensor."""
    if isinstance(v, (tuple, list)):
        vals = [gl.i64(int(x)) for x in v]
    else:
        vals = [gl.i64(int(v)), 0, 0]
    return torch.tensor(vals, dtype=torch.int64, device=device).reshape(3, 1)
