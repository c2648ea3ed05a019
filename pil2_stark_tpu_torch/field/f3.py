"""Scalar Goldilocks cubic extension F_p[x]/(x^3 - x - 1) over python ints.

Mirrors the dual-representation semantics of the reference field
(pil2-stark-js src/helpers/f3g.js): a value is either an int (base field)
or a tuple of 3 ints (extension element).  Used for host-side scalar logic:
transcript bookkeeping, the verifier's TAC interpreter, and FRI verification.
Bulk math lives in gl64 (numpy) and field.jax_gl (device).
"""
from __future__ import annotations

P = 0xFFFFFFFF00000001
SHIFT = 7
SHIFT_INV = pow(7, P - 2, P)

Elem = "int | tuple[int, int, int]"


def is3(a) -> bool:
    return isinstance(a, (tuple, list))


def e(a):
    """Canonicalize: ints mod p, triples componentwise."""
    if is3(a):
        return (int(a[0]) % P, int(a[1]) % P, int(a[2]) % P)
    return int(a) % P


def add(a, b):
    if is3(a):
        if is3(b):
            return ((a[0] + b[0]) % P, (a[1] + b[1]) % P, (a[2] + b[2]) % P)
        return ((a[0] + b) % P, a[1], a[2])
    if is3(b):
        return ((a + b[0]) % P, b[1], b[2])
    return (a + b) % P


def sub(a, b):
    if is3(a):
        if is3(b):
            return ((a[0] - b[0]) % P, (a[1] - b[1]) % P, (a[2] - b[2]) % P)
        return ((a[0] - b) % P, a[1], a[2])
    if is3(b):
        return ((a - b[0]) % P, (-b[1]) % P, (-b[2]) % P)
    return (a - b) % P


def neg(a):
    if is3(a):
        return ((-a[0]) % P, (-a[1]) % P, (-a[2]) % P)
    return (-a) % P


def mul(a, b):
    if is3(a):
        if is3(b):
            # Karatsuba-style with x^3 = x + 1 folding (f3g.js:94-102)
            A = (a[0] + a[1]) * (b[0] + b[1])
            B = (a[0] + a[2]) * (b[0] + b[2])
            C = (a[1] + a[2]) * (b[1] + b[2])
            D = a[0] * b[0]
            E = a[1] * b[1]
            F = a[2] * b[2]
            G = D - E
            return ((C + G - F) % P, (A + C - E - E - D) % P, (B - G) % P)
        return ((a[0] * b) % P, (a[1] * b) % P, (a[2] * b) % P)
    if is3(b):
        return ((a * b[0]) % P, (a * b[1]) % P, (a * b[2]) % P)
    return (a * b) % P


def square(a):
    return mul(a, a)


def inv1(a: int) -> int:
    if a % P == 0:
        raise ZeroDivisionError("Division by zero in GL field")
    return pow(a, P - 2, P)


def inv(a):
    if not is3(a):
        return inv1(a)
    # closed-form cubic inverse (f3g.js:136-171)
    aa = a[0] * a[0]
    ac = a[0] * a[2]
    ba = a[1] * a[0]
    bb = a[1] * a[1]
    bc = a[1] * a[2]
    cc = a[2] * a[2]

    aaa = aa * a[0]
    aac = aa * a[2]
    abc = ba * a[2]
    abb = ba * a[1]
    acc = ac * a[2]
    bbb = bb * a[1]
    bcc = bc * a[2]
    ccc = cc * a[2]

    t = (-aaa - aac - aac + abc + abc + abc + abb - acc - bbb + bcc - ccc) % P
    tinv = inv1(t)
    i1 = ((-aa - ac - ac + bc + bb - cc) * tinv) % P
    i2 = ((ba - cc) * tinv) % P
    i3 = ((-bb + ac + cc) * tinv) % P
    return (i1, i2, i3)


def div(a, b):
    return mul(a, inv(b))


def exp(base, ex: int):
    ex = int(ex)
    if ex == 0:
        return 1
    if ex < 0:
        return exp(inv(base), -ex)
    res = base
    for bit in bin(ex)[3:]:
        res = square(res)
        if bit == "1":
            res = mul(res, base)
    return res


def eq(a, b) -> bool:
    if is3(a):
        if is3(b):
            return a[0] == b[0] and a[1] == b[1] and a[2] == b[2]
        return a[0] == b % P and a[1] == 0 and a[2] == 0
    if is3(b):
        return b[0] == a % P and b[1] == 0 and b[2] == 0
    return a % P == b % P


def is_zero(a) -> bool:
    if is3(a):
        return a[0] == 0 and a[1] == 0 and a[2] == 0
    return a % P == 0


def as3(a):
    if is3(a):
        return tuple(a)
    return (a % P, 0, 0)


def batch_inverse(vals):
    n = len(vals)
    if n == 0:
        return []
    tmp = [None] * n
    tmp[0] = vals[0]
    for i in range(1, n):
        tmp[i] = mul(tmp[i - 1], vals[i])
    z = inv(tmp[n - 1])
    res = [None] * n
    for i in range(n - 1, 0, -1):
        res[i] = mul(z, tmp[i - 1])
        z = mul(z, vals[i])
    res[0] = z
    return res


# root-of-unity chain shared with gl64
from . import gl64 as _gl64  # noqa: E402

w = _gl64.w
w_inv = _gl64.w_inv
