"""Dense polynomial arithmetic over BN254-Fr (host-side, python ints).

Support layer for the shplonk/fflonk tier (counterpart of shplonkjs'
src/polynomial/polynomial.js, which the reference imports in
pil2-stark-js src/fflonk/helpers/fflonk_prover_helpers.js:2).  The
fflonk tier runs at recursion sizes (N <= 2^17) where 254-bit coefficient
arithmetic on the host is the right placement — same as the reference's
WASM.  Coefficients are little-endian lists of ints (coef[i] multiplies
X^i), always reduced mod FR.
"""
from __future__ import annotations

from ..ops.fft_bn128 import FR, ntt, w


def poly_trim(p: list) -> list:
    d = len(p) - 1
    while d > 0 and p[d] == 0:
        d -= 1
    return p[: d + 1]


def poly_degree(p: list) -> int:
    d = len(p) - 1
    while d > 0 and p[d] == 0:
        d -= 1
    return d


def poly_add(a: list, b: list) -> list:
    n = max(len(a), len(b))
    return [((a[i] if i < len(a) else 0) + (b[i] if i < len(b) else 0)) % FR
            for i in range(n)]


def poly_sub(a: list, b: list) -> list:
    n = max(len(a), len(b))
    return [((a[i] if i < len(a) else 0) - (b[i] if i < len(b) else 0)) % FR
            for i in range(n)]


def poly_scale(a: list, k: int) -> list:
    return [(v * k) % FR for v in a]


def poly_mul(a: list, b: list) -> list:
    """Schoolbook below 64 terms, NTT above."""
    if not a or not b:
        return [0]
    if min(len(a), len(b)) < 64:
        out = [0] * (len(a) + len(b) - 1)
        for i, x in enumerate(a):
            if x:
                for j, y in enumerate(b):
                    out[i + j] += x * y
        return [v % FR for v in out]
    n = 1 << (len(a) + len(b) - 2).bit_length()
    fa = ntt(list(a) + [0] * (n - len(a)))
    fb = ntt(list(b) + [0] * (n - len(b)))
    prod = [(x * y) % FR for x, y in zip(fa, fb)]
    return poly_trim(ntt(prod, inverse=True)[: len(a) + len(b) - 1])


def poly_eval(p: list, x: int) -> int:
    acc = 0
    for c in reversed(p):
        acc = (acc * x + c) % FR
    return acc


def poly_divmod(a: list, b: list) -> tuple:
    """Long division: a = q*b + r with deg r < deg b."""
    a = [v % FR for v in a]
    db = poly_degree(b)
    da = poly_degree(a)
    if da < db:
        return [0], poly_trim(a)
    binv = pow(b[db], FR - 2, FR)
    rem = list(a[: da + 1])
    quo = [0] * (da - db + 1)
    for i in range(da - db, -1, -1):
        c = rem[db + i] * binv % FR
        quo[i] = c
        if c:
            for j in range(db + 1):
                rem[i + j] = (rem[i + j] - c * b[j]) % FR
    return quo, poly_trim(rem)


def poly_zerofier(roots: list) -> list:
    """Z(X) = prod (X - r) via balanced product tree."""
    polys = [[(-r) % FR, 1] for r in roots] or [[1]]
    while len(polys) > 1:
        nxt = []
        for i in range(0, len(polys) - 1, 2):
            nxt.append(poly_mul(polys[i], polys[i + 1]))
        if len(polys) % 2:
            nxt.append(polys[-1])
        polys = nxt
    return polys[0]


def poly_interpolate(points: list) -> list:
    """Lagrange interpolation through [(x_i, y_i)] (small sets: the root
    sets of a shplonk opening are at most a few dozen points)."""
    n = len(points)
    if n == 0:
        return [0]
    z = poly_zerofier([x for x, _ in points])
    out = [0] * n
    for x_i, y_i in points:
        # numerator: Z(X)/(X - x_i) by synthetic division
        num = [0] * (len(z) - 1)
        carry = 0
        for j in range(len(z) - 1, 0, -1):
            carry = (z[j] + carry * x_i) % FR
            num[j - 1] = carry
        denom = poly_eval(num, x_i)
        c = y_i * pow(denom, FR - 2, FR) % FR
        for j, v in enumerate(num):
            out[j] = (out[j] + c * v) % FR
    return poly_trim(out)


def coefs_from_evals(evals: list) -> list:
    """Monomial coefficients from evaluations on the 2^k domain."""
    return ntt(list(evals), inverse=True)


def evals_from_coefs(coefs: list, bits: int) -> list:
    n = 1 << bits
    assert len(coefs) <= n
    return ntt(list(coefs) + [0] * (n - len(coefs)))


def domain_w(bits: int) -> int:
    return w(bits)
