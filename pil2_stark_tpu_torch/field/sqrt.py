"""Square roots in the Goldilocks field — Tonelli-Shanks.

Counterpart of pil2-stark-js src/helpers/sqrt.js (buildSqrt attaches a
sqrt to F; p % 16 == 1 selects the general Tonelli-Shanks path, alg5
:37-80).  Host-side scalar utility (used by the plonkish final tiers).
"""
from __future__ import annotations

P = 0xFFFFFFFF00000001
S = 32  # 2-adicity
T = (P - 1) >> S  # odd
NQR = 7  # smallest quadratic non-residue (f3g.js nqr)


def legendre(a: int) -> int:
    """1 if QR, -1 if non-residue, 0 if zero."""
    a %= P
    if a == 0:
        return 0
    r = pow(a, (P - 1) // 2, P)
    return 1 if r == 1 else -1


def sqrt(a: int) -> int | None:
    """Principal square root (the smaller of the pair), or None if a is a
    non-residue."""
    a %= P
    if a == 0:
        return 0
    if legendre(a) != 1:
        return None
    # Tonelli-Shanks
    z = pow(NQR, T, P)  # generator of the 2-Sylow subgroup
    m = S
    c = z
    t = pow(a, T, P)
    r = pow(a, (T + 1) // 2, P)
    while t != 1:
        # find least i with t^(2^i) == 1
        i = 0
        t2 = t
        while t2 != 1:
            t2 = t2 * t2 % P
            i += 1
        b = pow(c, 1 << (m - i - 1), P)
        m = i
        c = b * b % P
        t = t * c % P
        r = r * b % P
    return min(r, P - r)
