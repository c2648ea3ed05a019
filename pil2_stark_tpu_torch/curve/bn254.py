"""BN254 (alt_bn128) curve arithmetic: G1/G2, optimal-ate pairing, MSM.

The on-chain leg of the proof-composition chain (the reference delegates
this to ffjavascript/wasmcurves + shplonkjs; see
pil2-stark-js src/fflonk/helpers/fflonk_prover_helpers.js:1-8).  The
fflonk tier runs at recursion sizes (2^10..2^17 domains), far below any
accelerator crossover for 254-bit arithmetic, so this is a host implementation
over python ints — the same placement the reference uses (WASM on the
host).  Curve parameters are the EIP-196/197 standard:

  q  = 21888242871839275222246405745257275088696311157297823662689037894645226208583
  r  = 21888242871839275222246405745257275088548364400416034343698204186575808495617
  E/Fq:  y^2 = x^3 + 3,              G1 = (1, 2)
  E'/Fq2: y^2 = x^3 + 3/(9+i),       (D-type sextic twist, i^2 = -1)

The pairing follows the standard optimal-ate construction with the
pseudo-binary Miller loop count 6x+2 (x = 4965661367192848881) and a
plain final exponentiation f^((q^12-1)/r); Fq12 is realised directly as
Fq[w]/(w^12 - 18 w^6 + 82), the polynomial obtained by composing the
tower (i^2 = -1, v^3 = 9+i, w^2 = v), so G2 points untwist to Fq12
coordinates (x*w^2, y*w^3) and line functions evaluate at G1 points cast
into Fq12.  Self-tested by bilinearity/non-degeneracy in
tests/test_bn254.py and held to the JAX package's copy in
tests/test_torch_bn254.py (no external vectors needed: the subgroup orders and
twist equation pin the curve down).
"""
from __future__ import annotations

Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

X_PARAM = 4965661367192848881
ATE_LOOP_COUNT = 6 * X_PARAM + 2  # 29793968203157093288

# ---------------------------------------------------------------------------
# Fq2 = Fq[i]/(i^2+1): elements are (a, b) = a + b*i
# ---------------------------------------------------------------------------


def fq2_add(x, y):
    return ((x[0] + y[0]) % Q, (x[1] + y[1]) % Q)


def fq2_sub(x, y):
    return ((x[0] - y[0]) % Q, (x[1] - y[1]) % Q)


def fq2_neg(x):
    return ((-x[0]) % Q, (-x[1]) % Q)


def fq2_mul(x, y):
    a0, a1 = x
    b0, b1 = y
    t0 = a0 * b0
    t1 = a1 * b1
    return ((t0 - t1) % Q, ((a0 + a1) * (b0 + b1) - t0 - t1) % Q)


def fq2_scalar(x, k):
    return ((x[0] * k) % Q, (x[1] * k) % Q)


def fq2_sq(x):
    a0, a1 = x
    return ((a0 + a1) * (a0 - a1) % Q, 2 * a0 * a1 % Q)


def fq2_inv(x):
    a0, a1 = x
    d = pow(a0 * a0 + a1 * a1, Q - 2, Q)
    return ((a0 * d) % Q, (-a1 * d) % Q)


FQ2_ONE = (1, 0)
FQ2_ZERO = (0, 0)

# twist curve coefficient b' = 3 / (9 + i)
TWIST_B = fq2_mul((3, 0), fq2_inv((9, 1)))

G1 = (1, 2)
G2 = (
    (
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    (
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
)

# ---------------------------------------------------------------------------
# Fq12 = Fq[w]/(w^12 - 18 w^6 + 82): coefficient tuples, length 12
# ---------------------------------------------------------------------------

FQ12_ONE = (1,) + (0,) * 11
FQ12_ZERO = (0,) * 12


def fq12_mul(x, y):
    # schoolbook 12x12 then reduce w^k (k>=12) via w^12 = 18 w^6 - 82
    t = [0] * 23
    for i, xi in enumerate(x):
        if xi:
            for j, yj in enumerate(y):
                t[i + j] += xi * yj
    for k in range(22, 11, -1):
        c = t[k]
        if c:
            t[k - 6] += 18 * c
            t[k - 12] -= 82 * c
            t[k] = 0
    return tuple(v % Q for v in t[:12])


def fq12_add(x, y):
    return tuple((a + b) % Q for a, b in zip(x, y))


def fq12_sub(x, y):
    return tuple((a - b) % Q for a, b in zip(x, y))


def fq12_scalar(x, k):
    return tuple((a * k) % Q for a in x)


def fq12_neg(x):
    return tuple((-a) % Q for a in x)


def _poly_deg(p):
    d = len(p) - 1
    while d > 0 and p[d] == 0:
        d -= 1
    return d


def _poly_divmod(a_, b_):
    """Long division in Fq[w]: returns (quotient, remainder)."""
    da, db = _poly_deg(a_), _poly_deg(b_)
    rem = list(a_)
    if da < db:
        return [0], [v % Q for v in rem]
    quo = [0] * (da - db + 1)
    binv = pow(b_[db], Q - 2, Q)
    for i in range(da - db, -1, -1):
        c = rem[db + i] * binv % Q
        quo[i] = c
        for j in range(db + 1):
            rem[i + j] = (rem[i + j] - c * b_[j]) % Q
    return quo, [v % Q for v in rem]


def fq12_inv(x):
    """Extended Euclid over Fq[w] against m(w) = w^12 - 18 w^6 + 82."""
    m = [82, 0, 0, 0, 0, 0, (-18) % Q, 0, 0, 0, 0, 0, 1]
    # invariants: s_hi * x ≡ hi (mod m), s_lo * x ≡ lo (mod m)
    hi, lo = m, list(x)
    s_hi, s_lo = [0], [1]
    while _poly_deg(lo) > 0:
        q_, r_ = _poly_divmod(hi, lo)
        # s_new = s_hi - q*s_lo
        s_new = [0] * max(len(s_hi), len(q_) + len(s_lo))
        for i, v in enumerate(s_hi):
            s_new[i] = v
        for i, qi in enumerate(q_):
            if qi:
                for j, sj in enumerate(s_lo):
                    s_new[i + j] = (s_new[i + j] - qi * sj) % Q
        hi, lo = lo, r_
        s_hi, s_lo = s_lo, s_new
    if _poly_deg(lo) != 0 or lo[0] == 0:
        raise ZeroDivisionError("fq12_inv of zero / non-invertible element")
    c = pow(lo[0], Q - 2, Q)
    out = [v * c % Q for v in s_lo] + [0] * 12
    # s_lo may have degree >= 12; reduce mod m
    _, red = _poly_divmod(out[: max(len(s_lo), 12) + 1], m)
    red = red + [0] * 12
    return tuple(red[i] % Q for i in range(12))


def fq12_pow(x, e):
    out = FQ12_ONE
    while e:
        if e & 1:
            out = fq12_mul(out, x)
        x = fq12_mul(x, x)
        e >>= 1
    return out


def fq12_conj(x):
    """Conjugate over Fq6: negate odd powers of w (w -> -w)."""
    return tuple(v if i % 2 == 0 else (-v) % Q for i, v in enumerate(x))


# Frobenius on Fq12: (sum a_i w^i)^q = sum a_i^q * w^(i*q); w^q = w * w^(q-1)
# and w^(q-1) = (w^6)^((q-1)/6) reduces to a constant in Fq[w^6]... easier:
# precompute gamma_i = w^(i*(q-1)) as Fq12 elements once.
_FROB_GAMMA = None


def _frob_gammas():
    global _FROB_GAMMA
    if _FROB_GAMMA is None:
        w_ = (0, 1) + (0,) * 10
        wq = fq12_pow(w_, Q)
        _FROB_GAMMA = []
        cur = FQ12_ONE
        for _ in range(12):
            _FROB_GAMMA.append(cur)
            cur = fq12_mul(cur, wq)
    return _FROB_GAMMA


def fq12_frobenius(x):
    """x^q via gamma table (coefficients are in Fq, so a_i^q = a_i)."""
    g = _frob_gammas()
    out = FQ12_ZERO
    for i, a in enumerate(x):
        if a:
            out = fq12_add(out, fq12_scalar(g[i], a))
    return out


# ---------------------------------------------------------------------------
# G1 arithmetic (affine + jacobian over Fq)
# ---------------------------------------------------------------------------


def g1_is_on_curve(p):
    if p is None:
        return True
    x, y = p
    return (y * y - x * x * x - 3) % Q == 0


def g1_neg(p):
    return None if p is None else (p[0], (-p[1]) % Q)


def g1_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % Q == 0:
            return None
        lam = (3 * x1 * x1) * pow(2 * y1, Q - 2, Q) % Q
    else:
        lam = (y2 - y1) * pow(x2 - x1, Q - 2, Q) % Q
    x3 = (lam * lam - x1 - x2) % Q
    y3 = (lam * (x1 - x3) - y1) % Q
    return (x3, y3)


def g1_mul(p, k):
    k %= R
    out = None
    while k:
        if k & 1:
            out = g1_add(out, p)
        p = g1_add(p, p)
        k >>= 1
    return out


# jacobian helpers for MSM speed: (X, Y, Z), affine x = X/Z^2, y = Y/Z^3
def _jac_from_affine(p):
    return (p[0], p[1], 1) if p is not None else (1, 1, 0)


def _jac_double(p):
    X1, Y1, Z1 = p
    if Z1 == 0 or Y1 == 0:
        return (1, 1, 0)
    A = X1 * X1 % Q
    B = Y1 * Y1 % Q
    C = B * B % Q
    D = 2 * ((X1 + B) * (X1 + B) - A - C) % Q
    E = 3 * A % Q
    F = E * E % Q
    X3 = (F - 2 * D) % Q
    Y3 = (E * (D - X3) - 8 * C) % Q
    Z3 = 2 * Y1 * Z1 % Q
    return (X3, Y3, Z3)


def _jac_add(p, q_):
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q_
    if Z1 == 0:
        return q_
    if Z2 == 0:
        return p
    Z1Z1 = Z1 * Z1 % Q
    Z2Z2 = Z2 * Z2 % Q
    U1 = X1 * Z2Z2 % Q
    U2 = X2 * Z1Z1 % Q
    S1 = Y1 * Z2 * Z2Z2 % Q
    S2 = Y2 * Z1 * Z1Z1 % Q
    if U1 == U2:
        if S1 != S2:
            return (1, 1, 0)
        return _jac_double(p)
    H = (U2 - U1) % Q
    I = 4 * H * H % Q
    J = H * I % Q
    r_ = 2 * (S2 - S1) % Q
    V = U1 * I % Q
    X3 = (r_ * r_ - J - 2 * V) % Q
    Y3 = (r_ * (V - X3) - 2 * S1 * J) % Q
    Z3 = ((Z1 + Z2) * (Z1 + Z2) - Z1Z1 - Z2Z2) % Q * H % Q
    return (X3, Y3, Z3)


def _jac_to_affine(p):
    X, Y, Z = p
    if Z == 0:
        return None
    zi = pow(Z, Q - 2, Q)
    zi2 = zi * zi % Q
    return (X * zi2 % Q, Y * zi2 % Q * zi % Q)


def g1_msm(points, scalars):
    """Pippenger multi-scalar multiplication: sum scalars[i]*points[i].

    points: list of affine G1 (or None); scalars: list of ints mod R.
    """
    pairs = [
        (p, s % R) for p, s in zip(points, scalars) if p is not None and s % R
    ]
    if not pairs:
        return None
    n = len(pairs)
    c = 4 if n < 32 else max(4, n.bit_length() - 3)
    nbits = 256
    nwin = -(-nbits // c)
    acc = (1, 1, 0)
    for win in range(nwin - 1, -1, -1):
        for _ in range(c):
            acc = _jac_double(acc)
        buckets = {}
        shift = win * c
        mask = (1 << c) - 1
        for p, s in pairs:
            b = (s >> shift) & mask
            if b:
                if b in buckets:
                    buckets[b] = _jac_add(buckets[b], _jac_from_affine(p))
                else:
                    buckets[b] = _jac_from_affine(p)
        if buckets:
            running = (1, 1, 0)
            winsum = (1, 1, 0)
            for b in range(mask, 0, -1):
                if b in buckets:
                    running = _jac_add(running, buckets[b])
                winsum = _jac_add(winsum, running)
            acc = _jac_add(acc, winsum)
    return _jac_to_affine(acc)


# ---------------------------------------------------------------------------
# G2 arithmetic (affine over Fq2, on the twist)
# ---------------------------------------------------------------------------


def g2_is_on_curve(p):
    if p is None:
        return True
    x, y = p
    return fq2_sub(fq2_sq(y), fq2_add(fq2_mul(fq2_sq(x), x), TWIST_B)) == FQ2_ZERO


def g2_neg(p):
    return None if p is None else (p[0], fq2_neg(p[1]))


def g2_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if fq2_add(y1, y2) == FQ2_ZERO:
            return None
        lam = fq2_mul(fq2_scalar(fq2_sq(x1), 3), fq2_inv(fq2_scalar(y1, 2)))
    else:
        lam = fq2_mul(fq2_sub(y2, y1), fq2_inv(fq2_sub(x2, x1)))
    x3 = fq2_sub(fq2_sub(fq2_sq(lam), x1), x2)
    y3 = fq2_sub(fq2_mul(lam, fq2_sub(x1, x3)), y1)
    return (x3, y3)


def g2_mul(p, k):
    k %= R
    out = None
    while k:
        if k & 1:
            out = g2_add(out, p)
        p = g2_add(p, p)
        k >>= 1
    return out


# ---------------------------------------------------------------------------
# Pairing
# ---------------------------------------------------------------------------


def _twist_to_fq12(p):
    """Map a twist point (Fq2 coords) into E(Fq12): (x w^2, y w^3).

    With i^2 = -1 embedded as i = (w^6 - 9)/1? — concretely: under
    w^12 - 18w^6 + 82, the element u = w^6 - 9 satisfies u^2 = -1? No:
    (w^6-9)^2 = w^12 - 18w^6 + 81 = -82 + 81 = -1.  So i maps to w^6 - 9,
    and an Fq2 element (a, b) embeds as a + b*(w^6 - 9)."""
    if p is None:
        return None
    (x0, x1), (y0, y1) = p

    def emb(a, b):
        co = [0] * 12
        co[0] = (a - 9 * b) % Q
        co[6] = b % Q
        return tuple(co)

    w2 = (0, 0, 1) + (0,) * 9
    w3 = (0, 0, 0, 1) + (0,) * 8
    return (fq12_mul(emb(x0, x1), w2), fq12_mul(emb(y0, y1), w3))


def _cast_g1_fq12(p):
    x, y = p
    return ((x,) + (0,) * 11, (y,) + (0,) * 11)


def _line(p1, p2, t):
    """Evaluate the line through p1,p2 (E(Fq12) points) at t."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        m = fq12_mul(fq12_sub(y2, y1), fq12_inv(fq12_sub(x2, x1)))
        return fq12_sub(fq12_mul(m, fq12_sub(xt, x1)), fq12_sub(yt, y1))
    if y1 == y2:
        m = fq12_mul(fq12_scalar(fq12_mul(x1, x1), 3), fq12_inv(fq12_scalar(y1, 2)))
        return fq12_sub(fq12_mul(m, fq12_sub(xt, x1)), fq12_sub(yt, y1))
    return fq12_sub(xt, x1)


def _fq12_point_add(p1, p2):
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2 and y1 == y2:
        m = fq12_mul(fq12_scalar(fq12_mul(x1, x1), 3), fq12_inv(fq12_scalar(y1, 2)))
    elif x1 == x2:
        return None
    else:
        m = fq12_mul(fq12_sub(y2, y1), fq12_inv(fq12_sub(x2, x1)))
    x3 = fq12_sub(fq12_sub(fq12_mul(m, m), x1), x2)
    y3 = fq12_sub(fq12_mul(m, fq12_sub(x1, x3)), y1)
    return (x3, y3)


def miller_loop(q_, p):
    """Miller loop of the optimal-ate pairing.  q_: untwisted G2 in
    E(Fq12); p: G1 cast into Fq12."""
    if q_ is None or p is None:
        return FQ12_ONE
    r_ = q_
    f = FQ12_ONE
    for b in bin(ATE_LOOP_COUNT)[3:]:
        f = fq12_mul(fq12_mul(f, f), _line(r_, r_, p))
        r_ = _fq12_point_add(r_, r_)
        if b == "1":
            f = fq12_mul(f, _line(r_, q_, p))
            r_ = _fq12_point_add(r_, q_)
    # frobenius endomorphism corrections
    q1 = (fq12_frobenius(q_[0]), fq12_frobenius(q_[1]))
    nq2 = (fq12_frobenius(q1[0]), fq12_neg(fq12_frobenius(q1[1])))
    f = fq12_mul(f, _line(r_, q1, p))
    r_ = _fq12_point_add(r_, q1)
    f = fq12_mul(f, _line(r_, nq2, p))
    return f


_FINAL_EXP = (Q**12 - 1) // R


def final_exponentiate(f):
    return fq12_pow(f, _FINAL_EXP)


def pairing(p, q_):
    """e(P, Q) for P in G1, Q in G2 (twist coords)."""
    assert g1_is_on_curve(p), "P not on G1"
    assert g2_is_on_curve(q_), "Q not on G2 twist"
    if p is None or q_ is None:
        return FQ12_ONE
    return final_exponentiate(miller_loop(_twist_to_fq12(q_), _cast_g1_fq12(p)))


def pairing_check(pairs):
    """prod e(P_i, Q_i) == 1 — single final exponentiation over the
    product of Miller loops (the standard batched check)."""
    f = FQ12_ONE
    for p, q_ in pairs:
        if p is None or q_ is None:
            continue
        f = fq12_mul(f, miller_loop(_twist_to_fq12(q_), _cast_g1_fq12(p)))
    return fq12_pow(f, _FINAL_EXP) == FQ12_ONE
