"""The BN254 layers of the port's SNARK tier against the JAX package's on
the CPU: the Fr NTT (ops/fft_bn128.py), the curve (curve/bn254.py),
keccak256, the Fr polynomials (protocol/poly_fr.py) and the dev powers of
tau.  The same inputs, drawn with numpy's default_rng(seed), go through
both packages; every result must be the same Python ints.  All host
Python (as in the reference): no device, no torch."""
import numpy as np
import pytest

from pil2_stark_tpu.curve import bn254 as jcurve
from pil2_stark_tpu.ops import fft_bn128 as jfft
from pil2_stark_tpu.protocol import keccak as jkeccak, poly_fr as jpoly, shplonk as jshplonk
from pil2_stark_tpu_torch.curve import bn254 as curve
from pil2_stark_tpu_torch.ops import fft_bn128 as fft
from pil2_stark_tpu_torch.protocol import keccak, poly_fr as poly, shplonk

FR = fft.FR
R = curve.R


def _scalars(n, seed, mod=FR):
    """n Python ints below `mod` from numpy's default_rng(seed)."""
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % mod for _ in range(n)]


@pytest.fixture(scope="module")
def points():
    """64 G1 points (a walk p_i = p_(i-1) + q from two random multiples of
    G1, made by the JAX package) and 64 scalars."""
    k0, k1 = _scalars(2, 1, R)
    pts = [jcurve.g1_mul(jcurve.G1, k0)]
    q = jcurve.g1_mul(jcurve.G1, k1)
    while len(pts) < 64:
        pts.append(jcurve.g1_add(pts[-1], q))
    return pts, _scalars(64, 2, R)


# -- the Fr NTT -----------------------------------------------------------------


def test_fr_ntt_intt_roots_and_interpolate_equal_jax():
    for bits in (0, 1, 3, 6):
        vals = _scalars(1 << bits, 10 + bits)
        assert fft.ntt(vals) == jfft.ntt(vals)
        assert fft.intt(vals) == jfft.intt(vals)
        assert fft.intt(fft.ntt(vals)) == vals
    assert [fft.w(s) for s in range(29)] == [jfft.w(s) for s in range(29)]
    assert [fft.w_inv(s) for s in range(29)] == [jfft.w_inv(s) for s in range(29)]
    vals = _scalars(1 << 6, 20)
    for shift in (1, 7):
        assert fft.interpolate(vals, 6, 8, shift=shift) == jfft.interpolate(vals, 6, 8, shift=shift)


# -- the curve --------------------------------------------------------------------


def test_g1_add_mul_equal_jax(points):
    pts, ks = points
    for p, q in zip(pts, pts[7:] + pts[:7]):
        assert curve.g1_add(p, q) == jcurve.g1_add(p, q)
        assert curve.g1_add(p, p) == jcurve.g1_add(p, p)
        assert curve.g1_neg(p) == jcurve.g1_neg(p)
    for p, k in zip(pts[:4], ks):
        assert curve.g1_mul(p, k) == jcurve.g1_mul(p, k)
    assert curve.g1_add(pts[0], curve.g1_neg(pts[0])) is None
    assert curve.g1_mul(curve.G1, R) is None


def test_g1_msm_equal_jax(points):
    pts, ks = points
    got = curve.g1_msm(pts, ks)
    assert got == jcurve.g1_msm(pts, ks)
    assert curve.g1_is_on_curve(got)
    # zero scalars and the identity point
    assert curve.g1_msm([curve.G1, None], [0, 5]) is None
    assert curve.g1_msm(pts[:5] + [None], ks[:5] + [3]) == jcurve.g1_msm(pts[:5] + [None],
                                                                         ks[:5] + [3])


def test_g2_and_pairing_check_equal_jax():
    a, b = _scalars(2, 3, R)
    assert curve.g2_mul(curve.G2, a) == jcurve.g2_mul(jcurve.G2, a)
    pairs = [(curve.g1_mul(curve.G1, a * b % R), curve.G2),
             (curve.g1_neg(curve.g1_mul(curve.G1, a)), curve.g2_mul(curve.G2, b))]
    assert curve.pairing_check(pairs) is True
    assert jcurve.pairing_check(pairs) is True
    wrong = [pairs[0], (curve.g1_neg(curve.G1), curve.g2_mul(curve.G2, b))]
    assert curve.pairing_check(wrong) is False


# -- keccak, polynomials, powers of tau ---------------------------------------


def test_keccak_poly_fr_and_dev_ptau_equal_jax():
    for n in (0, 3, 135, 136, 137, 200, 400):  # across the 136-byte rate
        data = np.random.default_rng(30 + n).bytes(n)
        assert keccak.keccak256(data) == jkeccak.keccak256(data)
    assert keccak.keccak256(b"").hex() == (
        "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470")

    a, b = _scalars(9, 40), _scalars(4, 41)
    x = _scalars(1, 42)[0]
    for name, args in (("poly_add", (a, b)), ("poly_sub", (b, a)), ("poly_scale", (a, x)),
                       ("poly_mul", (a, b)), ("poly_eval", (a, x)), ("poly_divmod", (a, b)),
                       ("poly_zerofier", (b,)), ("poly_trim", (a + [0, 0],)),
                       ("poly_degree", (a + [0],)), ("coefs_from_evals", (_scalars(8, 43),)),
                       ("evals_from_coefs", (b, 3)), ("domain_w", (5,))):
        assert getattr(poly, name)(*args) == getattr(jpoly, name)(*args), name
    pts = list(zip(_scalars(5, 44), _scalars(5, 45)))
    coefs = poly.poly_interpolate(pts)
    assert coefs == jpoly.poly_interpolate(pts)
    assert all(poly.poly_eval(coefs, px) == py for px, py in pts)
    q, r = poly.poly_divmod(a, b)
    assert poly.poly_add(poly.poly_mul(q, b), r) == poly.poly_trim(a)

    tau = _scalars(1, 50)[0] or 1
    got = shplonk.dev_ptau(8, tau=tau)
    assert got == jshplonk.dev_ptau(8, tau=tau)
    assert got["g1"][2] == curve.g1_mul(curve.G1, tau * tau % R)
    assert shplonk.dev_ptau(3) == jshplonk.dev_ptau(3)  # the seeded default tau
