"""Radix-2 NTT over the BN254 scalar field Fr (host-side python ints).

Counterpart of the reference's BN128 FFT layer
(pil2-stark-js src/helpers/fft/fft_p.bn128.js and ffjavascript's in-memory
FFT): ``ntt``/``intt`` compute the same DFT with the same root-of-unity
chain, and ``interpolate`` mirrors fft_p.bn128 interpolate — iNTT(N) →
coset scale by shift^i → zero-pad → NTT(extN).

The fflonk tier runs at recursion sizes (N ≤ 2^17) on 254-bit coefficients;
host python-int arithmetic is the right placement for that width (the
reference likewise runs it in WASM bigints, not in its hot native path), so
this module is deliberately numpy-free.  The Goldilocks NTT in
``ops.ntt`` (kernels B1-B3) remains the card's hot path.  Host copy of
the JAX package's ops/fft_bn128.py.

Root-of-unity schedule matches ffjavascript's ZqField: the generator is the
smallest quadratic non-residue found by Euler's criterion (5 for this Fr),
w[s] = nqr^((r-1)/2^s), identical to the w-chain circom/snarkjs bake into
their domains.
"""
from __future__ import annotations

import functools

# BN254 (alt_bn128) group order = Fr modulus.
FR = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# 2-adicity: r - 1 = 2^28 * T with T odd.
S = 28
_T_ODD = (FR - 1) >> S
assert _T_ODD & 1


@functools.lru_cache(maxsize=1)
def _nqr() -> int:
    """Smallest quadratic non-residue, by Euler's criterion — the exact
    search ffjavascript's ZqField constructor performs."""
    g = 2
    while pow(g, (FR - 1) // 2, FR) == 1:
        g += 1
    return g


@functools.lru_cache(maxsize=None)
def w(bits: int) -> int:
    """2^bits-th root of unity (F.w[bits] in ffjavascript)."""
    if bits > S:
        raise ValueError(f"no 2^{bits} root of unity in Fr (2-adicity {S})")
    return pow(_nqr(), _T_ODD << (S - bits), FR)


@functools.lru_cache(maxsize=None)
def w_inv(bits: int) -> int:
    return pow(w(bits), FR - 2, FR)


def _bit_reverse(vals: list) -> list:
    n = len(vals)
    bits = n.bit_length() - 1
    out = list(vals)
    for i in range(n):
        j = int(format(i, f"0{bits}b")[::-1], 2) if bits else 0
        if j > i:
            out[i], out[j] = out[j], out[i]
    return out


@functools.lru_cache(maxsize=None)
def _twiddles(bits: int, inverse: bool) -> tuple:
    half = 1 << (bits - 1)
    base = w_inv(bits) if inverse else w(bits)
    tw = [1] * half
    for i in range(1, half):
        tw[i] = tw[i - 1] * base % FR
    return tuple(tw)


def ntt(vals: list, inverse: bool = False) -> list:
    """Iterative radix-2 DIT NTT, natural order in/out.  len(vals) must be a
    power of two.  inverse=True applies the 1/n scale."""
    n = len(vals)
    if n == 1:
        return [vals[0] % FR]
    bits = n.bit_length() - 1
    assert 1 << bits == n, "length must be a power of two"
    a = _bit_reverse([v % FR for v in vals])
    for s in range(1, bits + 1):
        m = 1 << s
        half = m >> 1
        tw = _twiddles(s, inverse)
        for start in range(0, n, m):
            for j in range(half):
                u = a[start + j]
                t = a[start + j + half] * tw[j] % FR
                a[start + j] = (u + t) % FR
                a[start + j + half] = (u - t) % FR
    if inverse:
        n_inv = pow(n, FR - 2, FR)
        a = [v * n_inv % FR for v in a]
    return a


def intt(vals: list) -> list:
    return ntt(vals, inverse=True)


def interpolate(col: list, n_bits: int, n_bits_ext: int, shift: int = 1) -> list:
    """Low-degree extension onto shift·H_ext (fft_p.bn128.js interpolate):
    iNTT(2^n_bits) → scale coef i by shift^i → zero-pad → NTT(2^n_bits_ext)."""
    n = 1 << n_bits
    ext_n = 1 << n_bits_ext
    assert len(col) == n
    coefs = intt(col)
    if shift != 1:
        s = 1
        for i in range(n):
            coefs[i] = coefs[i] * s % FR
            s = s * shift % FR
    return ntt(coefs + [0] * (ext_n - n))
