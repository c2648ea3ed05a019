"""Generators for the Goldilocks verifier-circuit gadget library.

The reference ships these circuits as static data files (circuits.gl/);
here every file is EMITTED by code so the whole recursion tier is
self-contained: constants come from our own tables
(hash/poseidon_gl_constants.npz, field.gl64 root chain), and template
bodies are generated from the same round/butterfly schedules our device
kernels implement (hash/poseidon_gl.py, ops/ntt.py).

Interface contract (this is protocol, shared with the C12 compressor row
layout in compiler/compressor12.py):

- ``Poseidon12``      custom gate: in[12] -> im[9][12], out[12], with the
                      Neptune-optimized schedule (im[0..3] after the first
                      4 M-rounds, im[4] at partial round 10, im[5] after
                      the 22 partial rounds, im[6..8] inside the closing
                      rounds) — poseidon.js:77-107 semantics.
- ``CustPoseidon12``  same, with a key bit that swaps the two 4-element
                      halves (Merkle left/right ordering inside the gate).
- ``CMul``            custom gate: cubic-extension product, x^3 = x + 1.
- ``CInv``            hinted inverse + CMul check (not a custom gate).
- ``EvPol4``          custom gate: degree-4 Horner step.
- ``TreeSelector4``   custom gate: 4-way select by 2 key bits.
- ``FFT4``            custom gate: radix-4/2 butterfly with baked twiddles.
- plain templates: Poseidon/CustPoseidon wrappers, LinearHash, Merkle,
  (Verify)MerkleHash, FFT network, EvalPol, TreeSelector, Num2Bits(_strict).

Reference behavior: circuits.gl/*.circom (semantics only; bodies are
generated here).
"""
from __future__ import annotations

import numpy as np

from ..field import gl64

P = gl64.P_INT


def _load_poseidon_consts():
    import os

    path = os.path.join(
        os.path.dirname(__file__), "..", "hash", "poseidon_gl_constants.npz"
    )
    d = np.load(path)
    return d["C"], d["S"], d["M"], d["P"]


def _fn_table(name: str, values) -> str:
    n = len(values)
    body = ",\n        ".join(str(int(v)) for v in values)
    return (
        f"function {name}(i) {{\n"
        f"    var t[{n}] = [\n        {body}\n    ];\n"
        f"    return t[i];\n"
        f"}}\n"
    )


def _fn_matrix(name: str, mat) -> str:
    rows = []
    for r in np.asarray(mat):
        rows.append(", ".join(str(int(v)) for v in r))
    body = ",\n        ".join(f"[{r}]" for r in rows)
    n = len(mat)
    return (
        f"function {name}(i, j) {{\n"
        f"    var t[{n}][{n}] = [\n        {body}\n    ];\n"
        f"    return t[i][j];\n"
        f"}}\n"
    )


def emit_glutils() -> str:
    """utils.circom equivalent: log2 + root-of-unity tables from our own
    gl64 2-adic chain (f3g.js:40 provenance, recomputed)."""
    roots = [gl64.w(i) for i in range(33)]
    invroots = [gl64.w_inv(i) for i in range(33)]
    out = ["pragma circom 2.1.0;", ""]
    out.append(
        "// Compile-time helpers for the Goldilocks verifier circuits.\n"
        "// Root tables are the w[s]/wi[s] chains of the framework field\n"
        "// (pil2_stark_tpu.field.gl64), identical to the reference's f3g\n"
        "// chain squared down from the 2^32 primitive root."
    )
    out.append(
        "function log2(n) {\n"
        "    var b = 0;\n"
        "    var m = 1;\n"
        "    while (m < n) {\n"
        "        m *= 2;\n"
        "        b += 1;\n"
        "    }\n"
        "    return b;\n"
        "}\n"
    )
    out.append(_fn_table("roots", roots))
    out.append(_fn_table("invroots", invroots))
    return "\n".join(out)


# ---------------------------------------------------------------------------
# Poseidon


def _poseidon_body(first_state: str) -> str:
    """The shared Neptune-schedule body (var-math; custom gate emits the
    im checkpoints).  `first_state` is circom code that fills st[12]."""
    return f"""
    var st[12];
{first_state}
    var nx[12];

    // pre-round constant injection
    for (var k = 0; k < 12; k++) {{ st[k] = st[k] + CNST(k); }}

    // first half: 4 full rounds (last one uses the mixed P matrix)
    for (var r = 0; r < 4; r++) {{
        for (var k = 0; k < 12; k++) {{
            st[k] = st[k] ** 7;
            st[k] = st[k] + CNST(12*(r + 1) + k);
        }}
        for (var k = 0; k < 12; k++) {{
            var s = 0;
            for (var j = 0; j < 12; j++) {{
                if (r == 3) {{ s += PMAT(j, k) * st[j]; }}
                else        {{ s += MMAT(j, k) * st[j]; }}
            }}
            nx[k] = s;
        }}
        st = nx;
        im[r] <-- st;
    }}

    // 22 partial rounds via the sparse S-vector trick
    st[0] = st[0] ** 7;
    st[0] = st[0] + CNST(60);
    for (var r = 0; r < 22; r++) {{
        var s0 = 0;
        for (var j = 0; j < 12; j++) {{ s0 += SVEC(23*r + j) * st[j]; }}
        for (var k = 1; k < 12; k++) {{ st[k] = st[k] + st[0] * SVEC(23*r + 11 + k); }}
        st[0] = s0;
        if (r == 10) {{ im[4] <-- st; }}
        if (r < 21) {{
            st[0] = st[0] ** 7;
            st[0] = st[0] + CNST(61 + r);
        }}
    }}
    im[5] <-- st;

    // second half: 4 full rounds (no constants on the last)
    for (var r = 0; r < 4; r++) {{
        for (var k = 0; k < 12; k++) {{
            st[k] = st[k] ** 7;
            if (r < 3) {{ st[k] = st[k] + CNST(82 + 12*r + k); }}
        }}
        for (var k = 0; k < 12; k++) {{
            var s = 0;
            for (var j = 0; j < 12; j++) {{ s += MMAT(j, k) * st[j]; }}
            nx[k] = s;
        }}
        st = nx;
        if (r < 3) {{ im[6 + r] <-- st; }}
        else {{ out <-- st; }}
    }}
"""


def emit_poseidon() -> str:
    C, S, M, Pm = _load_poseidon_consts()
    parts = [
        "pragma circom 2.1.0;",
        "pragma custom_templates;",
        "",
        "// Poseidon-GL permutation (t=12, 8 full + 22 partial rounds,",
        "// x^7 S-box) as a custom gate exposing the intermediate states",
        "// the C12 compressor rows verify.  Constants are the framework's",
        "// own tables (hash/poseidon_gl_constants.npz).",
        "",
        _fn_table("CNST", C),
        _fn_table("SVEC", S),
        _fn_matrix("MMAT", M),
        _fn_matrix("PMAT", Pm),
    ]
    plain_init = "    st = in;\n"
    parts.append(
        "template custom Poseidon12() {\n"
        "    signal input in[12];\n"
        "    signal output im[9][12];\n"
        "    signal output out[12];\n"
        + _poseidon_body(plain_init)
        + "}\n"
    )
    key_init = """    assert(key*(key - 1) == 0);
    for (var k = 0; k < 4; k++) {
        st[k]     = key*(in[k] - in[k + 4]) + in[k + 4];
        st[k + 4] = key*(in[k + 4] - in[k]) + in[k];
        st[k + 8] = 0;
    }
"""
    parts.append(
        "// Key-ordered variant: the 4-element halves are swapped by the\n"
        "// key bit inside the gate (Merkle path left/right ordering).\n"
        "template custom CustPoseidon12() {\n"
        "    signal input in[8];\n"
        "    signal input key;\n"
        "    signal output im[9][12];\n"
        "    signal output out[12];\n"
        + _poseidon_body(key_init)
        + "}\n"
    )
    parts.append(
        """// Sponge wrappers: 8-element rate + 4-element capacity, truncated out.
template Poseidon(nOuts) {
    signal input in[8];
    signal input capacity[4];
    signal output out[nOuts];

    component p = Poseidon12();
    for (var k = 0; k < 8; k++) { p.in[k] <== in[k]; }
    for (var k = 0; k < 4; k++) { p.in[8 + k] <== capacity[k]; }
    for (var k = 0; k < nOuts; k++) { out[k] <== p.out[k]; }
    for (var k = nOuts; k < 12; k++) { _ <== p.out[k]; }
    _ <== p.im;
}

template CustPoseidon(nOuts) {
    signal input in[8];
    signal input key;
    signal output out[nOuts];

    component p = CustPoseidon12();
    for (var k = 0; k < 8; k++) { p.in[k] <== in[k]; }
    p.key <== key;
    for (var k = 0; k < nOuts; k++) { out[k] <== p.out[k]; }
    for (var k = nOuts; k < 12; k++) { _ <== p.out[k]; }
    _ <== p.im;
}
"""
    )
    return "\n".join(parts)


# ---------------------------------------------------------------------------
# extension-field gadgets


def emit_cmul() -> str:
    return """pragma circom 2.1.0;
pragma custom_templates;

// Cubic-extension product over F_p[x]/(x^3 - x - 1), Karatsuba form —
// the same folding as field/f3.py (f3g.js:94-102 semantics).
template custom CMul() {
    signal input ina[3];
    signal input inb[3];
    signal output out[3];

    var m01 = (ina[0] + ina[1]) * (inb[0] + inb[1]);
    var m02 = (ina[0] + ina[2]) * (inb[0] + inb[2]);
    var m12 = (ina[1] + ina[2]) * (inb[1] + inb[2]);
    var p0 = ina[0] * inb[0];
    var p1 = ina[1] * inb[1];
    var p2 = ina[2] * inb[2];
    var d01 = p0 - p1;

    out[0] <-- m12 + d01 - p2;
    out[1] <-- m01 + m12 - p1 - p1 - p0;
    out[2] <-- m02 - d01;
}
"""


def emit_cinv() -> str:
    return """pragma circom 2.1.0;
pragma custom_templates;

include "cmul.circom";

// Cubic-extension inverse: the closed-form coefficients are computed as a
// witness hint (field/f3.py inv formulas) and certified by one CMul
// against [1, 0, 0].
template CInv() {
    signal input in[3];
    signal output out[3];

    var aa = in[0] * in[0];
    var ac = in[0] * in[2];
    var ab = in[0] * in[1];
    var bb = in[1] * in[1];
    var bc = in[1] * in[2];
    var cc = in[2] * in[2];

    var den = 3*ab*in[2] + ab*in[1] + bc*in[2]
            - aa*in[0] - 2*aa*in[2] - ac*in[2] - bb*in[1] - cc*in[2];
    var deninv = 1 / den;

    out[0] <-- (bc + bb - aa - 2*ac - cc) * deninv;
    out[1] <-- (ab - cc) * deninv;
    out[2] <-- (ac - bb + cc) * deninv;

    signal one[3] <== CMul()(in, out);
    one === [1, 0, 0];
}
"""


def emit_evalpol() -> str:
    return """pragma circom 2.1.0;
pragma custom_templates;

// Horner evaluation of extension-coefficient polynomials, 4 coefficients
// per custom gate (polutils.js evalPol semantics).

function cmuladd(a, b, c) {
    var m01 = (a[0] + a[1]) * (b[0] + b[1]);
    var m02 = (a[0] + a[2]) * (b[0] + b[2]);
    var m12 = (a[1] + a[2]) * (b[1] + b[2]);
    var p0 = a[0] * b[0];
    var p1 = a[1] * b[1];
    var p2 = a[2] * b[2];
    var d01 = p0 - p1;
    var r[3];
    r[0] = m12 + d01 - p2 + c[0];
    r[1] = m01 + m12 - p1 - p1 - p0 + c[1];
    r[2] = m02 - d01 + c[2];
    return r;
}

template custom EvPol4() {
    signal input coefs[5][3];
    signal input x[3];
    signal output out[3];

    var acc[3] = coefs[4];
    for (var k = 3; k >= 0; k--) {
        acc = cmuladd(acc, x, coefs[k]);
    }
    out <-- acc;
}

template EvalPol(n) {
    signal input pol[n][3];
    signal input x[3];
    signal output out[3];

    var nGates = (n + 3) \\ 4;
    component ev[nGates];

    for (var g = nGates - 1; g >= 0; g--) {
        ev[g] = EvPol4();
        for (var k = 0; k < 4; k++) {
            if (4*g + k < n) { ev[g].coefs[k] <== pol[4*g + k]; }
            else             { ev[g].coefs[k] <== [0, 0, 0]; }
        }
        if (g == nGates - 1) { ev[g].coefs[4] <== [0, 0, 0]; }
        else                 { ev[g].coefs[4] <== ev[g + 1].out; }
        ev[g].x <== x;
    }

    if (n == 0) { out <== [0, 0, 0]; }
    else        { out <== ev[0].out; }
}
"""


def emit_treeselector() -> str:
    return """pragma circom 2.1.0;
pragma custom_templates;

include "utils.circom";

// 4-way select by two key bits, as a custom gate.
template custom TreeSelector4() {
    signal input values[4][3];
    signal input keys[2];
    signal output out[3];

    assert(keys[0]*(keys[0] - 1) == 0);
    assert(keys[1]*(keys[1] - 1) == 0);

    var sel = keys[0] + 2*keys[1];
    var picked[3];
    for (var v = 0; v < 4; v++) {
        if (sel == v) { picked = values[v]; }
    }
    out <-- picked;
}

// Select values[key] for a 2^nLevels table: a tree of TreeSelector4
// gates two key bits at a time, with a quadratic mux for an odd level.
template TreeSelector(nLevels, eSize) {
    var n = 1 << nLevels;
    signal input values[n][eSize];
    signal input key[nLevels];
    signal output out[eSize];

    var nodes = 0;
    var width = n;
    for (var l = 0; l < nLevels \\ 2; l++) {
        width = width \\ 4;
        nodes += width;
    }
    component sel[nodes];

    var cur = n;      // width of the level being consumed
    var base = 0;     // first gate of the level being built
    var prev = 0;     // first gate of the previous level
    for (var l = 0; l < nLevels \\ 2; l++) {
        var cnt = cur \\ 4;
        for (var g = 0; g < cnt; g++) {
            sel[base + g] = TreeSelector4();
            for (var k = 0; k < 4; k++) {
                if (l == 0) { sel[base + g].values[k] <== values[4*g + k]; }
                else        { sel[base + g].values[k] <== sel[prev + 4*g + k].out; }
            }
            sel[base + g].keys <== [key[2*l], key[2*l + 1]];
        }
        prev = base;
        base = base + cnt;
        cur = cnt;
    }

    if (cur == 1) {
        if (nodes == 0) { out <== values[0]; }
        else            { out <== sel[prev].out; }
    } else {
        // one leftover bit: linear mux
        for (var k = 0; k < eSize; k++) {
            if (nodes == 0) {
                out[k] <== key[nLevels - 1]*(values[1][k] - values[0][k]) + values[0][k];
            } else {
                out[k] <== key[nLevels - 1]*(sel[prev + 1].out[k] - sel[prev].out[k]) + sel[prev].out[k];
            }
        }
    }
}
"""


def emit_bitify() -> str:
    return """pragma circom 2.1.0;

// Bit decomposition over Goldilocks.  Num2Bits_strict additionally
// rejects the p..2^64-1 alias range via a 32-digit base-4 comparison
// against p-1 (the CompConstant technique).
template Num2Bits(n) {
    signal input in;
    signal output out[n];

    var acc = 0;
    var pw = 1;
    for (var i = 0; i < n; i++) {
        out[i] <-- (in >> i) & 1;
        out[i] * (out[i] - 1) === 0;
        acc += out[i] * pw;
        pw = pw + pw;
    }
    acc === in;
}

// out = 1 iff the 64-bit input (as bits) is strictly greater than ct.
template CompConstant(ct) {
    signal input in[64];
    signal output out;

    signal parts[32];
    signal sum[32];

    var e = 1;
    for (var i = 0; i < 32; i++) {
        var lo = (ct >> (2*i)) & 1;
        var hi = (ct >> (2*i + 1)) & 1;
        var a = in[2*i];
        var b = in[2*i + 1];

        if (hi == 0 && lo == 0)      { parts[i] <== e*b + e*a - e*a*b; }
        else if (hi == 0 && lo == 1) { parts[i] <== e*a + 2*e*b - e*a*b - e; }
        else if (hi == 1 && lo == 0) { parts[i] <== e*a*b + e*b - e; }
        else                         { parts[i] <== e*a*b - e; }

        if (i == 0) { sum[i] <== (1 << 32) - 1 + parts[i]; }
        else        { sum[i] <== sum[i - 1] + parts[i]; }
        e = e + e;
    }

    signal bits[33] <== Num2Bits(33)(sum[31]);
    for (var i = 0; i < 32; i++) { _ <== bits[i]; }
    out <== bits[32];
}

template AliasCheck() {
    signal input in[64];
    signal gt <== CompConstant(-1)(in);
    gt === 0;
}

template Num2Bits_strict() {
    signal input in;
    signal output out[64];

    signal bits[64] <== Num2Bits(64)(in);
    AliasCheck()(bits);
    out <== bits;
}
"""


def emit_merklehash() -> str:
    return """pragma circom 2.1.0;
pragma custom_templates;

include "linearhash.circom";
include "merkle.circom";
include "utils.circom";

// Leaf linear hash + root walk (merklehash_p.js:142-222 semantics).
template MerkleHash(eSize, elementsInLinear, nLinears) {
    var nBits = log2(nLinears);
    assert(1 << nBits == nLinears);
    signal input values[elementsInLinear][eSize];
    signal input siblings[nBits][4];
    signal input key[nBits];
    signal output root[4];

    signal leaf[4] <== LinearHash(elementsInLinear, eSize)(values);
    root <== Merkle(nBits)(leaf, siblings, key);
}

template parallel VerifyMerkleHash(eSize, elementsInLinear, nLinears) {
    var nBits = log2(nLinears);
    signal input values[elementsInLinear][eSize];
    signal input siblings[nBits][4];
    signal input key[nBits];
    signal input root[4];
    signal input enable;

    signal computed[4] <== MerkleHash(eSize, elementsInLinear, nLinears)(values, siblings, key);
    for (var k = 0; k < 4; k++) {
        enable * (computed[k] - root[k]) === 0;
    }
}
"""


def emit_merkle() -> str:
    return """pragma circom 2.1.0;
pragma custom_templates;

include "poseidon.circom";

// Walk a sibling path to the root; the key bit orders each pair inside
// the CustPoseidon gate.
template Merkle(nLevels) {
    signal input value[4];
    signal input siblings[nLevels][4];
    signal input key[nLevels];
    signal output root[4];

    component h[nLevels];
    for (var l = 0; l < nLevels; l++) {
        h[l] = CustPoseidon(4);
        for (var k = 0; k < 4; k++) {
            h[l].in[k] <== siblings[l][k];
            if (l == 0) { h[l].in[4 + k] <== value[k]; }
            else        { h[l].in[4 + k] <== h[l - 1].out[k]; }
        }
        h[l].key <== key[l];
    }
    root <== h[nLevels - 1].out;
}
"""


def emit_linearhash() -> str:
    return """pragma circom 2.1.0;
pragma custom_templates;

include "poseidon.circom";

// Sponge over a row of nInputs eSize-wide values: absorb 8 base elements
// per Poseidon call with 4-element digest chaining; rows of at most 4
// base elements are copied verbatim (linearhash.js:8-42 semantics).
template LinearHash(nInputs, eSize) {
    signal input in[nInputs][eSize];
    signal output out[4];

    var width = nInputs * eSize;
    var nChunks = 0;
    if (width > 4) { nChunks = (width - 1) \\ 8 + 1; }

    component h[nChunks];

    if (width <= 4) {
        var ii = 0;
        var ee = 0;
        for (var k = 0; k < 4; k++) {
            if (k < width) {
                out[k] <== in[ii][ee];
                ee += 1;
                if (ee == eSize) { ee = 0; ii += 1; }
            }
        }
    } else {
        var ii = 0;
        var ee = 0;
        for (var c = 0; c < nChunks; c++) {
            h[c] = Poseidon(4);
            for (var k = 0; k < 8; k++) {
                if (ii < nInputs) {
                    h[c].in[k] <== in[ii][ee];
                    ee += 1;
                    if (ee == eSize) { ee = 0; ii += 1; }
                } else {
                    h[c].in[k] <== 0;
                }
            }
            for (var k = 0; k < 4; k++) {
                if (c == 0) { h[c].capacity[k] <== 0; }
                else        { h[c].capacity[k] <== h[c - 1].out[k]; }
            }
        }
        out <== h[nChunks - 1].out;
    }
}
"""


def emit_linearhash_gpu() -> str:
    return """pragma circom 2.1.0;
pragma custom_templates;

include "poseidon.circom";

// Plain chained sponge over nInputs base elements (the inner hash of the
// split layout; linearhash_gpu.circom BasicLinearHash semantics).
template BasicLinearHash(nInputs) {
    signal input in[nInputs];
    signal output out[4];

    var nHashes = 0;
    if (nInputs > 4) { nHashes = (nInputs - 1) \\ 8 + 1; }

    component h[nHashes];

    if (nInputs <= 4) {
        for (var k = 0; k < 4; k++) {
            if (k < nInputs) { out[k] <== in[k]; }
            else             { out[k] <== 0; }
        }
    } else {
        for (var c = 0; c < nHashes; c++) {
            h[c] = Poseidon(4);
            for (var k = 0; k < 8; k++) {
                if (c*8 + k < nInputs) { h[c].in[k] <== in[c*8 + k]; }
                else                   { h[c].in[k] <== 0; }
            }
            for (var k = 0; k < 4; k++) {
                if (c == 0) { h[c].capacity[k] <== 0; }
                else        { h[c].capacity[k] <== h[c - 1].out[k]; }
            }
        }
        out <== h[nHashes - 1].out;
    }
}

// Two-level split linear hash (linearhash_gpu.js:31-68 / the reference's
// linearhash_gpu.circom LinearHash): split the flattened row into
// batchSize = max(8, ceil(totalIn/4)) chunks, BasicLinearHash each, then
// BasicLinearHash the concatenated 4-element digests.
template LinearHash(nInputs, eSize) {
    signal input in[nInputs][eSize];
    signal output out[4];

    var totalIn = nInputs * eSize;
    var batchSize = (totalIn + 3) \\ 4;
    if (batchSize < 8) { batchSize = 8; }
    var nHashes = (totalIn + batchSize - 1) \\ batchSize;

    component hash[nHashes];

    var curInput = 0;
    var curC = 0;
    for (var i = 0; i < nHashes; i++) {
        var size = batchSize;
        if (i == nHashes - 1) { size = totalIn - i*batchSize; }
        hash[i] = BasicLinearHash(size);
        for (var k = 0; k < size; k++) {
            hash[i].in[k] <== in[curInput][curC];
            curC += 1;
            if (curC == eSize) { curC = 0; curInput += 1; }
        }
    }

    component hashFinal;
    if (nHashes == 0) {
        for (var k = 0; k < 4; k++) { out[k] <== 0; }
    } else if (nHashes == 1) {
        for (var k = 0; k < 4; k++) { out[k] <== hash[0].out[k]; }
    } else {
        hashFinal = BasicLinearHash(nHashes*4);
        for (var i = 0; i < nHashes; i++) {
            for (var k = 0; k < 4; k++) {
                hashFinal.in[i*4 + k] <== hash[i].out[k];
            }
        }
        for (var k = 0; k < 4; k++) { out[k] <== hashFinal.out[k]; }
    }
}
"""


def emit_merklehash_gpu() -> str:
    """Same MerkleHash/VerifyMerkleHash interface as merklehash.circom but
    with the split ("GPU") leaf layout — a verifier circuit includes exactly
    one of the two files (stark_verifier.circom.ejs:11-15 include switch)."""
    return """pragma circom 2.1.0;
pragma custom_templates;

include "linearhash_gpu.circom";
include "merkle.circom";
include "utils.circom";

template MerkleHash(eSize, elementsInLinear, nLinears) {
    var nBits = log2(nLinears);
    assert(1 << nBits == nLinears);
    signal input values[elementsInLinear][eSize];
    signal input siblings[nBits][4];
    signal input key[nBits];
    signal output root[4];

    signal leaf[4] <== LinearHash(elementsInLinear, eSize)(values);
    root <== Merkle(nBits)(leaf, siblings, key);
}

template parallel VerifyMerkleHash(eSize, elementsInLinear, nLinears) {
    var nBits = log2(nLinears);
    signal input values[elementsInLinear][eSize];
    signal input siblings[nBits][4];
    signal input key[nBits];
    signal input root[4];
    signal input enable;

    signal computed[4] <== MerkleHash(eSize, elementsInLinear, nLinears)(values, siblings, key);
    for (var k = 0; k < 4; k++) {
        enable * (computed[k] - root[k]) === 0;
    }
}
"""


def emit_fft() -> str:
    """FFT over extension values with base-field compile-time twiddles.
    Radix-4/radix-2 FFT4 custom-gate network, bit-reverse in, with the
    final index-reversal for the inverse transform (fft.js:165-174)."""
    return """pragma circom 2.1.0;
pragma custom_templates;

include "utils.circom";

function bitrev(v, nBits) {
    var r = 0;
    for (var i = 0; i < nBits; i++) {
        r = 2*r + (v & 1);
        v = v >> 1;
    }
    return r;
}

// Radix-4 (type 4) or radix-2-pair (type 2) butterfly with twiddles baked
// into the gate constants.
template custom FFT4(type, scale, firstW, incW) {
    signal input in[4][3];
    signal output out[4][3];

    var w2 = firstW * firstW;
    var c0 = 0; var c1 = 0; var c2 = 0; var c3 = 0; var c4 = 0; var c5 = 0;
    var c6 = 0; var c7 = 0; var c8 = 0;
    if (type == 4) {
        c0 = scale;
        c1 = scale * w2;
        c2 = scale * firstW;
        c3 = scale * firstW * w2;
        c4 = scale * firstW * incW;
        c5 = scale * firstW * w2 * incW;
    } else {
        assert(type == 2);
        c6 = scale;
        c7 = scale * firstW;
        c8 = scale * firstW * incW;
    }

    for (var e = 0; e < 3; e++) {
        out[0][e] <-- c0*in[0][e] + c1*in[1][e] + c2*in[2][e] + c3*in[3][e] + c6*in[0][e] + c7*in[1][e];
        out[1][e] <-- c0*in[0][e] - c1*in[1][e] + c4*in[2][e] - c5*in[3][e] + c6*in[0][e] - c7*in[1][e];
        out[2][e] <-- c0*in[0][e] + c1*in[1][e] - c2*in[2][e] - c3*in[3][e] + c6*in[2][e] + c8*in[3][e];
        out[3][e] <-- c0*in[0][e] - c1*in[1][e] - c4*in[2][e] + c5*in[3][e] + c6*in[2][e] - c8*in[3][e];
    }
}

template FFTNet(nBits, eSize, inv) {
    var n = 1 << nBits;
    signal input in[n][eSize];
    signal output out[n][eSize];

    var nSteps4 = nBits \\ 2;
    var nSteps2 = nBits - 2*nSteps4;
    var rowGates = n \\ 4;

    // bit-reverse load (copy, zero-padding the missing components)
    signal br[n][3];
    for (var i = 0; i < n; i++) {
        var ri = bitrev(i, nBits);
        for (var e = 0; e < 3; e++) {
            if (e < eSize) { br[i][e] <== in[ri][e]; }
            else           { br[i][e] <== 0; }
        }
    }

    component g4[nSteps4][rowGates];
    component g2[nSteps2][rowGates];

    var scalar = inv ? 1/n : 1;
    var pm = 0;

    for (var s = 0; s < nSteps4; s++) {
        if (s > 0) { pm += 2; }
        for (var g = 0; g < rowGates; g++) {
            var w = 1;
            if (s > 0) {
                var width = 1 << (2*s);
                var height = n \\ width;
                var col = (4*g) \\ height;
                var row = (4*g) % height;
                w = roots(2*s + 2) ** (row*width + col);
            }
            g4[s][g] = FFT4(4, scalar, w, roots(2));
        }
        for (var g = 0; g < rowGates; g++) {
            for (var k = 0; k < 4; k++) {
                if (s == 0) {
                    g4[s][g].in[k] <== br[4*g + k];
                } else {
                    var flat = k*rowGates + g;
                    g4[s][flat \\ 4].in[flat % 4] <== g4[s - 1][g].out[k];
                }
            }
        }
        scalar = 1;
    }

    if (nSteps2 == 1) {
        pm += 2;
        var w = 1;
        for (var g = 0; g < rowGates; g++) {
            g2[0][g] = FFT4(2, scalar, w, roots(nBits));
            w = w * roots(nBits - 1);
        }
        for (var g = 0; g < rowGates; g++) {
            for (var k = 0; k < 4; k++) {
                if (nSteps4 == 0) {
                    g2[0][g].in[k] <== br[4*g + k];
                } else {
                    var flat = k*rowGates + g;
                    g2[0][flat \\ 4].in[flat % 4] <== g4[nSteps4 - 1][g].out[k];
                }
            }
        }
    }

    // final interleave permutation + inverse index reversal
    var wBits = (2*nBits - pm) % nBits;
    var pw = 1 << wBits;
    var ph = 1 << (nBits - wBits);
    for (var x = 0; x < pw; x++) {
        for (var y = 0; y < ph; y++) {
            var src = y*pw + x;
            var mid = x*ph + y;
            var dst = inv ? (n - mid) % n : mid;
            for (var e = 0; e < eSize; e++) {
                if (nSteps2 == 1) { out[dst][e] <== g2[0][src \\ 4].out[src % 4][e]; }
                else              { out[dst][e] <== g4[nSteps4 - 1][src \\ 4].out[src % 4][e]; }
            }
        }
    }
}

template FFT(nBits, eSize, inv) {
    var n = 1 << nBits;
    signal input in[n][eSize];
    signal output out[n][eSize];

    component one;
    component net;
    if (nBits == 0) {
        out <== in;
    } else if (nBits == 1) {
        one = FFT4(2, inv ? 1/2 : 1, 1, 1);
        one.in[0] <== in[0];
        one.in[1] <== in[1];
        one.in[2] <== [0, 0, 0];
        one.in[3] <== [0, 0, 0];
        for (var e = 0; e < eSize; e++) {
            out[0][e] <== one.out[0][e];
            out[1][e] <== one.out[1][e];
        }
    } else {
        net = FFTNet(nBits, eSize, inv);
        net.in <== in;
        net.out ==> out;
    }
}
"""


GADGET_FILES = {
    "utils.circom": emit_glutils,
    "poseidon.circom": emit_poseidon,
    "cmul.circom": emit_cmul,
    "cinv.circom": emit_cinv,
    "evalpol.circom": emit_evalpol,
    "treeselector4.circom": emit_treeselector,
    "bitify.circom": emit_bitify,
    "merklehash.circom": emit_merklehash,
    "merklehash_gpu.circom": emit_merklehash_gpu,
    "merkle.circom": emit_merkle,
    "linearhash.circom": emit_linearhash,
    "linearhash_gpu.circom": emit_linearhash_gpu,
    "fft.circom": emit_fft,
}


def emit_gadget_files() -> dict:
    return {name: fn() for name, fn in GADGET_FILES.items()}
