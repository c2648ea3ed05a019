"""Generators for the BN128 (BN254-Fr) verifier-circuit gadget library.

The recursion-to-SNARK tier verifies a GL STARK *inside the BN254 scalar
field*: every Goldilocks value rides an Fr signal, kept unnormalized with a
statically-tracked maximum (the emitter threads max bounds through template
PARAMETERS — the reference encodes the same bookkeeping in circom 2.1 signal
tags, circuits.bn128/gl.circom:8-120; parameters keep our front-end's
language subset small).  Semantics per template:

- ``GLNorm(maxIn)``      a % p via quotient hint + range checks.
- ``GLCMulAdd(mA,mB,mC)`` cubic-ext (a·b + c) % p, Karatsuba with
                          x³ = x + 1 folding (gl.circom GLCMulAdd), each
                          component reduced by a hinted quotient.
- ``GLCInv()/GLInv()``    hinted inverse + product check (gl.circom:195-278).
- ``PoseidonBN(nIns)``    circomlibjs Poseidon over Fr (x⁵ box, 8 full
                          rounds, per-t partials), constants from
                          hash/poseidon_bn128_constants.json — the same
                          tables as the host hash.poseidon_bn128.
- ``LinearHashBN(w)``     GL row → 3-per-Fr packing → arity-16 sponge
                          (hash/merkle_bn128.linear_hash_bn128 semantics).
- ``VerifyMerkleHashBN``  arity-16 path check (merklehash_bn128_p.js).
- ``Bn1toGL3()``          strict 254-bit split of a transcript squeeze into
                          three 64-bit GL limbs (bn1togl3.circom).

Reference behavior: circuits.bn128/*.circom (semantics only; every body is
generated here, constants from our own tables).
"""
from __future__ import annotations

from ..field import gl64
from ..hash import poseidon_bn128

GL_P = gl64.P_INT
FR = poseidon_bn128.P


def _bits_of(k: int) -> int:
    return max(1, (k).bit_length())


def gen_bit_utils() -> str:
    """Num2Bits + binary less-than-constant comparator (for the strict
    254-bit decomposition; a plain Num2Bits(254) alone would admit the
    value + Fr alias)."""
    return """// bit utilities (Fr field)
template Num2BitsBN(n) {
    signal input in;
    signal output out[n];
    var acc = 0;
    for (var i = 0; i < n; i++) {
        out[i] <-- (in >> i) & 1;
        out[i] * (out[i] - 1) === 0;
        acc += out[i] * (1 << i);
    }
    acc === in;
}

%STRICT%

// transcript squeeze -> three 64-bit GL limbs (low 192 of 254 bits)
template Bn1toGL3() {
    signal input in;
    signal output out[3];
    signal bits[254] <== Num2BitsStrictBN()(in);
    var l0 = 0; var l1 = 0; var l2 = 0;
    for (var i = 0; i < 64; i++) {
        l0 += bits[i] * (1 << i);
        l1 += bits[64 + i] * (1 << i);
        l2 += bits[128 + i] * (1 << i);
    }
    out[0] <== l0;
    out[1] <== l1;
    out[2] <== l2;
    for (var i = 192; i < 254; i++) { _ <== bits[i]; }
}
""".replace("%STRICT%", _gen_strict_bits())


def _gen_strict_bits() -> str:
    """Num2BitsStrictBN: 254-bit decomposition with value ≤ Fr−1 enforced by
    an unrolled msb-first lt/eq comparator.  The Fr−1 bit pattern is baked
    per bit at emission time — a template parameter K=Fr would reduce to 0
    in the circuit's own field."""
    k = FR - 1
    lines = [
        "// strict Fr -> bits: value < Fr enforced (unrolled comparator)",
        "template Num2BitsStrictBN() {",
        "    signal input in;",
        "    signal output out[254];",
        "    out <== Num2BitsBN(254)(in);",
        "    signal lt[255];",
        "    signal eq[255];",
        "    lt[0] <== 0;",
        "    eq[0] <== 1;",
    ]
    for i in range(254):
        bit = (k >> (253 - i)) & 1
        b = f"out[{253 - i}]"
        if bit == 1:
            lines.append(f"    lt[{i + 1}] <== lt[{i}] + eq[{i}] * (1 - {b});")
            lines.append(f"    eq[{i + 1}] <== eq[{i}] * {b};")
        else:
            lines.append(f"    lt[{i + 1}] <== lt[{i}];")
            lines.append(f"    eq[{i + 1}] <== eq[{i}] * (1 - {b});")
    lines.append("    lt[254] + eq[254] === 1;  // value <= Fr - 1")
    lines.append("}")
    return "\n".join(lines)


def gen_gl_lib() -> str:
    """GL arithmetic over Fr signals.  max bounds ride template params."""
    p = GL_P
    return f"""// Goldilocks arithmetic in Fr (unnormalized values, static max bounds)

// value < 2^64 (the canonical working range after every reduction)
template LessThan64() {{
    signal input in;
    signal output out;
    _ <== Num2BitsBN(64)(in);
    out <== in;
}}

// value < GL p (for canonical equality / transcript absorption)
template LessThanGL() {{
    signal input in;
    signal output out;
    signal bits[64] <== Num2BitsBN(64)(in);
    var hi = 0; var lo = 0;
    for (var i = 0; i < 32; i++) {{
        lo += bits[i] * (1 << i);
        hi += bits[32 + i] * (1 << i);
    }}
    // in >= p iff hi == 2^32-1 and lo != 0
    signal hiAllOne <== IsEqualConstBN(4294967295)(hi);
    signal loIsZero <== IsZeroBN()(lo);
    hiAllOne * (1 - loIsZero) === 0;
    out <== in;
}}

function izinv(a) {{
    if (a == 0) {{ return 0; }}
    return 1 / a;
}}

template IsZeroBN() {{
    signal input in;
    signal output out;
    signal inv <-- izinv(in);
    out <== 1 - in * inv;
    in * out === 0;
}}

template IsEqualConstBN(K) {{
    signal input in;
    signal output out;
    out <== IsZeroBN()(in - K);
}}

// a % p, a < maxIn (quotient hint + range checks; gl.circom GLNorm)
template GLNorm(maxIn) {{
    signal input in;
    signal output out;
    var p = {p};
    signal k <-- in \\ p;
    signal rem <== in - k * p;
    var qbits = nbits((maxIn - 1) \\ p + 1);
    _ <== Num2BitsBN(qbits)(k);
    out <== LessThanGL()(rem);
}}

template GLCNorm(maxIn) {{
    signal input in[3];
    signal output out[3];
    for (var i = 0; i < 3; i++) {{ out[i] <== GLNorm(maxIn)(in[i]); }}
}}

// base-field (a·b) % p with a < maxA, b < maxB
template GLMul(maxA, maxB) {{
    signal input ina;
    signal input inb;
    signal output out;
    var p = {p};
    signal m <== ina * inb;
    signal k <-- m \\ p;
    signal rem <== m - k * p;
    var qbits = nbits((maxA * maxB - 1) \\ p + 1);
    _ <== Num2BitsBN(qbits)(k);
    out <== LessThan64()(rem);
}}

// cubic-extension (a·b + c) % p componentwise; x^3 = x + 1 folding
template GLCMulAdd(maxA, maxB, maxC) {{
    signal input ina[3];
    signal input inb[3];
    signal input inc[3];
    signal output out[3];
    var p = {p};

    signal A <== (ina[0] + ina[1]) * (inb[0] + inb[1]);
    signal B <== (ina[0] + ina[2]) * (inb[0] + inb[2]);
    signal C <== (ina[1] + ina[2]) * (inb[1] + inb[2]);
    signal D <== ina[0] * inb[0];
    signal E <== ina[1] * inb[1];
    signal F <== ina[2] * inb[2];

    signal m[3];
    m[0] <== C + D - E - F + inc[0];         // a1b2 + a2b1 + a0b0 + c0
    m[1] <== A + C - E - E - D + inc[1];     // a0b1+a1b0+a1b2+a2b1+a2b2 + c1
    m[2] <== B - D + E + inc[2];             // a0b2+a2b0+a2b2+a1b1 + c2

    var qbits = nbits((5 * maxA * maxB + maxC) \\ p + 1);
    signal k[3];
    signal rem[3];
    for (var i = 0; i < 3; i++) {{
        k[i] <-- m[i] \\ p;
        rem[i] <== m[i] - k[i] * p;
        _ <== Num2BitsBN(qbits)(k[i]);
        out[i] <== LessThan64()(rem[i]);
    }}
}}

template GLCMul(maxA, maxB) {{
    signal input ina[3];
    signal input inb[3];
    signal output out[3];
    signal zero[3] <== [0, 0, 0];
    out <== GLCMulAdd(maxA, maxB, 1)(ina, inb, zero);
}}

// hinted base inverse (gl.circom GLInv): in may be unnormalized (< maxIn)
template GLInv(maxIn) {{
    signal input in;
    signal output out;
    var p = {p};
    signal inv <-- glinv1(in % p);
    out <== LessThan64()(inv);
    signal check <== GLMul(maxIn, 18446744073709551616)(in, out);
    signal checkN <== GLNorm(18446744073709551616)(check);
    checkN === 1;
}}

// hinted cubic-extension inverse (gl.circom GLCInv)
template GLCInv(maxIn) {{
    signal input in[3];
    signal output out[3];
    var p = {p};
    var a0 = in[0] % p; var a1 = in[1] % p; var a2 = in[2] % p;
    var aa = (a0 * a0) % p;  var ac = (a0 * a2) % p;
    var ba = (a1 * a0) % p;  var bb = (a1 * a1) % p;
    var bc = (a1 * a2) % p;  var cc = (a2 * a2) % p;
    var aaa = (aa * a0) % p; var aac = (aa * a2) % p;
    var abc = (ba * a2) % p; var abb = (ba * a1) % p;
    var acc = (ac * a2) % p; var bbb = (bb * a1) % p;
    var bcc = (bc * a2) % p; var ccc = (cc * a2) % p;
    var t = (3*abc + abb + bcc + 9*p - aaa - 2*aac - acc - bbb - ccc) % p;
    var tinv = glinv1(t);
    var i1 = ((bc + bb + 4*p - aa - 2*ac - cc) % p) * tinv % p;
    var i2 = ((ba + p - cc) % p) * tinv % p;
    var i3 = ((ac + cc + p - bb) % p) * tinv % p;
    signal inv[3];
    inv[0] <-- i1;
    inv[1] <-- i2;
    inv[2] <-- i3;
    out[0] <== LessThan64()(inv[0]);
    out[1] <== LessThan64()(inv[1]);
    out[2] <== LessThan64()(inv[2]);
    signal check[3] <== GLCMul(maxIn, 18446744073709551616)(in, out);
    signal checkN[3] <== GLCNorm(92233720368547758080)(check);
    checkN[0] === 1;
    checkN[1] === 0;
    checkN[2] === 0;
}}

// extended-euclid inverse hint (compile-time / witness-time function)
function glinv1(a) {{
    assert(a != 0);
    var p = {p};
    var t = 0; var r = p; var newt = 1; var newr = a % p;
    while (newr != 0) {{
        var q = r \\ newr;
        var aux1 = newt; var aux2 = t - q * newt;
        t = aux1; newt = aux2;
        aux1 = newr; aux2 = r - q * newr;
        r = aux1; newr = aux2;
    }}
    if (t < 0) {{ t = t + p; }}
    return t;
}}

function nbits(a) {{
    var n = 1;
    var r = 0;
    while (n - 1 < a) {{
        r++;
        n *= 2;
    }}
    return r;
}}
"""


def gen_poseidon_bn(t_values) -> str:
    """Unrolled circomlibjs Poseidon templates for each needed width."""
    parts = ["// Poseidon over Fr (circomlibjs constants; full state out)"]
    for t in sorted(set(t_values)):
        c, m, rp = poseidon_bn128._constants(t)
        rf = poseidon_bn128.N_ROUNDS_F
        half = rf // 2
        lines = [f"template PoseidonBN{t}() {{"]
        lines.append(f"    signal input inputs[{t - 1}];")
        lines.append("    signal input initState;")
        lines.append(f"    signal output out[{t}];")
        lines.append(f"    var C[{len(c)}] = [{', '.join(str(x) for x in c)}];")
        flat_m = [str(m[i][j]) for i in range(t) for j in range(t)]
        lines.append(f"    var M[{t * t}] = [{', '.join(flat_m)}];")
        lines.append(f"    var st[{t}];")
        lines.append("    st[0] = initState;")
        lines.append(f"    for (var i = 1; i < {t}; i++) {{ st[i] = inputs[i-1]; }}")
        total = rf + rp
        # separate sbox banks: full rounds (t lanes) vs partial (lane 0 only)
        lines.append(f"    signal fs2[{rf}][{t}];")
        lines.append(f"    signal fs4[{rf}][{t}];")
        lines.append(f"    signal fs5[{rf}][{t}];")
        lines.append(f"    signal ps2[{rp}];")
        lines.append(f"    signal ps4[{rp}];")
        lines.append(f"    signal ps5[{rp}];")
        lines.append(f"    var tmp[{t}];")
        lines.append(f"    for (var r = 0; r < {total}; r++) {{")
        lines.append(f"        for (var i = 0; i < {t}; i++) {{ st[i] = st[i] + C[r * {t} + i]; }}")
        lines.append(f"        if (r < {half} || r >= {half + rp}) {{")
        lines.append(f"            var fr = r < {half} ? r : r - {rp};")
        lines.append(f"            for (var i = 0; i < {t}; i++) {{")
        lines.append("                fs2[fr][i] <== st[i] * st[i];")
        lines.append("                fs4[fr][i] <== fs2[fr][i] * fs2[fr][i];")
        lines.append("                fs5[fr][i] <== fs4[fr][i] * st[i];")
        lines.append("                st[i] = fs5[fr][i];")
        lines.append("            }")
        lines.append("        } else {")
        lines.append(f"            var pr = r - {half};")
        lines.append("            ps2[pr] <== st[0] * st[0];")
        lines.append("            ps4[pr] <== ps2[pr] * ps2[pr];")
        lines.append("            ps5[pr] <== ps4[pr] * st[0];")
        lines.append("            st[0] = ps5[pr];")
        lines.append("        }")
        lines.append(f"        for (var i = 0; i < {t}; i++) {{")
        lines.append("            tmp[i] = 0;")
        lines.append(f"            for (var j = 0; j < {t}; j++) {{ tmp[i] += M[i * {t} + j] * st[j]; }}")
        lines.append("        }")
        lines.append(f"        for (var i = 0; i < {t}; i++) {{ st[i] = tmp[i]; }}")
        lines.append("    }")
        lines.append(f"    for (var i = 0; i < {t}; i++) {{ out[i] <== st[i]; }}")
        lines.append("}")
        parts.append("\n".join(lines))
    return "\n\n".join(parts)


def gen_poseidon_custom_bn(t_values) -> str:
    """Custom-gate Poseidon templates for the merkleTreeCustom verifier
    variant (reference circuits.bn128/custom/poseidon.circom:1-60): a
    ``template custom PoseidonT(t)`` exposing every round's intermediate
    state (the final-tier plonkish machines lay those rows out as
    committed columns — final/plonksetup.py custom_gates_info matches the
    gate by the name "PoseidonT"), plus the ``CustomPoseidon`` sponge
    wrapper.  Constants are the ORIGINAL (non-optimized) Poseidon tables —
    the same permutation the optimized circomlibjs form computes, which is
    what hash/poseidon_bn128.py evaluates."""
    t_values = sorted(set(t_values))
    parts = ["// Poseidon over Fr as custom gates (original constants)"]
    for t in t_values:
        c, m, rp = poseidon_bn128._constants(t)
        parts.append(
            f"function POSEIDON_C_ORIG_{t}() {{\n"
            f"    return [{', '.join(str(x) for x in c)}];\n}}"
        )
        flat_m = [str(m[i][j]) for i in range(t) for j in range(t)]
        parts.append(
            f"function POSEIDON_M_ORIG_{t}() {{\n"
            f"    return [{', '.join(flat_m)}];\n}}"
        )
    rf = poseidon_bn128.N_ROUNDS_F
    half = rf // 2
    rp_by_t = {t: poseidon_bn128._constants(t)[2] for t in t_values}
    rp_chain = " : ".join(
        [f"t == {t} ? {rp_by_t[t]}" for t in t_values] + ["0"]
    )
    c_sel = "\n".join(
        f"    if (t == {t}) {{ C = POSEIDON_C_ORIG_{t}(); M = POSEIDON_M_ORIG_{t}(); }}"
        for t in t_values
    )
    parts.append(f"""template custom PoseidonT(t) {{
    var nRoundsP = {rp_chain};
    var totalRounds = {rf} + nRoundsP;
    signal input in[t];
    signal output im[totalRounds - 1][t];
    signal output out[t];

    var C[t * totalRounds];
    var M[t * t];
{c_sel}

    var st[t] = in;
    var nst[t];
    for (var r = 0; r < totalRounds; r++) {{
        for (var j = 0; j < t; j++) {{
            st[j] = st[j] + C[t * r + j];
            st[j] = r < {half} || r >= nRoundsP + {half} || j == 0
                    ? st[j] ** 5
                    : st[j];
        }}
        for (var i = 0; i < t; i++) {{
            nst[i] = 0;
            for (var j = 0; j < t; j++) {{ nst[i] += M[i * t + j] * st[j]; }}
        }}
        st = nst;
        if (r < totalRounds - 1) {{
            im[r] <-- st;
        }} else {{
            out <-- st;
        }}
    }}
}}

template CustomPoseidon(nInputs) {{
    signal input in[nInputs];
    signal input initialState;
    signal output out[nInputs + 1];

    component p = PoseidonT(nInputs + 1);
    p.in[0] <== initialState;
    for (var i = 0; i < nInputs; i++) {{ p.in[i + 1] <== in[i]; }}
    _ <== p.im;
    out <== p.out;
}}""")
    return "\n\n".join(parts)


def gen_linear_hash_bn(width: int, arity: int = 16, custom: bool = False) -> str:
    """LinearHashBN{width}: GL row -> pack 3/Fr -> sponge (linearhash.bn128.js).
    Inputs are range-checked to 64 bits (the packing is a linear combination,
    unsound on unchecked values)."""
    n3 = -(-width // 3)
    name = f"LinearHashBN{width}"
    lines = [f"template {name}() {{"]
    lines.append(f"    signal input in[{width}];")
    lines.append("    signal output out;")
    lines.append(f"    for (var i = 0; i < {width}; i++) {{ _ <== Num2BitsBN(64)(in[i]); }}")
    lines.append(f"    signal packed[{n3}];")
    for i in range(n3):
        terms = []
        for j in range(3):
            k = 3 * i + j
            if k < width:
                terms.append(f"in[{k}] * {1 << (64 * j)}" if j else f"in[{k}]")
        lines.append(f"    packed[{i}] <== {' + '.join(terms)};")
    if n3 == 1:
        lines.append("    out <== packed[0];")
        lines.append("}")
        return "\n".join(lines)
    # sponge: chunks of `arity`, capacity = running state.  The custom
    # variant pads the last chunk to the full arity (linearhash.bn128.js:58
    # with this.custom) and rides the CustomPoseidon gate.
    chunks = [min(arity, n3 - s) for s in range(0, n3, arity)]
    pos = 0
    prev_state = "0"
    for ci, orig_size in enumerate(chunks):
        ins = [f"packed[{pos + k}]" for k in range(orig_size)]
        csize = orig_size
        if custom:
            ins += ["0"] * (arity - csize)
            csize = arity
        t = csize + 1
        tmpl = f"CustomPoseidon({csize})" if custom else f"PoseidonBN{t}()"
        lines.append(
            f"    signal h{ci}[{t}] <== {tmpl}([{', '.join(ins)}], {prev_state});"
        )
        lines.append(f"    for (var i = 1; i < {t}; i++) {{ _ <== h{ci}[i]; }}")
        prev_state = f"h{ci}[0]"
        pos += orig_size
    lines.append(f"    out <== {prev_state};")
    lines.append("}")
    return "\n".join(lines)


def gen_verify_merkle_bn(width: int, n_levels: int, arity: int = 16,
                         custom: bool = False) -> str:
    """VerifyMerkleHashBN{width}_{n_levels}: arity-16 path check.  The query
    key arrives as bits (4 per level); each level re-hashes the sibling
    group with our running digest substituted at the key position."""
    abits = (arity - 1).bit_length()
    name = f"VerifyMerkleBN{width}_{n_levels}"
    lines = [f"template {name}() {{"]
    lines.append(f"    signal input values[{width}];")
    lines.append(f"    signal input siblings[{n_levels}][{arity}];")
    lines.append(f"    signal input key[{n_levels * abits}];")
    lines.append("    signal input root;")
    lines.append("    signal input enable;")
    lines.append(f"    signal h0 <== LinearHashBN{width}()(values);")
    prev = "h0"
    for l in range(n_levels):
        kb = ", ".join(f"key[{l * abits + b}]" for b in range(abits))
        lines.append(f"    signal sel{l}[{arity}];")
        lines.append(f"    signal kbits{l}[{abits}] <== [{kb}];")
        # one-hot selector from the level's key bits
        lines.append(f"    signal oh{l}[{arity}] <== OneHot{abits}()(kbits{l});")
        lines.append(f"    signal grp{l}[{arity}];")
        lines.append(f"    for (var k = 0; k < {arity}; k++) {{")
        lines.append(f"        sel{l}[k] <== oh{l}[k] * ({prev} - siblings[{l}][k]);")
        lines.append(f"        grp{l}[k] <== siblings[{l}][k] + sel{l}[k];")
        lines.append("    }")
        node = (
            f"CustomPoseidon({arity})" if custom else f"PoseidonBN{arity + 1}()"
        )
        lines.append(
            f"    signal lvl{l}[{arity + 1}] <== {node}(grp{l}, 0);"
        )
        lines.append(
            f"    for (var i = 1; i < {arity + 1}; i++) {{ _ <== lvl{l}[i]; }}"
        )
        prev = f"lvl{l}[0]"
    lines.append(f"    enable * ({prev} - root) === 0;")
    lines.append("}")
    return "\n".join(lines)


def gen_one_hot(abits: int) -> str:
    """OneHot{abits}: key bits -> one-hot selector over 2^abits slots."""
    n = 1 << abits
    lines = [f"template OneHot{abits}() {{"]
    lines.append(f"    signal input bits[{abits}];")
    lines.append(f"    signal output out[{n}];")
    # product tree over the bits, expanded levels
    for lvl in range(1, abits + 1):
        cnt = 1 << lvl
        lines.append(f"    signal p{lvl}[{cnt}];")
        for i in range(cnt):
            b = f"bits[{lvl - 1}]"
            sel = b if (i >> (lvl - 1)) & 1 else f"(1 - {b})"
            if lvl == 1:
                lines.append(f"    p1[{i}] <== {sel};")
            else:
                lines.append(
                    f"    p{lvl}[{i}] <== p{lvl - 1}[{i & ((1 << (lvl - 1)) - 1)}] * {sel};"
                )
    for i in range(n):
        lines.append(f"    out[{i}] <== p{abits}[{i}];")
    lines.append("}")
    return "\n".join(lines)


def gen_roots_fns() -> str:
    """GL root/inverse-root lookup functions (same chain as ops/ntt)."""
    max_bits = 32
    roots = [gl64.w(b) if b <= 32 else 0 for b in range(max_bits + 1)]
    inv = [pow(int(r), GL_P - 2, GL_P) if r else 0 for r in roots]
    r = ", ".join(str(int(x)) for x in roots)
    i = ", ".join(str(int(x)) for x in inv)
    return f"""function glroots(i) {{
    var r[{max_bits + 1}] = [{r}];
    return r[i];
}}
function glinvroots(i) {{
    var r[{max_bits + 1}] = [{i}];
    return r[i];
}}
"""
