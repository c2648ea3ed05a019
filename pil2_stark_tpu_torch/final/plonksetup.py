"""Final-tier plonkish setups over BN254-Fr.

Counterpart of pil2-stark-js src/final/{final9_setup.js,
final6_setup.js, finalfflonk_setup.js, final9.pil.ejs, final6.pil.ejs,
finalfflonk.pil.ejs, final_helpers.js}: converts the R1CS of a BN128
verifier circuit into the last recursion hop's PIL machine, to be
proven by the pil-fflonk prover for on-chain verification.

Variants:
  cols=9   final9  — 3 plonk constraint-sets/row + custom gates
                     (PoseidonT rounds, Num2Bytes range check,
                     CustomGLCMulAdd), plonk recycling of the free
                     a[6..8] slots on custom rows (final9_setup.js:116).
  cols=6   final6  — 2 plonk sets/row + the same custom gates, no
                     recycling (final6_setup.js:23).
  cols=0   finalfflonk — plain plonk only, nCommitted=3k columns
                     (finalfflonk_setup.js:16-22).

The PIL text is *generated* (like compiler/compressor12.py), compiled by
compiler.pil1_parser, and is proven with pilinfo(stark=False) + fflonk.

Documented divergences from the reference templates:
  - final9.pil.ejs:28-36 pins every public to a[0](i) and declares
    duplicate Global.L names for nPublics > 9; the setup's sMap
    however lays publics out cols-per-row (final9_setup.js:104-112).
    We emit the sMap-consistent form a[i%cols](i//cols) with one
    lagrangian per public row (the two agree for the production case
    of a single public).
  - the RANGE_CHECK plookups are commented out in both reference
    templates (final9.pil.ejs:139-143); we reproduce that behavior
    (the 16-bit decomposition equality is enforced, byte-range
    membership is not) and keep the RANGE column for parity.
"""
from __future__ import annotations

import json
import os

import numpy as np

from ..compiler import pil1_parser, r1cs2plonk as r2p
from ..compiler.pil1_libs import get_ks
from ..hash.poseidon_bn128 import N_ROUNDS_F, N_ROUNDS_P

FR = 21888242871839275222246405745257275088548364400416034343698204186575808495617
GL_P = 0xFFFFFFFF00000001

_CONSTANTS = os.path.join(
    os.path.dirname(__file__), "..", "hash", "poseidon_bn128_constants.json"
)


def _poseidon_cm(t: int):
    """Original (non-optimized) BN128 Poseidon constants, the tables the
    reference bakes into src/final/poseidon_constants.js (C[t-1]/M[t-1])."""
    with open(_CONSTANTS) as f:
        data = json.load(f)
    entry = data[str(t)]
    return [int(v) for v in entry["C"]], [[int(v) for v in row] for row in entry["M"]]


# ---------------------------------------------------------------------------
# final_helpers.js


def custom_gates_info(r1cs):
    """final_helpers.js getCustomGatesInfo: classify custom gate templates."""
    res = {
        "PoseidonT": None,
        "RangeCheckNBits": {},
        "GLCMulAdd": None,
        "nPoseidonT": 0,
        "nGLCMulAdd": 0,
        "nRangeCheck": 0,
        "nPoseidonInputs": -1,
    }
    for i, g in enumerate(r1cs.custom_gates):
        name = g["template"]
        if name == "PoseidonT":
            assert res["nPoseidonInputs"] == -1
            res["PoseidonT"] = i
            params = g["parameters"]
            res["nPoseidonInputs"] = int(params[0] if isinstance(params, (list, tuple)) else params)
        elif name == "Num2Bytes":
            params = g["parameters"]
            res["RangeCheckNBits"][i] = int(params[0] if isinstance(params, (list, tuple)) else params)
        elif name == "CustomGLCMulAdd":
            res["GLCMulAdd"] = i
        else:
            raise ValueError(f"Invalid custom gate: {name}")
    for u in r1cs.custom_uses:
        if u["id"] == res["PoseidonT"]:
            res["nPoseidonT"] += 1
        elif u["id"] in res["RangeCheckNBits"]:
            res["nRangeCheck"] += 1
        elif u["id"] == res["GLCMulAdd"]:
            res["nGLCMulAdd"] += 1
        else:
            raise ValueError(f"Custom gate not defined: {u['id']}")
    return res


def calculate_plonk_rows(plonk_constraints, n_plonk, extra_rows=0):
    """final_helpers.js calculatePlonkConstraints: rows needed to pack the
    plonk constraints n_plonk same-key sets per row, after the first
    `extra_rows` constraints are absorbed by recycled custom-gate rows."""
    partial = {}
    r = 0
    for c in plonk_constraints:
        k = ",".join(format(int(v) % FR, "x") for v in c[3:8])
        if extra_rows > 0:
            extra_rows -= 1
            continue
        if k in partial:
            partial[k] += 1
            if partial[k] == n_plonk:
                del partial[k]
        else:
            partial[k] = 1
            r += 1
    return r


# ---------------------------------------------------------------------------
# PIL source generation (final9.pil.ejs / final6.pil.ejs /
# finalfflonk.pil.ejs semantics)


def _emit_publics(out, n_publics, n_cols):
    n_public_rows = (n_publics + n_cols - 1) // n_cols
    for i in range(n_public_rows):
        out.append(f"    pol constant L{i + 1};")
    return n_public_rows


def _emit_plonk_gate(out, base, gate="GATE"):
    a, b, c = base, base + 1, base + 2
    out.append(f"    pol a{a}{b} = a[{a}]*a[{b}];")
    out.append(
        f"    pol g{a}{b}{c} = C[0]*a{a}{b} + C[1]*a[{a}] + C[2]*a[{b}]"
        f" + C[3]*a[{c}] + C[4];"
    )
    out.append(f"    g{a}{b}{c}*{gate} = 0;")


def _emit_poseidon(out, t, M):
    for i in range(t):
        out.append(f"    pol p{i}_1 = a[{i}] + C[{i}];")
        out.append(f"    pol p{i}_2 = p{i}_1 * p{i}_1;")
        out.append(f"    pol p{i}_4 = p{i}_2 * p{i}_2;")
        out.append(f"    pol p{i}_5 = p{i}_4 * p{i}_1;")
    for i in range(t):
        full = " + ".join(f"{M[i][j]} * p{j}_5" for j in range(t))
        out.append(f"    POSEIDON_FULL_ROUND * (a[{i}]' - ({full})) = 0;")
    for i in range(t):
        terms = [f"{M[i][0]} * p0_5"]
        terms += [f"{M[i][j]} * p{j}_1" for j in range(1, t)]
        out.append(
            f"    POSEIDON_PARTIAL_ROUND * (a[{i}]' - ({' + '.join(terms)})) = 0;"
        )


def _emit_glcmuladd(out, cols):
    off = f"16*{GL_P}"
    for k, src in enumerate(["a[0]", "a[1]", "a[2]"]):
        out.append(f"    pol ga{k} = {src} + {off};")
    for k, src in enumerate(["a[3]", "a[4]", "a[5]"]):
        out.append(f"    pol gb{k} = {src} + {off};")
    for k, src in enumerate(["a[0]'", "a[1]'", "a[2]'"]):
        out.append(f"    pol gc{k} = {src} + {off};")
    out.append("    pol gA = (ga0 + ga1) * (gb0 + gb1);")
    out.append("    pol gB = (ga0 + ga2) * (gb0 + gb2);")
    out.append("    pol gC = (ga1 + ga2) * (gb1 + gb2);")
    out.append("    pol gD = ga0 * gb0;")
    out.append("    pol gE = ga1 * gb1;")
    out.append("    pol gF = ga2 * gb2;")
    out.append("    GLCMULADD * (a[3]' - (gC + gD - gE - gF + gc0)) = 0;")
    out.append("    GLCMULADD * (a[4]' - (gA + gC - 2*gE - gD + gc1)) = 0;")
    out.append("    GLCMULADD * (a[5]' - (gB - gD + gE + gc2)) = 0;")
    if cols == 9:
        out.append("    g678*GLCMULADD = 0;")


def _emit_rangecheck(out, cols):
    out.append(
        "    RANGE_CHECK * (a[0] - (a[1] + 65536*a[2] + 4294967296*a[3]"
        " + 281474976710656*a[4] + 18446744073709551616*a[5])) = 0;"
    )
    if cols == 9:
        out.append("    g678*RANGE_CHECK = 0;")


def _pil_source_final(n_bits, n_publics, cols, t, M):
    """final9.pil.ejs / final6.pil.ejs (with the divergences in the module
    docstring)."""
    out = [f"constant %N = 2**{n_bits};", "", "namespace Global(%N);"]
    n_public_rows = _emit_publics(out, n_publics, cols)
    out.append("")
    out.append("namespace Final(%N);")
    out.append(f"    pol constant S[{cols}];")
    out.append("    pol constant C[5];")
    for sel in [
        "POSEIDON_PARTIAL_ROUND", "POSEIDON_FULL_ROUND", "RANGE_CHECK",
        "RANGE", "GATE", "GLCMULADD",
    ]:
        out.append(f"    pol constant {sel};")
    out.append(f"    pol commit a[{cols}];")
    out.append("")
    for i in range(n_publics):
        out.append(f"    public pub{i} = a[{i % cols}]({i // cols});")
    for i in range(n_publics):
        out.append(
            f"    Global.L{i // cols + 1} * (a[{i % cols}] - :pub{i}) = 0;"
        )
    out.append("")
    n_plonk = 3 if cols == 9 else 2
    for k in range(n_plonk):
        _emit_plonk_gate(out, 3 * k)
    out.append("")
    if t is not None:
        _emit_poseidon(out, t, M)
        out.append("")
    _emit_glcmuladd(out, cols)
    out.append("")
    _emit_rangecheck(out, cols)
    out.append("")
    a_l = ", ".join(f"a[{i}]" for i in range(cols))
    s_l = ", ".join(f"S[{i}]" for i in range(cols))
    out.append(f"    {{ {a_l} }} connect {{ {s_l} }};")
    out.append("")
    return "\n".join(out)


def _pil_source_fflonk(n_bits, n_publics, n_committed):
    """finalfflonk.pil.ejs: plain plonk machine, nCommitted=3k columns."""
    out = [f"constant %N = 2**{n_bits};", "", "namespace Global(%N);"]
    _emit_publics(out, n_publics, n_committed)
    out.append("")
    out.append("namespace Final(%N);")
    out.append(f"    pol constant S[{n_committed}];")
    out.append("    pol constant C[5];")
    out.append("    pol constant GATE;")
    out.append(f"    pol commit a[{n_committed}];")
    out.append("")
    for i in range(n_publics):
        out.append(f"    public pub{i} = a[{i % n_committed}]({i // n_committed});")
    for i in range(n_publics):
        out.append(
            f"    Global.L{i // n_committed + 1} * (a[{i % n_committed}] - :pub{i}) = 0;"
        )
    out.append("")
    for k in range(n_committed // 3):
        _emit_plonk_gate(out, 3 * k)
    out.append("")
    a_l = ", ".join(f"a[{i}]" for i in range(n_committed))
    s_l = ", ".join(f"S[{i}]" for i in range(n_committed))
    out.append(f"    {{ {a_l} }} connect {{ {s_l} }};")
    out.append("")
    return "\n".join(out)


# ---------------------------------------------------------------------------
# setup


class _Const:
    def __init__(self, n, cols, n_public_rows, fflonk=False):
        obj = lambda: np.zeros(n, dtype=object)
        self.N = n
        self.C = [obj() for _ in range(5)]
        self.S = [obj() for _ in range(cols)]
        self.L = [obj() for _ in range(n_public_rows)]
        self.sel = {"GATE": obj()}
        if not fflonk:
            for k in [
                "POSEIDON_PARTIAL_ROUND", "POSEIDON_FULL_ROUND",
                "RANGE_CHECK", "RANGE", "GLCMULADD",
            ]:
                self.sel[k] = obj()


def setup(r1cs, cols: int = 9, options=None):
    """plonkSetup over Fr.  r1cs: compiler.circom_front.CompiledCircuit
    (compiled with prime=Fr).  Returns {pil, pilSource, constPols (N×nConst
    object array in PIL declaration order), sMap, plonkAdditions, nBits,
    nPublics, NUsed}."""
    options = options or {}
    if cols not in (9, 6, 0):
        raise ValueError("cols must be 9, 6 (custom-gate) or 0 (finalfflonk)")

    plonk_in = [
        (a, b, {s: (FR - v) % FR for s, v in c.items()})
        for a, b, c in r1cs.constraints
    ]
    plonk_constraints, plonk_additions, _ = r2p.r1cs2plonk(
        FR, plonk_in, r1cs.n_vars
    )
    n_publics = r1cs.n_outputs + r1cs.n_pub_inputs

    if cols == 0:
        return _setup_fflonk(
            r1cs, plonk_constraints, plonk_additions, n_publics, options
        )
    return _setup_final(
        r1cs, cols, plonk_constraints, plonk_additions, n_publics, options
    )


def _force_bits(n_used, options):
    n_bits = max((n_used - 1).bit_length(), 2)
    force = options.get("forceNBits")
    if force:
        if force < n_bits:
            raise ValueError("forceNBits is less than required")
        n_bits = force
    return n_bits


def _setup_final(r1cs, cols, plonk_constraints, plonk_additions, n_publics,
                 options):
    """final9_setup.js / final6_setup.js."""
    info = custom_gates_info(r1cs)
    t = info["nPoseidonInputs"] if info["nPoseidonT"] else None
    if t is not None:
        if t > 5:
            raise ValueError(
                f"PoseidonT t={t} exceeds the 5 shared state columns of the"
                f" final{cols} layout (final9_setup.js:131 j<5)"
            )
        C_pos, M_pos = _poseidon_cm(t)
        n_rounds_p = N_ROUNDS_P[t - 2]
        n_rounds = N_ROUNDS_F + n_rounds_p
    else:
        C_pos = M_pos = None
        n_rounds_p = n_rounds = 0

    n_plonk = 3 if cols == 9 else 2
    range_rows = info["nRangeCheck"]
    glc_rows = info["nGLCMulAdd"] * 2
    # only final9 recycles the free a[6..8] slots of custom rows
    extra_plonk = (range_rows + info["nGLCMulAdd"]) if cols == 9 else 0
    c_plonk = calculate_plonk_rows(plonk_constraints, n_plonk, extra_plonk)
    n_public_rows = (n_publics - 1) // cols + 1
    poseidon_rows = info["nPoseidonT"] * (n_rounds + 1)
    n_used = n_public_rows + c_plonk + poseidon_rows + range_rows + glc_rows
    n_bits = _force_bits(n_used, options)
    n = 1 << n_bits

    pil_src = _pil_source_final(n_bits, n_publics, cols, t, M_pos)
    pil = pil1_parser.compile_pil_source(pil_src)
    pil["name"] = "Final"

    cp = _Const(n, cols, n_public_rows)
    s_map = [np.zeros(n, dtype=np.uint64) for _ in range(cols)]

    # publics (final9_setup.js:104-112)
    for i in range(n_public_rows * cols):
        if i < n_publics:
            s_map[i % cols][i // cols] = 1 + i
    r = n_public_rows

    extra_rows_plonk = []  # final9: rows whose a[6..8] take one plonk set

    # custom gate rows (final9_setup.js:120-186)
    for u in r1cs.custom_uses:
        sig = u["signals"]
        if u["id"] == info["PoseidonT"] and info["nPoseidonT"]:
            assert len(sig) == (n_rounds + 1) * t
            for k in range(n_rounds + 1):
                for j in range(t):
                    s_map[j][r + k] = sig[k * t + j]
                    if k < n_rounds:
                        cp.C[j][r + k] = C_pos[k * t + j]
                if k < n_rounds:
                    is_full = k < 4 or k >= n_rounds_p + 4
                    cp.sel["POSEIDON_FULL_ROUND"][r + k] = 1 if is_full else 0
                    cp.sel["POSEIDON_PARTIAL_ROUND"][r + k] = 0 if is_full else 1
            r += n_rounds + 1
        elif u["id"] in info["RangeCheckNBits"]:
            n_bytes = -(-info["RangeCheckNBits"][u["id"]] // 16)
            assert len(sig) == 1 + n_bytes
            cp.sel["RANGE_CHECK"][r] = 1
            s_map[0][r] = sig[0]
            for k in range(1, min(6, n_bytes + 1)):
                s_map[k][r] = sig[k]
            if cols == 9:
                extra_rows_plonk.append(r)
            r += 1
        elif u["id"] == info["GLCMulAdd"]:
            assert len(sig) == 12
            cp.sel["GLCMULADD"][r] = 1
            for k in range(6):
                s_map[k][r] = sig[k]
                s_map[k][r + 1] = sig[k + 6]
            if cols == 9:
                extra_rows_plonk.append(r)
            r += 2
        else:
            raise ValueError(f"Custom gate not defined: {u['id']}")

    # 16-bit range table (final9_setup.js:189; final6 asserts N >= 65536)
    if cols == 6 and n < 65536:
        raise ValueError("final6 requires N >= 65536 for the RANGE table")
    rng = cp.sel["RANGE"]
    for i in range(n):
        rng[i] = i % 65536

    # plonk constraint packing (final9_setup.js:196-268)
    partial = {}
    for c in plonk_constraints:
        key = ",".join(format(int(v) % FR, "x") for v in c[3:8])
        if extra_rows_plonk:
            row = extra_rows_plonk.pop(0)
            for j in range(5):
                cp.C[j][row] = int(c[3 + j]) % FR
            s_map[6][row] = c[0]
            s_map[7][row] = c[1]
            s_map[8][row] = c[2]
        elif key in partial:
            pr = partial[key]
            s_map[pr["nUsed"] * 3][pr["row"]] = c[0]
            s_map[pr["nUsed"] * 3 + 1][pr["row"]] = c[1]
            s_map[pr["nUsed"] * 3 + 2][pr["row"]] = c[2]
            pr["nUsed"] += 1
            if pr["nUsed"] == n_plonk:
                del partial[key]
        else:
            cp.sel["GATE"][r] = 1
            for j in range(n_plonk):
                s_map[3 * j][r] = c[0]
                s_map[3 * j + 1][r] = c[1]
                s_map[3 * j + 2][r] = c[2]
            for j in range(5):
                cp.C[j][r] = int(c[3 + j]) % FR
            partial[key] = {"row": r, "nUsed": 1}
            r += 1

    _fill_connection(cp, s_map, r, cols, n_bits)
    _fill_lagrangians(cp, n_public_rows)

    const_pols = _pack_consts(pil, cp)
    return {
        "pil": pil,
        "pilSource": pil_src,
        "constPols": const_pols,
        "sMap": s_map,
        "plonkAdditions": plonk_additions,
        "nBits": n_bits,
        "nPublics": n_publics,
        "NUsed": n_used,
    }


def _setup_fflonk(r1cs, plonk_constraints, plonk_additions, n_publics,
                  options):
    """finalfflonk_setup.js: plain plonk, nCommitted=3k columns."""
    n_committed = int(options.get("nCommitted", 6))
    if n_committed % 3 != 0 or n_committed < 3:
        raise ValueError("Invalid number of committed polynomials")
    n_plonk = n_committed // 3
    c_plonk = calculate_plonk_rows(plonk_constraints, n_plonk)
    n_public_rows = (n_publics - 1) // n_committed + 1
    n_used = n_public_rows + c_plonk
    n_bits = _force_bits(n_used, options)
    n = 1 << n_bits

    pil_src = _pil_source_fflonk(n_bits, n_publics, n_committed)
    pil = pil1_parser.compile_pil_source(pil_src)
    pil["name"] = "Final"

    cp = _Const(n, n_committed, n_public_rows, fflonk=True)
    s_map = [np.zeros(n, dtype=np.uint64) for _ in range(n_committed)]
    for i in range(n_public_rows * n_committed):
        if i < n_publics:
            s_map[i % n_committed][i // n_committed] = 1 + i
    r = n_public_rows

    partial = {}
    for c in plonk_constraints:
        key = ",".join(format(int(v) % FR, "x") for v in c[3:8])
        if key in partial:
            pr = partial[key]
            s_map[pr["nUsed"] * 3][pr["row"]] = c[0]
            s_map[pr["nUsed"] * 3 + 1][pr["row"]] = c[1]
            s_map[pr["nUsed"] * 3 + 2][pr["row"]] = c[2]
            pr["nUsed"] += 1
            if pr["nUsed"] == n_plonk:
                del partial[key]
        else:
            cp.sel["GATE"][r] = 1
            for j in range(n_plonk):
                s_map[3 * j][r] = c[0]
                s_map[3 * j + 1][r] = c[1]
                s_map[3 * j + 2][r] = c[2]
            for j in range(5):
                cp.C[j][r] = int(c[3 + j]) % FR
            partial[key] = {"row": r, "nUsed": 1}
            r += 1

    _fill_connection(cp, s_map, r, n_committed, n_bits)
    _fill_lagrangians(cp, n_public_rows)

    const_pols = _pack_consts(pil, cp)
    return {
        "pil": pil,
        "pilSource": pil_src,
        "constPols": const_pols,
        "sMap": s_map,
        "plonkAdditions": plonk_additions,
        "nBits": n_bits,
        "nPublics": n_publics,
        "NUsed": n_used,
    }


def _fill_connection(cp, s_map, n_rows_used, cols, n_bits):
    """S grid + copy-constraint cycles (final9_setup.js:270-302)."""
    from ..ops.fft_bn128 import w as fr_w

    n = cp.N
    ks = get_ks(cols - 1, field="fr")
    wN = fr_w(n_bits)
    wv = 1
    for i in range(n):
        cp.S[0][i] = wv
        for j in range(1, cols):
            cp.S[j][i] = wv * ks[j - 1] % FR
        wv = wv * wN % FR

    last_signal = {}
    for i in range(n_rows_used):
        for j in range(cols):
            s = int(s_map[j][i])
            if s:
                if s in last_signal:
                    lc, lr = last_signal[s]
                    cp.S[lc][lr], cp.S[j][i] = cp.S[j][i], cp.S[lc][lr]
                else:
                    last_signal[s] = (j, i)


def _fill_lagrangians(cp, n_public_rows):
    for i in range(n_public_rows):
        cp.L[i][i] = 1


def _pack_consts(pil, cp):
    """Arrange fixed columns in PIL declaration order → (N, nConst) object
    array (the shape fflonk_setup consumes)."""
    order = []
    for name, ref in pil["references"].items():
        if ref["type"] != "constP":
            continue
        order.append((ref["id"], name, ref))
    order.sort()
    cols_out = []
    for _, name, ref in order:
        short = name.split(".", 1)[1]
        if name.startswith("Global.L"):
            cols_out.append(cp.L[int(short[1:]) - 1])
        elif ref.get("isArray"):
            arrs = cp.S if short == "S" else cp.C
            for j in range(ref["len"]):
                cols_out.append(arrs[j])
        elif short in cp.sel:
            cols_out.append(cp.sel[short])
        else:
            raise KeyError(name)
    return np.stack(cols_out, axis=1)
