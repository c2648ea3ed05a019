"""C12 compressor: turn a verifier-circuit R1CS (with custom gates) into a
12-column PlonK-ish PIL machine + witness mapping, so a STARK proof can be
verified inside the next STARK (the recursion tier).

Counterpart of pil2-stark-js src/compressor/{compressor12_setup.js,
compressor12.pil.ejs, compressor_exec.js, compressor_constraints.js},
re-built on this framework's own pieces: the PIL text is generated by
`_pil_source` (same constraint semantics as compressor12.pil.ejs:14-352),
compiled by compiler.pil1_parser, and the input R1CS comes from
compiler.circom_front (our in-repo circom compiler) instead of an external
`circom` binary.

Row layout (compressor12_setup.js:100-470):
- public rows: 12 publics per row, pinned by Global.L{i} lagrangians;
- Poseidon12/CustPoseidon12: 11 rows (in, 4 full rounds, 2 partial-round
  batches of 11, 3 closing rounds, out) with per-row constants C[j];
- CMul: 1 row (wires in a[3..11]), its a[0..5] slots recycled for plonk;
- FFT4: 2 rows, twiddle constants baked into C[0..8];
- EvPol4: 2 rows, a[0..2] of the first recycled for plonk;
- TreeSelector4: 2 rows, a[0..5] of the first recycled for plonk;
- plonk rows: 2 constraint sets × 2 wire sets per row (GATE selector).
"""
from __future__ import annotations

import numpy as np

from ..field import gl64
from . import pil1_parser, r1cs2plonk as r2p
from .pil1_libs import get_ks

P = gl64.P_INT


def _load_poseidon_c_s():
    import os

    path = os.path.join(
        os.path.dirname(__file__), "..", "hash", "poseidon_gl_constants.npz"
    )
    d = np.load(path)
    return (
        [int(x) for x in d["C"]],
        [int(x) for x in d["S"]],
        [[int(x) for x in row] for row in d["M"]],
        [[int(x) for x in row] for row in d["P"]],
    )


# ---------------------------------------------------------------------------
# PIL source generation (compressor12.pil.ejs semantics)


def _pil_source(n_bits: int, n_publics: int) -> str:
    C, S, M, Pm = _load_poseidon_c_s()
    n_public_rows = (n_publics + 11) // 12
    out = [f"constant %N = 2**{n_bits};", ""]
    out.append("namespace Global(%N);")
    for i in range(n_public_rows):
        out.append(f"    pol constant L{i + 1};")
    out.append("")
    out.append("namespace Compressor(%N);")
    out.append("    pol constant S[12];")
    out.append("    pol constant C[12];")
    for sel in [
        "POSEIDONM", "POSEIDONCUSTFIRST", "POSEIDONP", "POSEIDONFIRST",
        "PARTIALROUND", "PARTIALROUND2", "GATE", "CMUL", "EVPOL4", "FFT4",
        "TREESELECTOR4",
    ]:
        out.append(f"    pol constant {sel};")
    out.append("    pol commit a[12];")
    out.append("")
    for i in range(n_publics):
        out.append(f"    public pub{i} = a[{i % 12}]({i // 12});")
    for i in range(n_publics):
        out.append(f"    Global.L{i // 12 + 1} * (a[{i % 12}] - :pub{i}) = 0;")
    out.append("")

    # two plonk constraint sets per row, two wire sets each
    out.append("    pol a01 = a[0]*a[1];")
    out.append("    pol g012 = C[0]*a01 + C[1]*a[0] + C[2]*a[1] + C[3]*a[2] + C[4];")
    out.append("    g012*GATE = 0;")
    out.append("    pol a34 = a[3]*a[4];")
    out.append("    pol g345 = C[0]*a34 + C[1]*a[3] + C[2]*a[4] + C[3]*a[5] + C[4];")
    out.append("    g345*GATE = 0;")
    out.append("    pol a67 = a[6]*a[7];")
    out.append("    pol g678 = C[6]*a67 + C[7]*a[6] + C[8]*a[7] + C[9]*a[8] + C[10];")
    out.append("    g678*GATE = 0;")
    out.append("    pol a910 = a[9]*a[10];")
    out.append("    pol g91011 = C[6]*a910 + C[7]*a[9] + C[8]*a[10] + C[9]*a[11] + C[10];")
    out.append("    g91011*GATE = 0;")
    out.append("")

    # Poseidon rows.  The key-ordered first row (CustPoseidon) swaps the
    # halves by the key bit in a[8].
    for r in range(4):
        out.append(f"    pol cpIn{r} = a[8] * (a[{r}] - a[{r + 4}]) + a[{r + 4}];")
    for r in range(4, 8):
        out.append(f"    pol cpIn{r} = a[8] * (a[{r}] - a[{r - 4}]) + a[{r - 4}];")
    out.append("    pol keyBin = a[8] * (a[8] - 1);")
    out.append("    POSEIDONCUSTFIRST * keyBin = 0;")
    out.append("")

    # Per-row state entry: ordinary rows read a[r]; first rows add the
    # pre-round constant; CustPoseidon first rows use the swapped inputs
    # (capacity lanes forced to zero).
    for r in range(12):
        if r < 8:
            out.append(
                f"    pol inp{r} = POSEIDONCUSTFIRST * (cpIn{r} - a[{r}]) + a[{r}]"
                f" + (POSEIDONFIRST + POSEIDONCUSTFIRST) * {C[r]};"
            )
        else:
            out.append(
                f"    pol inp{r} = POSEIDONCUSTFIRST * (0 - a[{r}]) + a[{r}]"
                f" + (POSEIDONFIRST + POSEIDONCUSTFIRST) * {C[r]};"
            )
        if 0 < r < 11:
            # partial-round batches re-enter through the running s0 chain
            out.append(
                f"    pol pin{r} = PARTIALROUND * ps0r{r - 1} + PARTIALROUND2 * ps0r{r + 10}"
                f" + (POSEIDONM + POSEIDONP) * inp{r};"
            )
            src = f"pin{r}"
        else:
            src = f"inp{r}"
        out.append(f"    pol sq{r}_2 = {src} * {src};")
        out.append(f"    pol sq{r}_4 = sq{r}_2 * sq{r}_2;")
        out.append(f"    pol sq{r}_6 = sq{r}_4 * sq{r}_2;")
        out.append(f"    pol sx{r} = sq{r}_6 * {src} + C[{r}];")
        out.append("")

        if r < 11:
            # two interleaved partial-round chains (rounds r and r+11):
            # ps0r{k} is the sparse-matrix s0 recomputation, psJr{k} the
            # running additive updates of lanes 1..11
            for base, cname in ((r, f"ps"), (r + 11, f"ps")):
                terms = []
                for j in range(12):
                    v = f"sx{r}" if j == 0 else (
                        f"a[{j}]" if r == 0 else f"ps{j}r{base - 1}"
                    )
                    terms.append(f"{S[23 * base + j]} * {v}")
                out.append(f"    pol ps0r{base} = " + " + ".join(terms) + ";")
                for j in range(1, 12):
                    prev = f"a[{j}]" if r == 0 else f"ps{j}r{base - 1}"
                    out.append(
                        f"    pol ps{j}r{base} = {prev} + sx{r} * {S[23 * base + 11 + j]};"
                    )
                out.append("")

    for i in range(12):
        terms = " + ".join(f"{Pm[j][i]} * sx{j}" for j in range(12))
        out.append(f"    POSEIDONP * (a[{i}]' - ({terms})) = 0;")
    for i in range(12):
        terms = " + ".join(f"{M[j][i]} * sx{j}" for j in range(12))
        out.append(f"    POSEIDONM * (a[{i}]' - ({terms})) = 0;")
    for i in range(12):
        out.append(f"    PARTIALROUND * (a[{i}]' - ps{i}r10) = 0;")
    for i in range(12):
        out.append(f"    PARTIALROUND2 * (a[{i}]' - ps{i}r21) = 0;")
    out.append("")

    # CMul row: (a3,a4,a5)·(a6,a7,a8) = (a9,a10,a11) over x^3 = x + 1
    out.append("    pol cmA = (a[3] + a[4]) * (a[6] + a[7]);")
    out.append("    pol cmB = (a[3] + a[5]) * (a[6] + a[8]);")
    out.append("    pol cmC = (a[4] + a[5]) * (a[7] + a[8]);")
    out.append("    pol cmD = a[3]*a[6];")
    out.append("    pol cmE = a[4]*a[7];")
    out.append("    pol cmF = a[5]*a[8];")
    out.append("    CMUL * (a[9] - (cmC + cmD - cmE - cmF)) = 0;")
    out.append("    CMUL * (a[10] - (cmA + cmC - 2*cmE - cmD)) = 0;")
    out.append("    CMUL * (a[11] - (cmB - cmD + cmE)) = 0;")
    out.append("    g012*CMUL = 0;")
    out.append("")

    # FFT4 row: radix-4/2 butterfly with constants in C[0..8]
    for e in range(3):
        out.append(
            f"    pol fg{e} = C[0]*a[{e}] + C[1]*a[{e + 3}] + C[2]*a[{e + 6}] + C[3]*a[{e + 9}] + C[6]*a[{e}] + C[7]*a[{e + 3}];"
        )
        out.append(
            f"    pol fg{e + 3} = C[0]*a[{e}] - C[1]*a[{e + 3}] + C[4]*a[{e + 6}] - C[5]*a[{e + 9}] + C[6]*a[{e}] - C[7]*a[{e + 3}];"
        )
        out.append(
            f"    pol fg{e + 6} = C[0]*a[{e}] + C[1]*a[{e + 3}] - C[2]*a[{e + 6}] - C[3]*a[{e + 9}] + C[6]*a[{e + 6}] + C[8]*a[{e + 9}];"
        )
        out.append(
            f"    pol fg{e + 9} = C[0]*a[{e}] - C[1]*a[{e + 3}] - C[4]*a[{e + 6}] + C[5]*a[{e + 9}] + C[6]*a[{e + 6}] - C[8]*a[{e + 9}];"
        )
    for i in range(12):
        out.append(f"    FFT4 * (a[{i}]' - fg{i}) = 0;")
    out.append("")

    # EvPol4 rows: Horner over 4 coefficient triples at x = a[0..2]'
    def cmuladd(tag, a3, b3, c3):
        lines = [
            f"    pol ev{tag}A = ({a3[0]} + {a3[1]}) * ({b3[0]} + {b3[1]});",
            f"    pol ev{tag}B = ({a3[0]} + {a3[2]}) * ({b3[0]} + {b3[2]});",
            f"    pol ev{tag}C = ({a3[1]} + {a3[2]}) * ({b3[1]} + {b3[2]});",
            f"    pol ev{tag}D = {a3[0]} * {b3[0]};",
            f"    pol ev{tag}E = {a3[1]} * {b3[1]};",
            f"    pol ev{tag}F = {a3[2]} * {b3[2]};",
            f"    pol ev{tag}0 = ev{tag}C + ev{tag}D - ev{tag}E - ev{tag}F + {c3[0]};",
            f"    pol ev{tag}1 = ev{tag}A + ev{tag}C - 2*ev{tag}E - ev{tag}D + {c3[1]};",
            f"    pol ev{tag}2 = ev{tag}B - ev{tag}D + ev{tag}E + {c3[2]};",
        ]
        return lines, [f"ev{tag}0", f"ev{tag}1", f"ev{tag}2"]

    x3 = ["a[6]'", "a[7]'", "a[8]'"]
    lines, acc = cmuladd("1", ["a[3]'", "a[4]'", "a[5]'"], x3, ["a[0]'", "a[1]'", "a[2]'"])
    out += lines
    lines, acc = cmuladd("2", acc, x3, ["a[9]", "a[10]", "a[11]"])
    out += lines
    lines, acc = cmuladd("3", acc, x3, ["a[6]", "a[7]", "a[8]"])
    out += lines
    lines, acc = cmuladd("4", acc, x3, ["a[3]", "a[4]", "a[5]"])
    out += lines
    for e in range(3):
        out.append(f"    EVPOL4 * (a[{e + 9}]' - {acc[e]}) = 0;")
    out.append("    g012*EVPOL4 = 0;")
    out.append("")

    # TreeSelector4 rows: 4-way select with key in a[6]',a[7]'
    vals = [["a[6]", "a[7]", "a[8]"], ["a[9]", "a[10]", "a[11]"],
            ["a[0]'", "a[1]'", "a[2]'"], ["a[3]'", "a[4]'", "a[5]'"]]
    keys = ["(1 - a[6]')*(1 - a[7]')", "(a[6]')*(1 - a[7]')",
            "(1 - a[6]')*(a[7]')", "(a[6]')*(a[7]')"]
    for ki, kexpr in enumerate(keys):
        out.append(f"    pol tsk{ki} = {kexpr};")
        for e in range(3):
            out.append(
                f"    pol tsv{ki}_{e} = tsk{ki} * ({vals[ki][e]} - a[{e + 8}]');"
            )
            out.append(f"    TREESELECTOR4 * tsv{ki}_{e} = 0;")
    out.append("    g012*TREESELECTOR4 = 0;")
    out.append("    g345*TREESELECTOR4 = 0;")
    out.append("    pol tsb1 = a[6]'*(1 - a[6]');")
    out.append("    pol tsb2 = a[7]'*(1 - a[7]');")
    out.append("    TREESELECTOR4 * tsb1 = 0;")
    out.append("    TREESELECTOR4 * tsb2 = 0;")
    out.append("")

    a_list = ",".join(f"a[{i}]" for i in range(12))
    s_list = ",".join(f"S[{i}]" for i in range(12))
    out.append(f"    {{ {a_list} }} connect {{ {s_list} }};")
    out.append("")
    return "\n".join(out)


# ---------------------------------------------------------------------------
# setup


class _Const:
    """Column store keyed like the reference's constPols.Compressor.*"""

    def __init__(self, n, n_public_rows):
        self.N = n
        z = lambda: np.zeros(n, dtype=np.uint64)
        self.sel = {
            k: z()
            for k in [
                "POSEIDONM", "POSEIDONCUSTFIRST", "POSEIDONP", "POSEIDONFIRST",
                "PARTIALROUND", "PARTIALROUND2", "GATE", "CMUL", "EVPOL4",
                "FFT4", "TREESELECTOR4",
            ]
        }
        self.C = [z() for _ in range(12)]
        self.S = [z() for _ in range(12)]
        self.L = [z() for _ in range(n_public_rows)]


def setup(r1cs, options=None):
    """r1cs: compiler.circom_front.CompiledCircuit (or any object with
    .constraints (A·B + C = 0 dicts), .custom_gates, .custom_uses,
    .n_outputs, .n_pub_inputs, .n_vars).  Returns {pil, pilSource,
    constBuffer, sMap, plonkAdditions, nBits, nPublics}."""
    options = options or {}
    C, S, M, Pm = _load_poseidon_c_s()

    # A·B + C = 0  ->  A·B = (-C)
    plonk_in = [
        (a, b, {s: (P - v) % P for s, v in c.items()}) for a, b, c in r1cs.constraints
    ]
    plonk_constraints, plonk_additions, n_vars = r2p.r1cs2plonk(
        P, plonk_in, r1cs.n_vars
    )

    gates_by_id = {i: g for i, g in enumerate(r1cs.custom_gates)}
    n_publics = r1cs.n_outputs + r1cs.n_pub_inputs
    n_public_rows = (n_publics + 11) // 12

    # ---- row count (compressor_constraints.js getCompressorConstraints)
    counts = {"Poseidon12": 0, "CustPoseidon12": 0, "CMul": 0, "FFT4": 0,
              "EvPol4": 0, "TreeSelector4": 0}
    for u in r1cs.custom_uses:
        counts[gates_by_id[u["id"]]["template"]] += 1
    n_custom_rows = (
        n_public_rows
        + counts["CMul"]
        + 11 * (counts["Poseidon12"] + counts["CustPoseidon12"])
        + 2 * counts["FFT4"]
        + 2 * counts["EvPol4"]
        + 2 * counts["TreeSelector4"]
    )
    n_plonk_rows = _count_plonk_rows(
        plonk_constraints, counts["EvPol4"] + counts["CMul"],
        counts["TreeSelector4"],
    )
    n_used = n_custom_rows + n_plonk_rows
    n_bits = max((n_used - 1).bit_length(), 2)
    if options.get("forceNBits"):
        if options["forceNBits"] < n_bits:
            raise ValueError("forceNBits is less than required")
        n_bits = options["forceNBits"]
    n = 1 << n_bits

    pil_src = _pil_source(n_bits, n_publics)
    pil = pil1_parser.compile_pil_source(pil_src)
    pil["name"] = "Compressor"

    cp = _Const(n, n_public_rows)
    s_map = [np.zeros(n, dtype=np.uint32) for _ in range(12)]

    # ---- public rows
    for i in range(n_public_rows):
        for k in range(12):
            n_pub = 12 * i + k
            s_map[k][i] = 1 + n_pub if n_pub < n_publics else 0
    r = n_public_rows

    extra_rows = []  # CMul / EvPol4 first rows with free a[0..5] slots
    extra_rows_ts = []  # TreeSelector4 first rows with free a[0..5]

    # ---- custom gate rows (compressor12_setup.js:100-330)
    for u in r1cs.custom_uses:
        g = gates_by_id[u["id"]]
        t = g["template"]
        sig = u["signals"]
        if t in ("Poseidon12", "CustPoseidon12"):
            cust = t == "CustPoseidon12"
            assert len(sig) == (9 + 10 * 12 if cust else 11 * 12)
            cc = 12
            sp = 0
            for i in range(11):
                for j in range(12):
                    if cust and i == 0 and j >= 9:
                        s_map[j][r + i] = 0
                    else:
                        s_map[j][r + i] = sig[sp]
                        sp += 1
                    skip_c = (
                        (i == 4 and j == 11) or (i == 5 and j == 11)
                        or i in (9, 10)
                    )
                    if skip_c:
                        cp.C[j][r + i] = 0
                    else:
                        cp.C[j][r + i] = C[cc]
                        cc += 1
                cp.sel["POSEIDONM"][r + i] = 1 if i not in (3, 4, 5, 10) else 0
                cp.sel["POSEIDONP"][r + i] = 1 if i == 3 else 0
                cp.sel["POSEIDONFIRST"][r + i] = 1 if (i == 0 and not cust) else 0
                cp.sel["POSEIDONCUSTFIRST"][r + i] = 1 if (i == 0 and cust) else 0
                cp.sel["PARTIALROUND"][r + i] = 1 if i == 4 else 0
                cp.sel["PARTIALROUND2"][r + i] = 1 if i == 5 else 0
            r += 11
        elif t == "CMul":
            assert len(sig) == 9
            for i in range(9):
                s_map[i + 3][r] = sig[i]
            cp.sel["CMUL"][r] = 1
            extra_rows.append(r)
            r += 1
        elif t == "FFT4":
            assert len(sig) == 24
            for i in range(12):
                s_map[i][r] = sig[i]
                s_map[i][r + 1] = sig[12 + i]
            cp.sel["FFT4"][r] = 1
            ftype, scale, first_w, inc_w = (
                int(g["parameters"][0]),
                int(g["parameters"][1]),
                int(g["parameters"][2]),
                int(g["parameters"][3]),
            )
            _fill_fft4_consts(cp, r, ftype, scale, first_w, inc_w)
            r += 2
        elif t == "EvPol4":
            assert len(sig) == 21
            for i in range(9):
                s_map[i + 3][r] = sig[i]
            for i in range(12):
                s_map[i][r + 1] = sig[9 + i]
            cp.sel["EVPOL4"][r] = 1
            extra_rows.append(r)
            r += 2
        elif t == "TreeSelector4":
            assert len(sig) == 17
            for i in range(6):
                s_map[i + 6][r] = sig[i]
            for i in range(11):
                s_map[i][r + 1] = sig[i + 6]
            cp.sel["TREESELECTOR4"][r] = 1
            extra_rows_ts.append(r)
            r += 2
        else:
            raise ValueError(f"unknown custom gate {t}")

    # ---- plonk constraint packing (compressor12_setup.js:340-470)
    partial_rows = {}
    half_rows = []
    for c in plonk_constraints:
        k = ",".join(format(x % P, "x") for x in c[3:8])
        if k in partial_rows:
            pr = partial_rows[k]
            for e in range(3):
                s_map[pr["nUsed"] * 3 + e][pr["row"]] = c[e]
            pr["nUsed"] += 1
            if pr["nUsed"] in (2, 4):
                del partial_rows[k]
        elif half_rows:
            pr = half_rows.pop(0)
            for e in range(5):
                cp.C[6 + e][pr["row"]] = c[3 + e] % P
            cp.C[11][pr["row"]] = 0
            for e in range(3):
                s_map[pr["nUsed"] * 3 + e][pr["row"]] = c[e]
            pr["nUsed"] += 1
            partial_rows[k] = pr
        elif extra_rows_ts:
            row = extra_rows_ts.pop(0)
            for e in range(5):
                cp.C[e][row] = c[3 + e] % P
            for e in range(3):
                s_map[e][row] = c[e]
            partial_rows[k] = {"row": row, "nUsed": 1}
        elif extra_rows:
            row = extra_rows.pop(0)
            for e in range(5):
                cp.C[e][row] = c[3 + e] % P
            for e in range(3):
                s_map[e][row] = c[e]
        else:
            for e in range(5):
                cp.C[e][r] = c[3 + e] % P
            cp.sel["GATE"][r] = 1
            for e in range(3):
                s_map[e][r] = c[e]
            partial_rows[k] = {"row": r, "nUsed": 1}
            half_rows.append({"row": r, "nUsed": 2})
            r += 1

    # close half-used rows by duplicating the satisfied wire set
    for pr in partial_rows.values():
        if pr["nUsed"] == 1:
            for e in range(3):
                s_map[3 + e][pr["row"]] = s_map[e][pr["row"]]
        elif pr["nUsed"] == 3:
            for e in range(3):
                s_map[9 + e][pr["row"]] = s_map[6 + e][pr["row"]]
        else:
            raise AssertionError("unreachable partial row state")

    # ---- S (connection) polynomials
    ks = get_ks(11)
    w_pows = gl64.powers(gl64.w(n_bits), n)
    cp.S[0][:] = w_pows
    for j in range(1, 12):
        cp.S[j][:] = gl64.mul(w_pows, np.uint64(ks[j - 1]))

    last_signal = {}
    for i in range(r):
        for j in range(12):
            s = int(s_map[j][i])
            if s:
                if s in last_signal:
                    lc, lr = last_signal[s]
                    tmp = int(cp.S[lc][lr])
                    cp.S[lc][lr] = cp.S[j][i]
                    cp.S[j][i] = tmp
                else:
                    last_signal[s] = (j, i)

    for i in range(n_public_rows):
        cp.L[i][i] = 1

    const_buffer = _pack_consts(pil, cp)
    return {
        "pil": pil,
        "pilSource": pil_src,
        "constBuffer": const_buffer,
        "sMap": s_map,
        "plonkAdditions": plonk_additions,
        "nBits": n_bits,
        "nPublics": n_publics,
        "nUsed": r,
    }


def _count_plonk_rows(plonk_constraints, evalpol_cmul_rows, treeselector_rows):
    """compressor_helpers.js calculatePlonkConstraintsRowsC12."""
    partial = {}
    half = False
    r = 0
    ev = evalpol_cmul_rows
    ts = treeselector_rows
    for c in plonk_constraints:
        k = ",".join(format(x % P, "x") for x in c[3:8])
        if k in partial:
            partial[k] += 1
            if partial[k] in (2, 4):
                del partial[k]
        elif half:
            partial[k] = 3
            half = False
        elif ts > 0:
            ts -= 1
            partial[k] = 1
        elif ev > 0:
            ev -= 1
        else:
            partial[k] = 1
            half = True
            r += 1
    return r


def _fill_fft4_consts(cp, r, ftype, scale, first_w, inc_w):
    """compressor12_setup.js:225-252 — twiddles baked per FFT4 row.
    Parameter order matches circuits FFT4(type, scale, firstW, incW)."""
    fw2 = (first_w * first_w) % P
    if ftype == 4:
        cp.C[0][r] = scale % P
        cp.C[1][r] = (scale * fw2) % P
        cp.C[2][r] = (scale * first_w) % P
        cp.C[3][r] = (scale * first_w * fw2) % P
        cp.C[4][r] = (scale * first_w * inc_w) % P
        cp.C[5][r] = (scale * first_w * fw2 * inc_w) % P
    elif ftype == 2:
        cp.C[6][r] = scale % P
        cp.C[7][r] = (scale * first_w) % P
        cp.C[8][r] = (scale * first_w * inc_w) % P
    else:
        raise ValueError(f"invalid FFT4 type {ftype}")


def _pack_consts(pil, cp):
    """Arrange the columns in the PIL's fixed-column declaration order."""
    n = cp.N
    cols = []
    order = []
    for name, ref in pil["references"].items():
        if ref["type"] != "constP":
            continue
        order.append((ref["id"], name, ref))
    order.sort()
    for _, name, ref in order:
        short = name.split(".", 1)[1]
        if name.startswith("Global.L"):
            cols.append(cp.L[int(short[1:]) - 1])
        elif short.startswith("S["):
            pass  # arrays handled below by base name
        if ref.get("isArray"):
            base = short
            arrs = cp.S if base == "S" else cp.C
            for j in range(ref["len"]):
                cols.append(arrs[j])
        elif short in cp.sel:
            cols.append(cp.sel[short])
        elif not name.startswith("Global.L"):
            raise KeyError(name)
    buf = np.stack(cols, axis=1)
    return np.ascontiguousarray(buf)


# ---------------------------------------------------------------------------
# exec (compressor_exec.js:5-32)


def exec_witness(witness, plonk_additions, s_map, n_bits):
    """Extend the circuit witness with the plonk addition chain, scatter it
    through sMap into the 12 committed columns."""
    w = [int(x) for x in witness]
    for sl, sr, kl, kr in plonk_additions:
        w.append((w[sl] * kl + w[sr] * kr) % P)
    n = 1 << n_bits
    cm = np.zeros((n, 12), dtype=np.uint64)
    warr = np.array(w, dtype=np.uint64)
    for j in range(12):
        idx = np.asarray(s_map[j], dtype=np.int64)
        vals = warr[idx]
        vals[idx == 0] = 0
        cm[:, j] = vals
    return cm


# ---------------------------------------------------------------------------
# .exec artifact round-trip (exec_helpers.js:26-48 layout)


def write_exec_file(path, plonk_additions, s_map):
    n_adds = len(plonk_additions)
    n_smap = s_map[0].shape[0]
    with open(path, "wb") as f:
        np.array([n_adds, n_smap], dtype="<u8").tofile(f)
        if n_adds:
            np.array(plonk_additions, dtype="<u8").reshape(-1).tofile(f)
        np.stack([c.astype("<u8") for c in s_map], axis=1).reshape(-1).tofile(f)


def read_exec_file(path, n_cols=12):
    with open(path, "rb") as f:
        n_adds, n_smap = (int(x) for x in np.fromfile(f, dtype="<u8", count=2))
        adds = np.fromfile(f, dtype="<u8", count=n_adds * 4).reshape(n_adds, 4)
        smap = np.fromfile(f, dtype="<u8", count=n_smap * n_cols).reshape(
            n_smap, n_cols
        )
    s_map = [smap[:, j].astype(np.uint32) for j in range(n_cols)]
    return [list(map(int, a)) for a in adds], s_map
