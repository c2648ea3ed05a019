"""C18 compressor: verifier-circuit R1CS (with custom gates) → an
18-column PlonK-ish PIL machine + witness mapping.

Counterpart of pil2-stark-js src/compressor/{compressor18_setup.js,
compressor18.pil.ejs, compressor_constraints.js} — the denser sibling of
compressor12: three plonk constraint subsets per row (GATE covers subsets
1-2, GATE2 subset 3), two CMul gates per row, single-row TreeSelector4,
and Poseidon verified TWO full rounds per row so a hash costs 6 rows
instead of 11 (Input → R2 → R4 → 22 partial rounds in one PARTIALROUND
row → R26 → R28 → output), with the 22 partial-round sbox slots reusing
the row's 24 sbox chain positions.

Row/constant schedule (compressor18_setup.js:115-210):
  i=0  POSEIDONFIRST (+POSEIDONM out)   column C = Cst[12..23]
  i=1  POSEIDONP                        column C = Cst[36..47]
  i=2  PARTIALROUND                     column C = 0 (literals Cst[60..81])
  i=3  POSEIDONAFTERPART (+POSEIDONM)   column C = Cst[82..93]
  i=4  POSEIDONM                        column C = Cst[106..117]
  i=5  output row                       column C = 0
Each Poseidon/FFT4/EvPol4/public row leaves a[12..17] + C[12..16] free —
those join `extraRows` and host GATE2 plonk constraints.
"""
from __future__ import annotations

import numpy as np

from ..field import gl64
from . import pil1_parser, r1cs2plonk as r2p
from .compressor12 import _load_poseidon_c_s
from .pil1_libs import get_ks

P = gl64.P_INT

N_COLS = 18

_SELECTORS = [
    "POSEIDONM", "POSEIDONCUSTFIRST", "POSEIDONP", "POSEIDONFIRST",
    "PARTIALROUND", "POSEIDONAFTERPART", "GATE", "GATE2", "CMUL",
    "EVPOL4", "FFT4", "TREESELECTOR4",
]


# ---------------------------------------------------------------------------
# PIL source generation (compressor18.pil.ejs semantics)


def _pil_source(n_bits: int, n_publics: int) -> str:
    Cst, SS, M, Pm = _load_poseidon_c_s()
    n_public_rows = max(1, (n_publics + 11) // 12)
    out = [f"constant %N = 2**{n_bits};", ""]
    out.append("namespace Global(%N);")
    for i in range(n_public_rows):
        out.append(f"    pol constant L{i + 1};")
    out.append("")
    out.append("namespace Compressor(%N);")
    out.append(f"    pol constant S[{N_COLS}];")
    out.append("    pol constant C[18];")
    for sel in _SELECTORS:
        out.append(f"    pol constant {sel};")
    out.append(f"    pol commit a[{N_COLS}];")
    out.append("")
    for i in range(n_publics):
        out.append(f"    public pub{i} = a[{i % 12}]({i // 12});")
    for i in range(n_publics):
        out.append(f"    Global.L{i // 12 + 1} * (a[{i % 12}] - :pub{i}) = 0;")
    out.append("")

    # three plonk constraint subsets per row, two wire sets each
    # (compressor18.pil.ejs:55-77)
    for tag, w0, cbase, sel in [
        ("012", 0, 0, "GATE"), ("345", 3, 0, "GATE"),
        ("678", 6, 6, "GATE"), ("91011", 9, 6, "GATE"),
        ("121314", 12, 12, "GATE2"), ("151617", 15, 12, "GATE2"),
    ]:
        out.append(f"    pol m{tag} = a[{w0}]*a[{w0 + 1}];")
        out.append(
            f"    pol g{tag} = C[{cbase}]*m{tag} + C[{cbase + 1}]*a[{w0}]"
            f" + C[{cbase + 2}]*a[{w0 + 1}] + C[{cbase + 3}]*a[{w0 + 2}]"
            f" + C[{cbase + 4}];"
        )
        out.append(f"    g{tag}*{sel} = 0;")
    out.append("")

    # Poseidon: key-ordered inputs for the CustPoseidon first row
    for r in range(4):
        out.append(f"    pol cpIn{r} = a[8] * (a[{r}] - a[{r + 4}]) + a[{r + 4}];")
    for r in range(4, 8):
        out.append(f"    pol cpIn{r} = a[8] * (a[{r}] - a[{r - 4}]) + a[{r - 4}];")
    out.append("    pol keyBin = a[8] * (a[8] - 1);")
    out.append("    POSEIDONCUSTFIRST * keyBin = 0;")
    out.append("")

    def sbox(name: str, src: str, const: str):
        out.append(f"    pol {name}_2 = {src} * {src};")
        out.append(f"    pol {name}_4 = {name}_2 * {name}_2;")
        out.append(f"    pol {name}_6 = {name}_4 * {name}_2;")
        out.append(f"    pol {name}_R = {name}_6 * {src} + {const};")

    def emit_partial_chain(r: int):
        """Sparse partial-round step r of 22 (emitted as output constraints
        at r == 21, compressor18.pil.ejs:157-187)."""
        terms = []
        for j in range(12):
            if j == 0:
                terms.append(f"{SS[23 * r]} * a{r}_R")
            elif r == 0:
                terms.append(f"{SS[23 * r + j]} * a[{j}]")
            else:
                terms.append(f"{SS[23 * r + j]} * s{j}_R{r - 1}")
        if r == 21:
            out.append(
                "    PARTIALROUND * (a[0]' - (" + " + ".join(terms) + ")) = 0;"
            )
        else:
            out.append(f"    pol s0_R{r} = " + " + ".join(terms) + ";")
        for j in range(1, 12):
            prev = f"a[{j}]" if r == 0 else f"s{j}_R{r - 1}"
            step = f"a{r}_R * {SS[23 * r + 11 + j]}"
            if r == 21:
                out.append(
                    f"    PARTIALROUND * (a[{j}]' - ({prev} + {step})) = 0;"
                )
            else:
                out.append(f"    pol s{j}_R{r} = {prev} + {step};")

    # first sbox batch (the row's first full round / partials 1..12)
    for r in range(12):
        if r < 8:
            out.append(
                f"    pol inp{r} = POSEIDONCUSTFIRST * (cpIn{r} - a[{r}])"
                f" + a[{r}] + (POSEIDONFIRST + POSEIDONCUSTFIRST) * {Cst[r]};"
            )
        else:
            out.append(
                f"    pol inp{r} = POSEIDONCUSTFIRST * (0 - a[{r}])"
                f" + a[{r}] + (POSEIDONFIRST + POSEIDONCUSTFIRST) * {Cst[r]};"
            )
        out.append(
            f"    pol constC{r} = PARTIALROUND * ({Cst[60 + r]} - C[{r}]) + C[{r}];"
        )
        if r > 0:
            out.append(
                f"    pol inP{r} = PARTIALROUND * (s0_R{r - 1} - inp{r}) + inp{r};"
            )
            sbox(f"a{r}", f"inP{r}", f"constC{r}")
        else:
            sbox("a0", "inp0", "constC0")
        emit_partial_chain(r)
        out.append("")

    # intermediate MDS between the row's two rounds
    for i in range(12):
        terms = " + ".join(f"{M[j][i]} * a{j}_R" for j in range(12))
        out.append(f"    pol poseidonM{i} = {terms};")
    out.append("")

    # second sbox batch (second full round / partials 13..22)
    for r in range(12, 24):
        if r < 22:
            out.append(
                f"    pol inP{r} = PARTIALROUND * (s0_R{r - 1} - poseidonM{r - 12})"
                f" + poseidonM{r - 12};"
            )
            out.append(
                f"    pol constC{r} = PARTIALROUND * {Cst[60 + r]}"
                f" + (POSEIDONFIRST + POSEIDONCUSTFIRST) * {Cst[12 + r]}"
                f" + POSEIDONP * {Cst[36 + r]}"
                f" + POSEIDONAFTERPART * {Cst[82 + r]};"
            )
            sbox(f"a{r}", f"inP{r}", f"constC{r}")
            emit_partial_chain(r)
        else:
            out.append(
                f"    pol constC{r} = POSEIDONAFTERPART * {Cst[82 + r]}"
                f" + POSEIDONP * {Cst[36 + r]}"
                f" + (POSEIDONFIRST + POSEIDONCUSTFIRST) * {Cst[12 + r]};"
            )
            sbox(f"a{r}", f"poseidonM{r - 12}", f"constC{r}")
        out.append("")

    for i in range(12):
        terms = " + ".join(f"{Pm[j][i]} * a{j + 12}_R" for j in range(12))
        out.append(f"    POSEIDONP * (a[{i}]' - ({terms})) = 0;")
    for i in range(12):
        terms = " + ".join(f"{M[j][i]} * a{j + 12}_R" for j in range(12))
        out.append(f"    POSEIDONM * (a[{i}]' - ({terms})) = 0;")
    out.append("")

    # two CMul gates per row (x^3 = x + 1 cubic mul)
    def cmul(tag, s):
        out.append(f"    pol cA{tag} = (a[{s}] + a[{s + 1}]) * (a[{s + 3}] + a[{s + 4}]);")
        out.append(f"    pol cB{tag} = (a[{s}] + a[{s + 2}]) * (a[{s + 3}] + a[{s + 5}]);")
        out.append(f"    pol cC{tag} = (a[{s + 1}] + a[{s + 2}]) * (a[{s + 4}] + a[{s + 5}]);")
        out.append(f"    pol cD{tag} = a[{s}]*a[{s + 3}];")
        out.append(f"    pol cE{tag} = a[{s + 1}]*a[{s + 4}];")
        out.append(f"    pol cF{tag} = a[{s + 2}]*a[{s + 5}];")
        out.append(f"    CMUL * (a[{s + 6}] - (cC{tag} + cD{tag} - cE{tag} - cF{tag})) = 0;")
        out.append(f"    CMUL * (a[{s + 7}] - (cA{tag} + cC{tag} - 2*cE{tag} - cD{tag})) = 0;")
        out.append(f"    CMUL * (a[{s + 8}] - (cB{tag} - cD{tag} + cE{tag})) = 0;")

    cmul("1", 0)
    cmul("2", 9)
    out.append("")

    # FFT4 (identical butterfly to C12, wires a[0..11] -> a[0..11]')
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

    # EvPol4 (compressor18.pil.ejs:271-306): Horner in Fp3 at x = a[3..5]',
    # d0 = a[0..2]', d1 = a[9..11], d2 = a[6..8], d3 = a[3..5], d4 = a[0..2],
    # result in a[6..8]'
    def cmuladd(tag, a3, b3, c3):
        lines = [
            f"    pol evA{tag} = ({a3[0]} + {a3[1]}) * ({b3[0]} + {b3[1]});",
            f"    pol evB{tag} = ({a3[0]} + {a3[2]}) * ({b3[0]} + {b3[2]});",
            f"    pol evC{tag} = ({a3[1]} + {a3[2]}) * ({b3[1]} + {b3[2]});",
            f"    pol evD{tag} = {a3[0]} * {b3[0]};",
            f"    pol evE{tag} = {a3[1]} * {b3[1]};",
            f"    pol evF{tag} = {a3[2]} * {b3[2]};",
            f"    pol acc{tag}_0 = evC{tag} + evD{tag} - evE{tag} - evF{tag} + {c3[0]};",
            f"    pol acc{tag}_1 = evA{tag} + evC{tag} - 2*evE{tag} - evD{tag} + {c3[1]};",
            f"    pol acc{tag}_2 = evB{tag} - evD{tag} + evE{tag} + {c3[2]};",
        ]
        return lines, [f"acc{tag}_0", f"acc{tag}_1", f"acc{tag}_2"]

    x3 = ["a[3]'", "a[4]'", "a[5]'"]
    lines, acc = cmuladd("1", ["a[0]'", "a[1]'", "a[2]'"], x3, ["a[9]", "a[10]", "a[11]"])
    out += lines
    lines, acc = cmuladd("2", acc, x3, ["a[6]", "a[7]", "a[8]"])
    out += lines
    lines, acc = cmuladd("3", acc, x3, ["a[3]", "a[4]", "a[5]"])
    out += lines
    lines, acc = cmuladd("4", acc, x3, ["a[0]", "a[1]", "a[2]"])
    out += lines
    for e in range(3):
        out.append(f"    EVPOL4 * (a[{e + 6}]' - {acc[e]}) = 0;")
    out.append("")

    # TreeSelector4: single row — values a[0..11], key a[12..13], out a[14..16]
    out.append("    pol tsb1 = a[12]*(1 - a[12]);")
    out.append("    pol tsb2 = a[13]*(1 - a[13]);")
    out.append("    TREESELECTOR4 * tsb1 = 0;")
    out.append("    TREESELECTOR4 * tsb2 = 0;")
    keys = ["(1 - a[12])*(1 - a[13])", "(a[12])*(1 - a[13])",
            "(1 - a[12])*(a[13])", "(a[12])*(a[13])"]
    for ki, kexpr in enumerate(keys):
        out.append(f"    pol tsk{ki} = {kexpr};")
        for e in range(3):
            out.append(
                f"    pol tsv{ki}_{e} = tsk{ki} * (a[{3 * ki + e}] - a[{e + 14}]);"
            )
            out.append(f"    TREESELECTOR4 * tsv{ki}_{e} = 0;")
    out.append("")

    a_list = ",".join(f"a[{i}]" for i in range(N_COLS))
    s_list = ",".join(f"S[{i}]" for i in range(N_COLS))
    out.append(f"    {{ {a_list} }} connect {{ {s_list} }};")
    out.append("")
    return "\n".join(out)


# ---------------------------------------------------------------------------
# row counting (compressor_constraints.js, cols === 18 branch)


def _count_plonk_halfs(plonk_constraints):
    counts = {}
    for c in plonk_constraints:
        k = ",".join(format(x % P, "x") for x in c[3:8])
        counts[k] = counts.get(k, 0) + 1
    return sum((c + 1) // 2 for c in counts.values())


class _Const:
    def __init__(self, n, n_public_rows):
        self.N = n
        z = lambda: np.zeros(n, dtype=np.uint64)
        self.sel = {k: z() for k in _SELECTORS}
        self.C = [z() for _ in range(18)]
        self.S = [z() for _ in range(N_COLS)]
        self.L = [z() for _ in range(n_public_rows)]


def setup(r1cs, options=None):
    """Same contract as compressor12.setup, 18-column layout."""
    options = options or {}
    Cst, SS, M, Pm = _load_poseidon_c_s()

    plonk_in = [
        (a, b, {s: (P - v) % P for s, v in c.items()}) for a, b, c in r1cs.constraints
    ]
    plonk_constraints, plonk_additions, _ = r2p.r1cs2plonk(P, plonk_in, r1cs.n_vars)

    gates_by_id = {i: g for i, g in enumerate(r1cs.custom_gates)}
    n_publics = r1cs.n_outputs + r1cs.n_pub_inputs
    n_public_rows = (n_publics + 11) // 12

    counts = {"Poseidon12": 0, "CustPoseidon12": 0, "CMul": 0, "FFT4": 0,
              "EvPol4": 0, "TreeSelector4": 0}
    for u in r1cs.custom_uses:
        counts[gates_by_id[u["id"]]["template"]] += 1

    n_partial_custom = (
        n_public_rows
        + 6 * (counts["Poseidon12"] + counts["CustPoseidon12"])
        + 2 * counts["FFT4"]
        + 2 * counts["EvPol4"]
    )
    halfs = _count_plonk_halfs(plonk_constraints)
    n_rows_plonk = 0 if n_partial_custom >= halfs else (
        (halfs - n_partial_custom + 2) // 3
    )
    n_used = (
        n_partial_custom + n_rows_plonk + (counts["CMul"] + 1) // 2
        + counts["TreeSelector4"]
    )
    n_bits = max((max(n_used, 2) - 1).bit_length(), 2)
    if options.get("forceNBits"):
        if options["forceNBits"] < n_bits:
            raise ValueError("forceNBits is less than required")
        n_bits = options["forceNBits"]
    n = 1 << n_bits

    pil_src = _pil_source(n_bits, n_publics)
    pil = pil1_parser.compile_pil_source(pil_src)
    pil["name"] = "Compressor"

    cp = _Const(n, n_public_rows)
    s_map = [np.zeros(n, dtype=np.uint32) for _ in range(N_COLS)]

    extra_rows = []  # rows with free a[12..17] + C[12..16] (GATE2 slots)

    # ---- public rows
    for i in range(n_public_rows):
        for k in range(12):
            n_pub = 12 * i + k
            s_map[k][i] = 1 + n_pub if n_pub < n_publics else 0
        extra_rows.append(i)
    r = n_public_rows

    partial_row_cmul = -1

    # ---- custom gate rows (compressor18_setup.js:106-378)
    for u in r1cs.custom_uses:
        g = gates_by_id[u["id"]]
        t = g["template"]
        sig = u["signals"]
        if t in ("Poseidon12", "CustPoseidon12"):
            cust = t == "CustPoseidon12"
            assert len(sig) == (9 + 10 * 12 if cust else 11 * 12)
            cc = 12
            sp = 0
            for i in range(6):
                for j in range(12):
                    if cust and i == 0 and j >= 9:
                        s_map[j][r + i] = 0
                    else:
                        s_map[j][r + i] = sig[sp]
                        sp += 1
                    # rows 2 (all partials, constants in the PIL) and 5
                    # (output) carry no column constants
                    cp.C[j][r + i] = 0 if i in (2, 5) else Cst[cc]
                    if i not in (2, 5):
                        cc += 1
                sp += 12  # skip the odd intermediate states
                if i in (0, 1, 3, 4):
                    cc += 12
                elif i == 2:
                    cc += 22
                cp.sel["POSEIDONM"][r + i] = 1 if i in (0, 3, 4) else 0
                cp.sel["POSEIDONP"][r + i] = 1 if i == 1 else 0
                cp.sel["POSEIDONFIRST"][r + i] = 1 if (i == 0 and not cust) else 0
                cp.sel["POSEIDONCUSTFIRST"][r + i] = 1 if (i == 0 and cust) else 0
                cp.sel["PARTIALROUND"][r + i] = 1 if i == 2 else 0
                cp.sel["POSEIDONAFTERPART"][r + i] = 1 if i == 3 else 0
                extra_rows.append(r + i)
            r += 6
        elif t == "CMul":
            assert len(sig) == 9
            if partial_row_cmul != -1:
                for i in range(9):
                    s_map[i + 9][partial_row_cmul] = sig[i]
                partial_row_cmul = -1
            else:
                for i in range(9):
                    s_map[i][r] = sig[i]
                cp.sel["CMUL"][r] = 1
                partial_row_cmul = r
                r += 1
        elif t == "FFT4":
            assert len(sig) == 24
            for i in range(12):
                s_map[i][r] = sig[i]
                s_map[i][r + 1] = sig[12 + i]
            cp.sel["FFT4"][r] = 1
            ftype, scale, first_w, inc_w = (
                int(g["parameters"][0]), int(g["parameters"][1]),
                int(g["parameters"][2]), int(g["parameters"][3]),
            )
            _fill_fft4_consts(cp, r, ftype, scale, first_w, inc_w)
            extra_rows.append(r)
            extra_rows.append(r + 1)
            r += 2
        elif t == "EvPol4":
            assert len(sig) == 21
            for i in range(12):
                s_map[i][r] = sig[i]
                s_map[i][r + 1] = sig[12 + i] if i < 9 else 0
            cp.sel["EVPOL4"][r] = 1
            extra_rows.append(r)
            extra_rows.append(r + 1)
            r += 2
        elif t == "TreeSelector4":
            assert len(sig) == 17
            for i in range(17):
                s_map[i][r] = sig[i]
            cp.sel["TREESELECTOR4"][r] = 1
            r += 1
        else:
            raise ValueError(f"unknown custom gate {t}")

    # ---- plonk constraint packing (compressor18_setup.js:380-500)
    partial_rows = {}
    half_rows = []
    for c in plonk_constraints:
        k = ",".join(format(x % P, "x") for x in c[3:8])
        if k in partial_rows:
            pr = partial_rows.pop(k)
            for e in range(3):
                s_map[pr["nUsed"] * 3 + e][pr["row"]] = c[e]
        elif half_rows:
            pr = half_rows.pop(0)
            if pr["nUsed"] == 2:
                for e in range(5):
                    cp.C[6 + e][pr["row"]] = c[3 + e] % P
                for e in range(3):
                    s_map[6 + e][pr["row"]] = c[e]
            else:
                assert pr["nUsed"] == 4
                cp.sel["GATE2"][pr["row"]] = 1
                for e in range(5):
                    cp.C[12 + e][pr["row"]] = c[3 + e] % P
                for e in range(3):
                    s_map[12 + e][pr["row"]] = c[e]
            pr["nUsed"] += 1
            partial_rows[k] = pr
        elif extra_rows:
            row = extra_rows.pop(0)
            cp.sel["GATE2"][row] = 1
            for e in range(5):
                cp.C[12 + e][row] = c[3 + e] % P
            for e in range(3):
                s_map[12 + e][row] = c[e]
            partial_rows[k] = {"row": row, "nUsed": 5}
        else:
            for e in range(5):
                cp.C[e][r] = c[3 + e] % P
            cp.sel["GATE"][r] = 1
            for e in range(3):
                s_map[e][r] = c[e]
            partial_rows[k] = {"row": r, "nUsed": 1}
            half_rows.append({"row": r, "nUsed": 2})
            half_rows.append({"row": r, "nUsed": 4})
            r += 1

    # close half-used subsets by duplicating the satisfied wire set
    for pr in partial_rows.values():
        base = {1: 0, 3: 6, 5: 12}[pr["nUsed"]]
        for e in range(3):
            s_map[base + 3 + e][pr["row"]] = s_map[base + e][pr["row"]]

    assert r <= n, f"layout used {r} rows > N={n}"

    # ---- S (connection) polynomials
    ks = get_ks(N_COLS - 1)
    w_pows = gl64.powers(gl64.w(n_bits), n)
    cp.S[0][:] = w_pows
    for j in range(1, N_COLS):
        cp.S[j][:] = gl64.mul(w_pows, np.uint64(ks[j - 1]))

    last_signal = {}
    for i in range(r):
        for j in range(N_COLS):
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


def _fill_fft4_consts(cp, r, ftype, scale, first_w, inc_w):
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
        elif ref.get("isArray"):
            arrs = cp.S if short == "S" else cp.C
            for j in range(ref["len"]):
                cols.append(arrs[j])
        elif short in cp.sel:
            cols.append(cp.sel[short])
        else:
            raise KeyError(name)
    return np.ascontiguousarray(np.stack(cols, axis=1))


# ---------------------------------------------------------------------------
# exec — identical scatter semantics, 18 columns


def exec_witness(witness, plonk_additions, s_map, n_bits):
    w = [int(x) for x in witness]
    for sl, sr, kl, kr in plonk_additions:
        w.append((w[sl] * kl + w[sr] * kr) % P)
    n = 1 << n_bits
    cm = np.zeros((n, N_COLS), dtype=np.uint64)
    warr = np.array(w, dtype=np.uint64)
    for j in range(N_COLS):
        idx = np.asarray(s_map[j], dtype=np.int64)
        vals = warr[idx]
        vals[idx == 0] = 0
        cm[:, j] = vals
    return cm
