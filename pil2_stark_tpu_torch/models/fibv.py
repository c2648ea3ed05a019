"""fibv: a two-subproof vadcop machine (Module + Fibonacci) whose mod
reductions are delegated from the Fibonacci air to the Module air through a
log-up (gsum) argument, with the global constraint
gsum_fibonacci + gsum_module === 0 over the two subproof values.

Copy of pil2_stark_tpu/models/fibv.py: ``build_pilout`` (:187) builds the
machine as a synthetic pilout for compiler.pil2_frontend, ``execute``
(:259) its witness.  The two airs' setups and the global constraint's code
are committed as setups/fibv_module.json, setups/fibv_fibonacci.json and
setups/fibv_global.json.

Layout per subproof:
  Module (subproof 0, N rows):   witness x, q, x_mod; stage-2 gsum;
      x === q*mod + x_mod;   dG*D' - 1 === 0 with D' = (x_mod*a + x)*a + 1 + b
  Fibonacci (subproof 1, N rows): witness a, b; stage-2 gsum;
      (b' - a)(1 - L1') === 0;  b|0 = in1;  a|0 = in2;
      dG*D + 1 === 0 with D = ((L1'*out + (1-L1')*a')*a + a^2 + b^2)*a + 1 + b
  where dG = gsum - 'gsum*(1-L1) and both gsums bind to subproof values at
  the last row.  Publics: mod, in1, in2, out.
"""
from __future__ import annotations

import numpy as np

from ..field import gl64

P = gl64.P_INT
N_BITS = 4
N = 1 << N_BITS
MODULE_ID = 1


def _be(v: int) -> bytes:
    v = int(v) % P
    return v.to_bytes((v.bit_length() + 7) // 8 or 1, "big")


def _c(v):
    return {"constant": {"value": _be(v)}}


def _w(col, off=0, stage=1):
    return {"witnessCol": {"stage": stage, "colIdx": col, "rowOffset": off}}


def _fx(idx, off=0):
    return {"fixedCol": {"idx": idx, "rowOffset": off}}


def _pub(idx):
    return {"publicValue": {"idx": idx}}


def _ch(idx):
    return {"challenge": {"stage": 2, "idx": idx}}


def _sv(idx):
    return {"subproofValue": {"idx": idx}}


def _e(idx):
    return {"expression": {"idx": idx}}


class _ExprList:
    def __init__(self):
        self.exprs = []

    def add(self, lhs, rhs):
        self.exprs.append({"add": {"lhs": lhs, "rhs": rhs}})
        return _e(len(self.exprs) - 1)

    def sub(self, lhs, rhs):
        self.exprs.append({"sub": {"lhs": lhs, "rhs": rhs}})
        return _e(len(self.exprs) - 1)

    def mul(self, lhs, rhs):
        self.exprs.append({"mul": {"lhs": lhs, "rhs": rhs}})
        return _e(len(self.exprs) - 1)


def _module_air():
    E = _ExprList()
    x, q, xm = _w(0), _w(1), _w(2)
    gsum, gsum_p = _w(0, 0, 2), _w(0, -1, 2)
    alpha, beta = _ch(0), _ch(1)
    l1 = _fx(0)

    qm = E.mul(q, _pub(0))
    rhs = E.add(qm, xm)
    c_div = E.sub(x, rhs)  # everyRow: x - (q*mod + x_mod)

    d1 = E.mul(xm, alpha)
    d2 = E.add(d1, x)
    d3 = E.mul(d2, alpha)
    d4 = E.add(d3, _c(MODULE_ID))
    den = E.add(d4, beta)  # D'

    one_m_l1 = E.sub(_c(1), l1)
    prev = E.mul(gsum_p, one_m_l1)
    dg = E.sub(gsum, prev)
    prod = E.mul(dg, den)
    c_gsum = E.sub(prod, _c(1))  # everyRow: dG*D' - 1

    c_last = E.sub(gsum, _sv(0))  # lastRow: gsum - gsum_module

    return {
        "name": "Module",
        "numRows": N,
        "fixedCols": [{"values": [_be(1)] + [_be(0)] * (N - 1)}],
        "periodicCols": [],
        "stageWidths": [3, 1],
        "expressions": E.exprs,
        "constraints": [
            {"everyRow": {"expressionIdx": c_div["expression"],
                          "debugLine": "fibv: x === q*mod + x_mod"}},
            {"everyRow": {"expressionIdx": c_gsum["expression"],
                          "debugLine": "fibv: module gsum step"}},
            {"lastRow": {"expressionIdx": c_last["expression"],
                         "debugLine": "fibv: gsum === gsum_module"}},
        ],
    }, den


def _fib_air():
    E = _ExprList()
    a, b = _w(0), _w(1)
    a_n, b_n = _w(0, 1), _w(1, 1)
    gsum, gsum_p = _w(0, 0, 2), _w(0, -1, 2)
    alpha, beta = _ch(0), _ch(1)
    l1, l1_n = _fx(0), _fx(0, 1)

    step = E.sub(b_n, a)
    gate = E.sub(_c(1), l1_n)
    c_chain = E.mul(step, gate)  # everyRow: (b' - a)(1 - L1')

    c_in1 = E.sub(b, _pub(1))  # firstRow
    c_in2 = E.sub(a, _pub(2))  # firstRow

    sel1 = E.mul(l1_n, _pub(3))       # L1'*out
    sel2 = E.mul(gate, a_n)           # (1-L1')*a'
    sel = E.add(sel1, sel2)
    s1 = E.mul(sel, alpha)
    aa = E.mul(a, a)
    bb = E.mul(b, b)
    xx = E.add(aa, bb)
    s2 = E.add(s1, xx)
    s3 = E.mul(s2, alpha)
    s4 = E.add(s3, _c(MODULE_ID))
    den = E.add(s4, beta)  # D

    one_m_l1 = E.sub(_c(1), l1)
    prev = E.mul(gsum_p, one_m_l1)
    dg = E.sub(gsum, prev)
    prod = E.mul(dg, den)
    c_gsum = E.add(prod, _c(1))  # everyRow: dG*D + 1

    c_last = E.sub(gsum, _sv(0))  # lastRow

    return {
        "name": "Fibonacci",
        "numRows": N,
        "fixedCols": [{"values": [_be(1)] + [_be(0)] * (N - 1)}],
        "periodicCols": [],
        "stageWidths": [2, 1],
        "expressions": E.exprs,
        "constraints": [
            {"everyRow": {"expressionIdx": c_chain["expression"],
                          "debugLine": "fibv: b' === a"}},
            {"firstRow": {"expressionIdx": c_in1["expression"],
                          "debugLine": "fibv: b|0 === in1"}},
            {"firstRow": {"expressionIdx": c_in2["expression"],
                          "debugLine": "fibv: a|0 === in2"}},
            {"everyRow": {"expressionIdx": c_gsum["expression"],
                          "debugLine": "fibv: fibonacci gsum step"}},
            {"lastRow": {"expressionIdx": c_last["expression"],
                         "debugLine": "fibv: gsum === gsum_fibonacci"}},
        ],
    }, den


def build_pilout() -> dict:
    module_air, mod_den = _module_air()
    fib_air, fib_den = _fib_air()

    def gsum_hint(sub_id, numerator, den_ref):
        return {
            "name": "gsum", "subproofId": sub_id, "airId": 0,
            "fields": [
                {"name": "reference", "operand": _w(0, 0, 2)},
                {"name": "numerator", "operand": _c(numerator)},
                {"name": "denominator", "operand": den_ref},
            ],
        }

    def sv_hint(sub_id):
        return {
            "name": "subproofvalue", "subproofId": sub_id, "airId": 0,
            "fields": [
                {"name": "reference", "operand": _sv(0)},
                {"name": "expression", "operand": _w(0, 0, 2)},
                {"name": "row_index", "operand": _c(N - 1)},
            ],
        }

    symbols = [
        {"name": "Module.x", "subproofId": 0, "airId": 0, "type": 3, "id": 0, "stage": 1},
        {"name": "Module.q", "subproofId": 0, "airId": 0, "type": 3, "id": 1, "stage": 1},
        {"name": "Module.x_mod", "subproofId": 0, "airId": 0, "type": 3, "id": 2, "stage": 1},
        {"name": "Module.gsum", "subproofId": 0, "airId": 0, "type": 3, "id": 3, "stage": 2},
        {"name": "Module.L1", "subproofId": 0, "airId": 0, "type": 1, "id": 0, "stage": 0},
        {"name": "Fibonacci.a", "subproofId": 1, "airId": 0, "type": 3, "id": 0, "stage": 1},
        {"name": "Fibonacci.b", "subproofId": 1, "airId": 0, "type": 3, "id": 1, "stage": 1},
        {"name": "Fibonacci.gsum", "subproofId": 1, "airId": 0, "type": 3, "id": 2, "stage": 2},
        {"name": "Fibonacci.L1", "subproofId": 1, "airId": 0, "type": 1, "id": 0, "stage": 0},
        {"name": "std_alpha", "type": 8, "id": 0, "stage": 2},
        {"name": "std_beta", "type": 8, "id": 1, "stage": 2},
        {"name": "mod", "type": 6, "id": 0, "stage": 0},
        {"name": "in1", "type": 6, "id": 1, "stage": 0},
        {"name": "in2", "type": 6, "id": 2, "stage": 0},
        {"name": "out", "type": 6, "id": 3, "stage": 0},
        {"name": "gsum_module", "subproofId": 0, "type": 5, "id": 0, "stage": 0},
        {"name": "gsum_fibonacci", "subproofId": 1, "type": 5, "id": 0, "stage": 0},
    ]

    return {
        "name": "fibv",
        "baseField": P,
        "numChallenges": [0, 2],
        "numPublicValues": 4,
        "subproofs": [
            {"name": "Module", "aggregationTypes": [0], "airs": [module_air]},
            {"name": "Fibonacci", "aggregationTypes": [0], "airs": [fib_air]},
        ],
        # vadcop global constraint over the two subproof values
        "expressions": [
            {"add": {"lhs": {"subproofValue": {"subproofId": 1, "idx": 0}},
                     "rhs": {"subproofValue": {"subproofId": 0, "idx": 0}}}},
        ],
        "constraints": [
            {"expressionIdx": {"idx": 0},
             "debugLine": "fibv: gsum_fibonacci+gsum_module === 0"},
        ],
        "hints": [
            gsum_hint(0, 1, mod_den),
            sv_hint(0),
            gsum_hint(1, P - 1, fib_den),
            sv_hint(1),
        ],
        "symbols": symbols,
    }


def execute(mod: int, in1: int, in2: int):
    """Consistent stage-1 witnesses of both subproofs and the publics.

    Returns (cm_module (N, 3), cm_fib (N, 2), publics [mod, in1, in2, out]).
    The fibonacci chain sends one (x = a^2 + b^2, x mod m) pair per row to
    the Module air (1:1, so the log-up sums cancel exactly)."""
    a = [0] * (N + 1)
    b = [0] * (N + 1)
    b[0], a[0] = in1, in2
    xs = []
    for i in range(N):
        x = (a[i] * a[i] + b[i] * b[i]) % P
        xs.append(x)
        a[i + 1] = x % mod
        b[i + 1] = a[i]
    out = a[N]

    cm_mod = np.zeros((N, 3), dtype=np.uint64)
    cm_mod[:, 0] = xs
    cm_mod[:, 1] = [x // mod for x in xs]
    cm_mod[:, 2] = [x % mod for x in xs]

    cm_fib = np.zeros((N, 2), dtype=np.uint64)
    cm_fib[:, 0] = a[:N]
    cm_fib[:, 1] = b[:N]
    return cm_mod, cm_fib, [mod, in1, in2, out]


STARK_STRUCT = {
    "nBits": N_BITS,
    "nBitsExt": N_BITS + 1,
    "nQueries": 8,
    "verificationHashType": "GL",
    "steps": [{"nBits": N_BITS + 1}, {"nBits": 2}],
}
