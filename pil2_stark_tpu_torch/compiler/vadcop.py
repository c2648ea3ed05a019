"""Vadcop aggregation circuit layer: the verification-key mux and the
two-proof aggregation circuit that make recursive1/recursive2 proof
aggregation possible.

Counterpart of pil2-stark-js circuits.gl/vadcop.circom (:7-50
SelectVerificationKey, :63-103 AggregateValues, :105-127
AggregateSubproofValues) plus the aggregation wiring the reference enables
through the verifier-template options verkeyInput / enableInput
(stark_verifier.circom.ejs:713-786): an Aggregate2 main instantiates two
StarkVerifier components whose verification keys are selected at run time
by circuit type, gated by enable so a null slot (circuitType 0) verifies
nothing — the shape of the recursive2 tier of the proof-composition chain.

All circuit text is generated (no reference files copied); gadget
dependencies ride the in-repo gadget library (compiler.circom_gadgets).
"""
from __future__ import annotations

from . import circom_gadgets
from . import pil2circom as p2c


def emit_vadcop() -> str:
    """vadcop.circom: IsZero + SelectVerificationKey + the value/subproof
    aggregators (reference vadcop.circom semantics, muxes inlined)."""
    return """pragma circom 2.1.0;
pragma custom_templates;

include "poseidon.circom";

template IsZero() {
    signal input in;
    signal output out;
    signal inv;
    inv <-- in != 0 ? 1 / in : 0;
    out <== -in*inv + 1;
    in*out === 0;
}

// Given a circuit type, return the corresponding verification key
// (vadcop.circom:7-50):
//   0 -> null (all-zero key), 1 -> recursive2, 2.. -> recursive1 keys
template SelectVerificationKey(nRecursives1) {
    signal input circuitType;
    signal input rootCRecursive2[4];
    signal input rootCRecursives1[nRecursives1][4];
    signal output verificationKey[4];

    signal isType[nRecursives1 + 2];
    var isValidType = 0;
    for (var i = 0; i < nRecursives1 + 2; i++) {
        isType[i] <== IsZero()(i - circuitType);
        isValidType += isType[i];
    }
    // the type must be one of the supported ones
    isValidType === 1;

    signal verificationKeys[nRecursives1 + 2][4];
    verificationKeys[0] <== [0, 0, 0, 0];
    verificationKeys[1] <== rootCRecursive2;
    for (var i = 0; i < nRecursives1; i++) {
        verificationKeys[i + 2] <== rootCRecursives1[i];
    }

    signal accVK[nRecursives1 + 2][4];
    for (var i = 0; i < nRecursives1 + 2; i++) {
        for (var j = 0; j < 4; j++) {
            if (i == 0) {
                accVK[i][j] <== isType[i]*verificationKeys[i][j];
            } else {
                accVK[i][j] <== isType[i]*verificationKeys[i][j] + accVK[i - 1][j];
            }
        }
    }
    verificationKey <== accVK[nRecursives1 + 1];
}

// Merge two 4-element commitments: null/zero slots pass the other side
// through; two live values hash together (vadcop.circom:63-103)
template AggregateValues() {
    signal input valueA[4];
    signal input valueB[4];
    signal input isNullA;
    signal input isNullB;
    signal output valueAB[4];

    signal hash[4] <== Poseidon(4)([valueA[0], valueA[1], valueA[2], valueA[3],
                                    valueB[0], valueB[1], valueB[2], valueB[3]],
                                   [0, 0, 0, 0]);

    signal azero[4];
    signal bzero[4];
    for (var k = 0; k < 4; k++) {
        azero[k] <== IsZero()(valueA[k]);
        bzero[k] <== IsZero()(valueB[k]);
    }
    signal isValueAZero <== IsZero()(4 - (azero[0] + azero[1] + azero[2] + azero[3]));
    signal isValueBZero <== IsZero()(4 - (bzero[0] + bzero[1] + bzero[2] + bzero[3]));

    signal liveA <== (1 - isNullA) * (1 - isValueAZero);
    signal liveB <== (1 - isNullB) * (1 - isValueBZero);
    signal both <== liveA * liveB;

    // both -> hash; only A -> valueA; only B -> valueB; neither -> 0
    signal hA[4];
    signal hB[4];
    for (var k = 0; k < 4; k++) {
        hA[k] <== (liveA - both) * valueA[k];
        hB[k] <== (liveB - both) * valueB[k];
        valueAB[k] <== both * hash[k] + hA[k] + hB[k];
    }
}

// Aggregate one cubic-extension subproof value: sum (aggregationType 0)
// or product (aggregationType 1) over the live sides (vadcop.circom:105-127)
template AggregateSubproofValues() {
    signal input subproofValueA[3];
    signal input subproofValueB[3];
    signal input isNullA;
    signal input isNullB;
    signal input aggregationType;
    signal output subproofValueAB[3];

    signal valueA[3];
    signal valueB[3];
    for (var k = 0; k < 3; k++) {
        valueA[k] <== (1 - isNullA) * subproofValueA[k];
        valueB[k] <== (1 - isNullB) * subproofValueB[k];
    }
    signal sum[3];
    signal prod[3];
    for (var k = 0; k < 3; k++) {
        sum[k] <== valueA[k] + valueB[k];
        prod[k] <== valueA[k] * valueB[k];
        subproofValueAB[k] <== aggregationType * (prod[k] - sum[k]) + sum[k];
    }
}
"""


def _verifier_inputs(stark_info):
    """Every StarkVerifier input signal (name, dims tuple) in declaration
    order under {verkeyInput: True, enableInput: True} — mirrors
    gen_stark_verifier's signature so the Aggregate2 wiring can't drift."""
    si = stark_info
    ss = si["starkStruct"]
    steps = ss["steps"]
    nq = ss["nQueries"]
    ext_bits = steps[0]["nBits"]
    sigs = [("publics", (si["nPublics"],))]
    if si.get("nSubproofValues"):
        sigs.append(("subproofValues", (si["nSubproofValues"], 3)))
    widths = []
    for i in range(si["nStages"] + 1):
        widths.append((i + 1, si["mapSectionsN"][f"cm{i + 1}"]))
    for tree_i, _ in widths:
        sigs.append((f"root{tree_i}", (4,)))
    sigs.append(("rootC", (4,)))
    sigs.append(("evals", (len(si["evMap"]), 3)))
    for tree_i, w in widths:
        if w:
            sigs.append((f"s0_vals{tree_i}", (nq, w)))
    sigs.append(("s0_valsC", (nq, si["nConstants"])))
    for tree_i, w in widths:
        if w:
            sigs.append((f"s0_siblings{tree_i}", (nq, ext_bits, 4)))
    sigs.append(("s0_siblingsC", (nq, ext_bits, 4)))
    for s in range(1, len(steps)):
        sigs.append((f"s{s}_root", (4,)))
    for s in range(1, len(steps)):
        group = 1 << (steps[s - 1]["nBits"] - steps[s]["nBits"])
        sigs.append((f"s{s}_vals", (nq, group * 3)))
        sigs.append((f"s{s}_siblings", (nq, steps[s]["nBits"], 4)))
    sigs.append(("finalPol", (1 << steps[-1]["nBits"], 3)))
    sigs.append(("enable", ()))
    return sigs


def gen_aggregate2(stark_info, n_recursives1: int, agg_types=None) -> str:
    """The two-proof aggregation main template: select each slot's
    verification key by circuit type, verify both proofs inside one
    circuit (enable-gated so null slots are free), pass both public sets
    through and aggregate the subproof values."""
    si = stark_info
    n_publics = si["nPublics"]
    n_subproof = si.get("nSubproofValues", 0)
    agg_types = list(agg_types or [0] * n_subproof)
    sigs = [(n, d) for n, d in _verifier_inputs(si)
            if n not in ("rootC", "enable")]

    def dims(d):
        return "".join(f"[{x}]" for x in d)

    lines = ["template Aggregate2() {"]
    for side in ("a", "b"):
        lines.append(f"    signal input {side}_circuitType;")
        for name, d in sigs:
            lines.append(f"    signal input {side}_{name}{dims(d)};")
    lines.append("    signal input rootCRecursive2[4];")
    lines.append(
        f"    signal input rootCRecursives1[{n_recursives1}][4];"
    )
    lines.append(f"    signal output publics[{2 * n_publics}];")
    if n_subproof:
        lines.append(f"    signal output subproofValues[{n_subproof}][3];")
    lines.append("")
    for side in ("a", "b"):
        lines.append(
            f"    signal {side}_rootC[4] <== SelectVerificationKey({n_recursives1})"
            f"({side}_circuitType, rootCRecursive2, rootCRecursives1);"
        )
        lines.append(
            f"    signal {side}_isNull <== IsZero()({side}_circuitType);"
        )
    lines.append("")
    for side in ("a", "b"):
        lines.append(f"    component v_{side} = StarkVerifier0();")
        for name, d in sigs:
            lines.append(f"    v_{side}.{name} <== {side}_{name};")
        lines.append(f"    v_{side}.rootC <== {side}_rootC;")
        lines.append(f"    v_{side}.enable <== 1 - {side}_isNull;")
        lines.append("")
    lines.append(f"    for (var i = 0; i < {n_publics}; i++) {{")
    lines.append("        publics[i] <== a_publics[i];")
    lines.append(f"        publics[{n_publics} + i] <== b_publics[i];")
    lines.append("    }")
    for i in range(n_subproof):
        lines.append(
            f"    subproofValues[{i}] <== AggregateSubproofValues()"
            f"(a_subproofValues[{i}], b_subproofValues[{i}], a_isNull, b_isNull, {int(agg_types[i])});"
        )
    lines.append("}")
    lines.append("")
    lines.append("component main {public [publics]} = Aggregate2();")
    return "\n".join(lines)


def emit_aggregation_files(const_root, stark_info, verifier_info,
                           n_recursives1: int = 1, agg_types=None) -> dict:
    """Full file set for the aggregation circuit: gadget library + the
    enable/verkey-parameterized verifier + vadcop muxes + Aggregate2 main.
    `const_root` is this verifier's own key — the caller passes it again at
    witness time through rootCRecursives1/rootCRecursive2."""
    files = circom_gadgets.emit_gadget_files()
    files["vadcop.circom"] = emit_vadcop()
    files["verifier.circom"] = p2c.pil2circom(
        const_root, stark_info, verifier_info,
        options={"verkeyInput": True, "enableInput": True, "skipMain": True},
    )
    header = "\n".join([
        "pragma circom 2.1.0;",
        "pragma custom_templates;",
        "",
        'include "verifier.circom";',
        'include "vadcop.circom";',
        "",
    ])
    files["aggregate2.circom"] = header + gen_aggregate2(
        stark_info, n_recursives1, agg_types
    )
    return files


def aggregate2_zkin(zkin_a, zkin_b, root_c_recursive2, root_c_recursives1,
                    circuit_type_a=2, circuit_type_b=2) -> dict:
    """Merge two proof zkins (utils.proof2zkin) into the Aggregate2 input
    set (the challenges2zkin-style signal prefixing of proof2zkin.js)."""
    out = {
        "a_circuitType": int(circuit_type_a),
        "b_circuitType": int(circuit_type_b),
        "rootCRecursive2": [int(v) for v in root_c_recursive2],
        "rootCRecursives1": [[int(v) for v in r] for r in root_c_recursives1],
    }
    for side, zkin in (("a", zkin_a), ("b", zkin_b)):
        for k, v in zkin.items():
            out[f"{side}_{k}"] = v
    return out
