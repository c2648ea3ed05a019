"""PIL1 std-lib synthesis: plookup / permutation / connection arguments.

Mirrors pil2-stark-js src/pil_info/helpers/pil1/ (generatePil1Polynomials.js,
generateLibsPolynomials.js, pil1_libs/grandProduct{Plookup,Permutation,
Connection}.js): converts the declarative identities of a PIL1 program into
explicit expressions + committed columns (h1/h2, grand-product z) + hints,
with the standard challenge schedule α,β (stage 2) γ,δ (stage 3).
"""
from __future__ import annotations

import math

from . import east
from .prepare_util import get_exp_dim_lazy

P = 0xFFFFFFFF00000001
K_GEN = 12275445934081160404  # F.k = 7^(2^32), f3g.js:26

# ffjavascript F1Field sets F.k = nqr^(2^s); for BN254-Fr nqr=5, s=28 —
# the same construction GL uses (7^(2^32) above).  Needed by the final
# tier, whose connection argument runs over Fr (final9_setup.js getKs).
FR_P = 21888242871839275222246405745257275088548364400416034343698204186575808495617
FR_K_GEN = pow(5, 2**28, FR_P)


def get_ks(n: int, field: str = "gl"):
    """pilcom getKs: successive powers of F.k (coset labels for connection)."""
    k, p = (K_GEN, P) if field == "gl" else (FR_K_GEN, FR_P)
    ks = [k]
    for _ in range(1, n):
        ks.append((ks[-1] * k) % p)
    return ks


def _log2(n: int) -> int:
    return n.bit_length() - 1


def generate_pil1_polynomials(res, pil, stark, options):
    """generatePil1Polynomials.js:5-64."""
    res["subproofId"] = options.get("subproofId", 0)
    res["airId"] = options.get("airId", 0)
    res["nPublics"] = len(pil["publics"])
    res["nConstants"] = pil["nConstants"]

    first_possible_stage = options.get("firstPossibleStage", False)
    res["nStages"] = (
        2 if first_possible_stage and len(pil["plookupIdentities"]) == 0 else 3
    )

    symbols = []
    hints = []

    for name, pol in pil["references"].items():
        if pol["type"] == "imP":
            continue
        sym_type = "fixed" if pol["type"] == "constP" else "witness"
        stage = 1 if sym_type == "witness" else 0
        if pol.get("isArray"):
            for i in range(pol["len"]):
                symbols.append(
                    {
                        "type": sym_type,
                        "name": name + str(i),
                        "polId": pol["id"] + i,
                        "stage": stage,
                        "dim": 1,
                        "subproofId": res["subproofId"],
                        "airId": res["airId"],
                    }
                )
        else:
            symbols.append(
                {
                    "type": sym_type,
                    "name": name,
                    "polId": pol["id"],
                    "stage": stage,
                    "dim": 1,
                    "subproofId": res["subproofId"],
                    "airId": res["airId"],
                }
            )

    generate_libs_polynomials(
        res, pil, symbols, hints, stark, first_possible_stage,
        field=options.get("field", "gl"),
    )

    res["nCommitments"] = pil["nCommitments"]
    res["pilPower"] = _log2(next(iter(pil["references"].values()))["polDeg"])

    expressions = list(pil["expressions"])
    constraints = list(pil["polIdentities"])
    for c in constraints:
        if not c.get("boundary"):
            c["boundary"] = "everyRow"

    for i in range(res["nPublics"]):
        symbols.append({"type": "public", "stage": 1, "id": i})

    return {
        "symbols": symbols,
        "hints": hints,
        "expressions": expressions,
        "constraints": constraints,
    }


def generate_libs_polynomials(res, pil, symbols, hints, stark,
                              first_possible_stage, field="gl"):
    """generateLibsPolynomials.js:6-44 + challenge id assignment :46-59."""
    pil["nCm2"] = 0
    pil["nCm3"] = 0
    libs = []
    dim = 3 if stark else 1

    if pil["plookupIdentities"]:
        libs.append(lambda: grand_product_plookup(pil, symbols, hints, res, stark))
        _merge_challenges(
            symbols,
            [
                {"name": "std_alpha", "stage": 2, "dim": dim, "stageId": 0},
                {"name": "std_beta", "stage": 2, "dim": dim, "stageId": 1},
                {"name": "std_gamma", "stage": 3, "dim": dim, "stageId": 0},
                {"name": "std_delta", "stage": 3, "dim": dim, "stageId": 1},
            ],
        )
    if pil["permutationIdentities"]:
        stage = 2 if first_possible_stage else 3
        libs.append(
            lambda: grand_product_permutation(
                pil, symbols, hints, res, stark, first_possible_stage
            )
        )
        _merge_challenges(
            symbols,
            [
                {"name": "std_alpha", "stage": stage, "dim": dim, "stageId": 0},
                {"name": "std_beta", "stage": stage, "dim": dim, "stageId": 1},
                {"name": "std_gamma", "stage": stage, "dim": dim, "stageId": 2},
            ],
        )
    if pil["connectionIdentities"]:
        stage = 2 if first_possible_stage else 3
        libs.append(
            lambda: grand_product_connection(
                pil, symbols, hints, res, stark, first_possible_stage,
                field=field,
            )
        )
        _merge_challenges(
            symbols,
            [
                {"name": "std_gamma", "stage": stage, "dim": dim, "stageId": 0},
                {"name": "std_delta", "stage": stage, "dim": dim, "stageId": 1},
            ],
        )

    for lib in libs:
        lib()


def _merge_challenges(symbols, challenges):
    for ch in challenges:
        if not any(
            s["type"] == "challenge"
            and s["stage"] == ch["stage"]
            and s["stageId"] == ch["stageId"]
            for s in symbols
        ):
            symbols.append({"type": "challenge", **ch})
    chs = [s for s in symbols if s["type"] == "challenge"]
    for ch in chs:
        ch["id"] = sum(
            1
            for c in chs
            if c["stage"] < ch["stage"]
            or (c["stage"] == ch["stage"] and c["stageId"] < ch["stageId"])
        )


def _challenge_node(symbols, name=None, stage=None, stage_id=None):
    if name is not None:
        sym = next(s for s in symbols if s["type"] == "challenge" and s["name"] == name)
    else:
        sym = next(
            s
            for s in symbols
            if s["type"] == "challenge" and s["stage"] == stage and s["stageId"] == stage_id
        )
    return east.challenge(sym["name"], sym["stage"], sym["dim"], sym["stageId"], sym["id"])


def _fold_alpha(ids, alpha, stage, t_side):
    """Random linear fold of a tuple of expressions with challenge alpha.

    t side: t_j folds as alpha*acc + e; f side as acc*alpha + e — matching
    the operand order in grandProductPlookup.js:49-87 (the products commute
    but the AST shape affects codegen parity).
    """
    acc = None
    for eid in ids:
        e = east.exp(eid, 0, stage)
        if acc is None:
            acc = e
        elif t_side:
            acc = east.add(east.mul(alpha, acc), e)
        else:
            acc = east.add(east.mul(acc, alpha), e)
    return acc


def _push_exp(pil, node, stage, stark, keep=False):
    eid = len(pil["expressions"])
    if keep:
        node["keep"] = True
    node["stage"] = stage
    pil["expressions"].append(node)
    dim = get_exp_dim_lazy(pil["expressions"], eid, stark)
    pil["expressions"][eid]["dim"] = dim
    return eid, dim


def _push_constraint(pil, node, stark, stage=None):
    node["deg"] = 2
    if stage is not None:
        node["stage"] = stage
    pil["expressions"].append(node)
    cid = len(pil["expressions"]) - 1
    pil["polIdentities"].append({"e": cid, "boundary": "everyRow"})
    pil["expressions"][cid]["dim"] = get_exp_dim_lazy(pil["expressions"], cid, stark)
    return cid


def _l1_node(pil):
    if "Global.L1" not in pil["references"]:
        raise ValueError("Global.L1 must be defined")
    return east.const(pil["references"]["Global.L1"]["id"], 0, 0, 1)


def grand_product_plookup(pil, symbols, hints, res, stark):
    """grandProductPlookup.js:18-205."""
    stage1, stage2 = 2, 3
    dim = 3 if stark else 1
    alpha = _challenge_node(symbols, "std_alpha")
    beta = _challenge_node(symbols, "std_beta")
    gamma = _challenge_node(symbols, "std_gamma")
    delta = _challenge_node(symbols, "std_delta")

    for i, pi in enumerate(pil["plookupIdentities"]):
        t_exp = _fold_alpha(pi["t"], alpha, stage1, t_side=True)
        if pi["selT"] is not None:
            t_exp = east.sub(t_exp, beta)
            t_exp = east.mul(t_exp, east.exp(pi["selT"], 0, stage1))
            t_exp = east.add(t_exp, beta)
        t_exp_id, t_dim = _push_exp(pil, t_exp, stage1, stark, keep=True)

        f_exp = _fold_alpha(pi["f"], alpha, stage1, t_side=False)
        if pi["selF"] is not None:
            f_exp = east.sub(f_exp, east.exp(t_exp_id, 0, stage1))
            f_exp = east.mul(f_exp, east.exp(pi["selF"], 0, stage1))
            f_exp = east.add(f_exp, east.exp(t_exp_id, 0, stage1))
        f_exp_id, f_dim = _push_exp(pil, f_exp, stage1, stark, keep=True)

        h1_id = pil["nCommitments"]
        h2_id = pil["nCommitments"] + 1
        z_id = pil["nCommitments"] + 2
        pil["nCommitments"] += 3

        h_dim = max(f_dim, t_dim)
        h1 = east.cm(h1_id, 0, stage1, h_dim)
        h1p = east.cm(h1_id, 1, stage1, h_dim)
        h2 = east.cm(h2_id, 0, stage1, h_dim)
        f = east.exp(f_exp_id, 0, stage1)
        t = east.exp(t_exp_id, 0, stage1)
        tp = east.exp(t_exp_id, 1, stage1)
        z = east.cm(z_id, 0, stage2, dim)
        zp = east.cm(z_id, 1, stage2, dim)
        h1["stageId"] = pil["nCm2"]
        h2["stageId"] = pil["nCm2"] + 1
        pil["nCm2"] += 2
        z["stageId"] = pil["nCm3"]
        pil["nCm3"] += 1

        c1 = east.mul(_l1_node(pil), east.sub(z, east.number(1)))
        _push_constraint(pil, c1, stark)

        one_plus_delta = east.add(east.number(1), delta)
        num_exp = east.mul(
            east.mul(
                east.add(f, gamma),
                east.add(
                    east.add(t, east.mul(tp, delta)),
                    east.mul(gamma, east.add(east.number(1), delta)),
                ),
            ),
            east.add(east.number(1), delta),
        )
        num_id, num_dim = _push_exp(pil, num_exp, stage2, stark, keep=True)

        den_exp = east.mul(
            east.add(
                east.add(h1, east.mul(h2, delta)),
                east.mul(gamma, east.add(east.number(1), delta)),
            ),
            east.add(
                east.add(h2, east.mul(h1p, delta)),
                east.mul(gamma, east.add(east.number(1), delta)),
            ),
        )
        den_id, den_dim = _push_exp(pil, den_exp, stage2, stark, keep=True)

        num = east.exp(num_id, 0, stage2)
        den = east.exp(den_id, 0, stage2)
        c2 = east.sub(east.mul(zp, den), east.mul(z, num))
        _push_constraint(pil, c2, stark)

        hints.append(
            {
                "name": "h1h2",
                "referenceH1": h1,
                "referenceH2": h2,
                "f": east.exp(f_exp_id, 0, stage1),
                "t": east.exp(t_exp_id, 0, stage1),
            }
        )
        hints.append(
            {
                "name": "gprod",
                "reference": z,
                "numerator": east.exp(num_id, 0, stage2),
                "denominator": east.exp(den_id, 0, stage2),
            }
        )

        common = {"airId": res["airId"], "subproofId": res["subproofId"]}
        symbols.append(
            {"type": "witness", "name": f"Plookup{i}.h1", "polId": h1_id, "stage": stage1, "dim": h_dim, **common}
        )
        symbols.append(
            {"type": "witness", "name": f"Plookup{i}.h2", "polId": h2_id, "stage": stage1, "dim": h_dim, **common}
        )
        symbols.append(
            {"type": "witness", "name": f"Plookup{i}.z", "polId": z_id, "stage": stage2, "dim": max(num_dim, den_dim), **common}
        )


def grand_product_permutation(pil, symbols, hints, res, stark, first_possible_stage):
    """grandProductPermutation.js:16-135."""
    stage = 2 if first_possible_stage else 3
    dim = 3 if stark else 1
    alpha = _challenge_node(symbols, stage=stage, stage_id=0)
    beta = _challenge_node(symbols, stage=stage, stage_id=1)
    gamma = _challenge_node(symbols, stage=stage, stage_id=2)

    for i, pi in enumerate(pil["permutationIdentities"]):
        t_exp = _fold_alpha(pi["t"], alpha, stage, t_side=True)
        if pi["selT"] is not None:
            t_exp = east.sub(t_exp, beta)
            t_exp = east.mul(t_exp, east.exp(pi["selT"], 0, stage))
            t_exp = east.add(t_exp, beta)
        t_exp_id, t_dim = _push_exp(pil, t_exp, stage, stark)

        f_exp = _fold_alpha(pi["f"], alpha, stage, t_side=False)
        if pi["selF"] is not None:
            f_exp = east.sub(f_exp, beta)
            f_exp = east.mul(f_exp, east.exp(pi["selF"], 0, stage))
            f_exp = east.add(f_exp, beta)
        f_exp_id, f_dim = _push_exp(pil, f_exp, stage, stark)

        z_id = pil["nCommitments"]
        pil["nCommitments"] += 1

        f = east.exp(f_exp_id, 0, stage)
        t = east.exp(t_exp_id, 0, stage)
        z = east.cm(z_id, 0, stage, dim)
        zp = east.cm(z_id, 1, stage, dim)
        z["stageId"] = pil["nCm2"]
        pil["nCm2"] += 1

        c1 = east.mul(_l1_node(pil), east.sub(z, east.number(1)))
        _push_constraint(pil, c1, stark)

        num_id, num_dim = _push_exp(pil, east.add(f, gamma), stage, stark, keep=True)
        den_id, den_dim = _push_exp(pil, east.add(t, gamma), stage, stark, keep=True)

        c2 = east.sub(
            east.mul(zp, east.exp(den_id, 0, stage)),
            east.mul(z, east.exp(num_id, 0, stage)),
        )
        _push_constraint(pil, c2, stark)

        hints.append(
            {
                "name": "gprod",
                "reference": z,
                "numerator": east.exp(num_id, 0, stage),
                "denominator": east.exp(den_id, 0, stage),
            }
        )
        symbols.append(
            {
                "type": "witness",
                "name": f"Permutation{i}.z",
                "polId": z_id,
                "stage": stage,
                "dim": max(num_dim, den_dim),
                "airId": res["airId"],
                "subproofId": res["subproofId"],
            }
        )


def grand_product_connection(pil, symbols, hints, res, stark,
                             first_possible_stage, field: str = "gl"):
    """grandProductConnection.js:22-160 (PlonK-style copy constraints)."""
    stage = 2 if first_possible_stage else 3
    dim = 3 if stark else 1
    gamma = _challenge_node(symbols, stage=stage, stage_id=0)
    delta = _challenge_node(symbols, stage=stage, stage_id=1)

    for i, ci in enumerate(pil["connectionIdentities"]):
        z_id = pil["nCommitments"]
        pil["nCommitments"] += 1

        num_exp = east.add(
            east.add(east.exp(ci["pols"][0], 0, stage), east.mul(delta, east.x())),
            gamma,
        )
        den_exp = east.add(
            east.add(
                east.exp(ci["pols"][0], 0, stage),
                east.mul(delta, east.exp(ci["connections"][0], 0, stage)),
            ),
            gamma,
        )
        num_id, _ = _push_exp(pil, num_exp, stage, stark)
        den_id, _ = _push_exp(pil, den_exp, stage, stark)

        ks = get_ks(len(ci["pols"]) - 1, field=field)
        for j in range(1, len(ci["pols"])):
            num_exp = east.mul(
                east.exp(num_id, 0, stage),
                east.add(
                    east.add(
                        east.exp(ci["pols"][j], 0, stage),
                        east.mul(east.mul(delta, east.number(ks[j - 1])), east.x()),
                    ),
                    gamma,
                ),
            )
            den_exp = east.mul(
                east.exp(den_id, 0, stage),
                east.add(
                    east.add(
                        east.exp(ci["pols"][j]),
                        east.mul(delta, east.exp(ci["connections"][j], 0, stage)),
                    ),
                    gamma,
                ),
            )
            num_id, _ = _push_exp(pil, num_exp, stage, stark, keep=True)
            den_id, _ = _push_exp(pil, den_exp, stage, stark, keep=True)

        z = east.cm(z_id, 0, stage, dim)
        zp = east.cm(z_id, 1, stage, dim)
        z["stageId"] = pil["nCm2"]
        pil["nCm2"] += 1

        c1 = east.mul(_l1_node(pil), east.sub(z, east.number(1)))
        _push_constraint(pil, c1, stark, stage=2)

        c2 = east.sub(
            east.mul(zp, east.exp(den_id, 0, stage)),
            east.mul(z, east.exp(num_id, 0, stage)),
        )
        _push_constraint(pil, c2, stark, stage=2)

        num_dim = get_exp_dim_lazy(pil["expressions"], num_id, stark)
        den_dim = get_exp_dim_lazy(pil["expressions"], den_id, stark)
        symbols.append(
            {
                "type": "witness",
                "name": f"Connection{i}.z",
                "polId": z_id,
                "stage": stage,
                "dim": max(num_dim, den_dim),
                "airId": res["airId"],
                "subproofId": res["subproofId"],
            }
        )
        hints.append(
            {
                "name": "gprod",
                "reference": z,
                "numerator": east.exp(num_id, 0, stage),
                "denominator": east.exp(den_id, 0, stage),
            }
        )
