"""Reshape a proof into circom verifier input signals (zkin).

Copy of pil2_stark_tpu/utils/proof2zkin.py, itself pil2-stark-js
src/proof2zkin.js:1-79: per-stage s0 values/sibling
paths, per-FRI-step sN root/vals/siblings, finalPol, evals, subproofValues.
Used by the recursion tier (the zkin JSON feeds the compressor's witness
calculator).
"""
from __future__ import annotations


def _vals(v):
    if isinstance(v, (list, tuple)):
        return [_vals(x) for x in v]
    return int(v)


def _root(v):
    """GL roots are 4-element arrays; BN128 roots a single Fr scalar."""
    if isinstance(v, int):
        return int(v)
    try:
        return _vals(list(v))
    except TypeError:
        return int(v)


def proof2zkin(p: dict, stark_info: dict) -> dict:
    fri_steps = stark_info["starkStruct"]["steps"]
    n_queries = stark_info["starkStruct"]["nQueries"]
    n_stages = stark_info["nStages"]
    n_subproof_values = stark_info.get("nSubproofValues", 0)
    q_stage = n_stages + 1

    zkin = {}
    zkin["root1"] = _root(p["root1"])
    for i in range(n_stages - 1):
        stage = i + 2
        zkin[f"root{stage}"] = _root(p[f"root{stage}"])
    zkin[f"root{q_stage}"] = _root(p[f"root{q_stage}"])
    zkin["evals"] = _vals([list(e) for e in p["evals"]])

    for i in range(1, len(fri_steps)):
        zkin[f"s{i}_root"] = _root(p["fri"][i]["root"])
        zkin[f"s{i}_vals"] = []
        zkin[f"s{i}_siblings"] = []
        for q in range(n_queries):
            query = p["fri"][i]["polQueries"][q]
            zkin[f"s{i}_vals"].append(_vals(list(query[0])))
            zkin[f"s{i}_siblings"].append(_vals([list(s) for s in query[1]]))

    zkin["s0_valsC"] = []
    zkin["s0_vals1"] = []
    for i in range(n_stages - 1):
        stage = i + 2
        if stark_info["mapSectionsN"][f"cm{stage}"] > 0:
            zkin[f"s0_vals{stage}"] = []
    zkin[f"s0_vals{q_stage}"] = []

    zkin["s0_siblingsC"] = []
    zkin["s0_siblings1"] = []
    for i in range(n_stages - 1):
        stage = i + 2
        if stark_info["mapSectionsN"][f"cm{stage}"] > 0:
            zkin[f"s0_siblings{stage}"] = []
    zkin[f"s0_siblings{q_stage}"] = []

    for i in range(n_queries):
        query = p["fri"][0]["polQueries"][i]
        zkin["s0_vals1"].append(_vals(list(query[0][0])))
        zkin["s0_siblings1"].append(_vals([list(s) for s in query[0][1]]))
        for stage in range(2, n_stages + 1):
            if stark_info["mapSectionsN"][f"cm{stage}"] > 0:
                zkin[f"s0_vals{stage}"].append(_vals(list(query[stage - 1][0])))
                zkin[f"s0_siblings{stage}"].append(
                    _vals([list(s) for s in query[stage - 1][1]])
                )
        zkin[f"s0_vals{q_stage}"].append(_vals(list(query[n_stages][0])))
        zkin[f"s0_siblings{q_stage}"].append(
            _vals([list(s) for s in query[n_stages][1]])
        )
        zkin["s0_valsC"].append(_vals(list(query[n_stages + 1][0])))
        zkin["s0_siblingsC"].append(
            _vals([list(s) for s in query[n_stages + 1][1]])
        )

    zkin["finalPol"] = _vals([list(v) for v in p["fri"][len(fri_steps)]])

    if n_subproof_values > 0:
        zkin["subproofValues"] = _vals(list(p["subproofValues"]))

    return zkin


def challenges2zkin(challenges, challenges_fri_steps, stark_info, zkin: dict) -> dict:
    """challenges2zkinCircom (proof2zkin.js): attach the verifier challenges
    for vadcop-style aggregation circuits."""
    out = dict(zkin)
    out["challenges"] = _vals([list(c) for stage in challenges for c in stage])
    out["challengesFRISteps"] = _vals([list(c) for c in challenges_fri_steps])
    return out


def challenges2zkin_circom(challenges, challenges_fri_steps, stark_info,
                           zkin: dict) -> dict:
    """challenges2zkinCircom (proof2zkin.js:199-220): per-stage challenge
    signals for verifier circuits emitted with options.inputChallenges."""
    out = dict(zkin)
    n_stages = stark_info["nStages"]
    for i in range(n_stages):
        n = sum(1 for c in stark_info["challengesMap"] if c["stage"] == i + 1)
        if n == 0:
            continue
        out[f"challengesStage{i + 1}"] = _vals(
            [list(challenges[i][j]) for j in range(n)]
        )
    out["challengeQ"] = _vals(list(challenges[n_stages][0]))
    out["challengeXi"] = _vals(list(challenges[n_stages + 1][0]))
    out["challengesFRI"] = _vals([list(c) for c in challenges[n_stages + 2]])
    out["challengesFRISteps"] = _vals([list(c) for c in challenges_fri_steps])
    return out
