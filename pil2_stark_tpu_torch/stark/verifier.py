"""STARK verifier — host-side (scalar extension arithmetic, tiny state).

Mirrors pil2-stark-js src/stark/stark_verify.js:8-298 and
calculateTranscriptVerify.js: rebuild the Fiat-Shamir transcript (exact
absorb order: constRoot → publics → per-stage roots → evals → FRI roots /
last pol), evaluate the verifier TAC (executeCode interpreter), check
res == Σ xAcc·eval(Q_i) against xi^N, then per-query Merkle verification of
all stage trees + constRoot with DEEP quotient re-evaluation, closed by
FRI.verify.
"""
from __future__ import annotations

import numpy as np

from ..field import gl64, f3
from ..hash.mh import build_mh
from .fri import FRI


P = gl64.P_INT


def verify(proof_obj, publics, const_root, stark_info, verifier_info, challenges=None):
    proof = proof_obj
    ss = stark_info["starkStruct"]
    mh = build_mh(ss)
    n_bits = ss["nBits"]
    n = 1 << n_bits
    extend_bits = ss["nBitsExt"] - n_bits
    assert n_bits + extend_bits == ss["steps"][0]["nBits"]

    q_stage = stark_info["nStages"] + 1

    if challenges is None:
        challenges, challenges_fri_steps = calculate_transcript(
            stark_info, proof, publics, const_root, mh
        )
    else:
        challenges, challenges_fri_steps = challenges

    fri_queries = calculate_fri_queries(
        stark_info, challenges_fri_steps[len(ss["steps"])], mh
    )

    ctx = {
        "evals": [tuple(int(x) for x in e) for e in proof["evals"]],
        "subproofValues": proof.get("subproofValues", []),
        "publics": publics,
        "starkInfo": stark_info,
        "challenges": challenges,
    }

    evals_stage = stark_info["nStages"] + 1
    xi = challenges[evals_stage][0]
    x_n_val = f3.exp(xi, n)
    zh = f3.sub(x_n_val, 1)
    ctx["Z"] = f3.inv(zh)

    boundary_names = [b["name"] for b in stark_info["boundaries"]]
    if "firstRow" in boundary_names:
        ctx["Z_fr"] = f3.mul(zh, f3.inv(f3.sub(xi, 1)))
    if "lastRow" in boundary_names:
        root = pow(gl64.w(n_bits), n - 1, P)
        ctx["Z_lr"] = f3.mul(zh, f3.inv(f3.sub(xi, root)))
    if "everyFrame" in boundary_names:
        frames = [b for b in stark_info["boundaries"] if b["name"] == "everyFrame"]
        for i, frame in enumerate(frames):
            z = 1
            for j in range(frame["offsetMin"]):
                z = f3.mul(z, f3.sub(xi, pow(gl64.w(n_bits), j, P)))
            for j in range(frame["offsetMax"]):
                z = f3.mul(z, f3.sub(xi, pow(gl64.w(n_bits), n - j - 1, P)))
            ctx[f"Z_frame{i}"] = z

    res = execute_code(ctx, verifier_info["qVerifier"]["code"])

    x_acc = 1
    q = 0
    q_index = next(
        i
        for i, p in enumerate(stark_info["cmPolsMap"])
        if p["stage"] == q_stage and p.get("stageId") == 0
    )
    for i in range(stark_info["qDeg"]):
        ev_id = next(
            j
            for j, e in enumerate(stark_info["evMap"])
            if e["type"] == "cm" and e["id"] == q_index + i
        )
        q = f3.add(q, f3.mul(x_acc, ctx["evals"][ev_id]))
        x_acc = f3.mul(x_acc, x_n_val)

    if not f3.eq(res, q):
        return False

    fri = FRI(ss, mh)

    def check_query(query, idx):
        for i in range(stark_info["nStages"] + 1):
            stage = i + 1
            if not mh.verify_group_proof(
                proof[f"root{stage}"], query[i][1], idx, query[i][0]
            ):
                return False
        if not mh.verify_group_proof(
            const_root,
            query[stark_info["nStages"] + 1][1],
            idx,
            query[stark_info["nStages"] + 1][0],
        ):
            return False

        ctx_qry = {
            "starkInfo": stark_info,
            "evals": ctx["evals"],
            "publics": publics,
            "challenges": challenges,
        }
        for i in range(stark_info["nStages"] + 1):
            ctx_qry[f"tree{i + 1}"] = [int(v) for v in query[i][0]]
        ctx_qry["consts"] = [int(v) for v in query[stark_info["nStages"] + 1][0]]

        x = (gl64.SHIFT_INT * pow(gl64.w(n_bits + extend_bits), idx, P)) % P
        ctx_qry["xDivXSubXi"] = {}
        for i, opening in enumerate(stark_info["openingPoints"]):
            w = pow(gl64.w(n_bits), abs(int(opening)), P)
            if opening < 0:
                w = pow(w, P - 2, P)
            ctx_qry["xDivXSubXi"][i] = f3.div(
                x, f3.sub(x, f3.mul(challenges[evals_stage][0], w))
            )
        return [execute_code(ctx_qry, verifier_info["queryVerifier"]["code"])]

    return fri.verify(challenges_fri_steps, fri_queries, proof["fri"], check_query)


def execute_code(ctx, code):
    """stark_verify.js executeCode:222-298 — scalar TAC interpreter."""
    tmp = {}

    def get_ref(r):
        t = r["type"]
        if t.startswith("tree"):
            arr = ctx[t]
            pos = r["treePos"]
            if r["dim"] == 1:
                return arr[pos]
            return tuple(arr[pos : pos + 3])
        if t == "tmp":
            return tmp[r["id"]]
        if t == "const":
            return ctx["consts"][r["id"]]
        if t == "eval":
            return ctx["evals"][r["id"]]
        if t == "number":
            return int(r["value"]) % P
        if t == "public":
            return int(ctx["publics"][r["id"]])
        if t == "challenge":
            return ctx["challenges"][r["stage"] - 1][r["stageId"]]
        if t == "subproofValue":
            if ctx.get("global"):
                return ctx["subproofValues"][r["subproofId"]][r["id"]]
            return ctx["subproofValues"][r["id"]]
        if t == "xDivXSubXi":
            return ctx["xDivXSubXi"][r["id"]]
        if t == "x":
            evals_stage = ctx["starkInfo"]["nStages"] + 1
            return ctx["challenges"][evals_stage][0]
        if t == "Zi":
            boundary = ctx["starkInfo"]["boundaries"][r["boundaryId"]]
            if boundary["name"] == "everyRow":
                return ctx["Z"]
            if boundary["name"] == "firstRow":
                return ctx["Z_fr"]
            if boundary["name"] == "lastRow":
                return ctx["Z_lr"]
            if boundary["name"] == "everyFrame":
                frames = [
                    b
                    for b in ctx["starkInfo"]["boundaries"]
                    if b["name"] == "everyFrame"
                ]
                bid = next(
                    i
                    for i, b in enumerate(frames)
                    if b.get("offsetMin") == boundary.get("offsetMin")
                    and b.get("offsetMax") == boundary.get("offsetMax")
                )
                return ctx[f"Z_frame{bid}"]
            raise ValueError(f"Invalid boundary {boundary}")
        raise ValueError(f"Invalid reference type get: {t}")

    for inst in code:
        src = [get_ref(s) for s in inst["src"]]
        op = inst["op"]
        if op == "add":
            r = f3.add(src[0], src[1])
        elif op == "sub":
            r = f3.sub(src[0], src[1])
        elif op == "mul":
            r = f3.mul(src[0], src[1])
        elif op == "muladd":
            r = f3.add(f3.mul(src[0], src[1]), src[2])
        elif op == "copy":
            r = src[0]
        else:
            raise ValueError(f"Invalid op: {op}")
        if inst["dest"]["type"] != "tmp":
            raise ValueError("Invalid dest")
        tmp[inst["dest"]["id"]] = r

    return get_ref(code[-1]["dest"])


def calculate_transcript(stark_info, proof, publics, const_root, mh=None):
    """calculateTranscriptVerify.js:7-103."""
    if mh is None:
        mh = build_mh(stark_info["starkStruct"])
    transcript = mh.new_transcript()
    challenges = []
    # GL trees absorb 4-element roots; BN128 trees absorb one Fr scalar
    gl_root = stark_info["starkStruct"].get("verificationHashType", "GL") == "GL"

    _put_root(transcript, const_root, gl_root)
    if not stark_info["starkStruct"].get("hashCommits"):
        for p in publics:
            transcript.put(int(p))
    else:
        transcript.put(_hash_list(publics, mh))

    for i in range(stark_info["nStages"]):
        stage = i + 1
        n_ch = sum(1 for c in stark_info["challengesMap"] if c["stage"] == stage)
        challenges.append([transcript.get_field() for _ in range(n_ch)])
        _put_root(transcript, proof[f"root{stage}"], gl_root)

    q_step = stark_info["nStages"]
    challenges.append([transcript.get_field()])
    _put_root(transcript, proof[f"root{q_step + 1}"], gl_root)

    challenges.append([transcript.get_field()])  # xi

    if not stark_info["starkStruct"].get("hashCommits"):
        for ev in proof["evals"]:
            transcript.put([int(x) for x in ev])
    else:
        transcript.put(_hash_list(proof["evals"], mh))

    challenges.append([transcript.get_field(), transcript.get_field()])  # vf1, vf2

    challenges_fri_steps = []
    steps = stark_info["starkStruct"]["steps"]
    for step in range(len(steps)):
        challenges_fri_steps.append(transcript.get_field())
        if step < len(steps) - 1:
            _put_root(transcript, proof["fri"][step + 1]["root"], gl_root)
        else:
            last = proof["fri"][-1]
            if not stark_info["starkStruct"].get("hashCommits"):
                for v in last:
                    transcript.put([int(x) for x in v])
            else:
                transcript.put(_hash_list(last, mh))

    challenges_fri_steps.append(transcript.get_field())
    return challenges, challenges_fri_steps


def calculate_fri_queries(stark_info, challenge, mh=None):
    if mh is None:
        mh = build_mh(stark_info["starkStruct"])
    t = mh.new_transcript()
    t.put(list(challenge))
    ss = stark_info["starkStruct"]
    return t.get_permutations(ss["nQueries"], ss["steps"][0]["nBits"])


def _put_root(transcript, root, gl_root):
    """Absorb a Merkle root, dispatched by the starkStruct's tree type:
    4 GL elements (GL trees) or one Fr scalar (BN128 trees) — no value
    sniffing (a BN128 root may arrive as an int or a decimal JSON string)."""
    if gl_root:
        transcript.put([int(x) for x in root])
    else:
        transcript.put(int(root))


def _hash_list(values, mh):
    t = mh.new_transcript()
    for v in values:
        if isinstance(v, (list, tuple, np.ndarray)):
            t.put([int(x) for x in v])
        else:
            t.put(int(v))
    return t.get_state()


def verify_global_constraints(constraints_code, subproof_values, publics=None, challenges=None):
    """The vadcop cross-subproof constraints (boundary finalProof,
    pil2_stark_tpu/stark/verifier.py:299-318) over the subproof values of
    the component proofs: subproof_values holds one list of values per
    subproof.  Returns the failures, [] when every constraint is zero."""
    ctx = {
        "global": True,
        "subproofValues": [
            [f3.as3(v) if not isinstance(v, tuple) else v for v in sub]
            for sub in subproof_values
        ],
        "publics": publics or [],
        "challenges": challenges or [],
        "starkInfo": {"nStages": 0, "boundaries": []},
    }
    failures = []
    for i, code in enumerate(constraints_code):
        res = execute_code(ctx, code["code"])
        if not f3.is_zero(res):
            failures.append(f"{code.get('line')}: global constraint {i} != 0 ({res})")
    return failures
