"""pil-fflonk verifier: transcript replay, constraint recomputation at
xi, quotient consistency, and the batched shplonk pairing check.

Port of pil2-stark-js src/fflonk/helpers/fflonk_verify.js with our
protocol/shplonk.py standing in for shplonkjs' verifyOpenings.
"""
from __future__ import annotations

from ..ops.fft_bn128 import FR, w
from ..protocol.shplonk import (
    Keccak256Transcript,
    eval_suffix,
    shplonk_verify,
)


def fflonk_verify(vk, fflonk_info, verifier_info, proof, publics, logger=None):
    """Returns True iff the proof verifies.  vk: verification_key() dict
    (or the full zkey).  verifier_info: the qVerifier program from
    pil_info (the reference stores it under fflonkInfo.code.qVerifier).
    proof: {"polynomials", "evaluations"}."""
    def warn(msg):
        if logger:
            logger.warning(msg)

    challenges, xi_seed = _calculate_transcript(vk, fflonk_info, proof, publics)

    xi = pow(xi_seed, vk["powerW"], FR)
    n = 1 << vk["power"]

    # map evMap entries to claimed evaluations
    evals = []
    for ev in fflonk_info["evMap"]:
        if ev["type"] == "const":
            name = fflonk_info["constPolsMap"][ev["id"]]["name"]
        else:
            name = fflonk_info["cmPolsMap"][ev["id"]]["name"]
        evals.append(proof["evaluations"].get(name + eval_suffix(ev["prime"])))

    code_ctx = {
        "evals": evals,
        "challenges": challenges,
        "publics": [int(p) % FR for p in publics],
        "x": xi,
    }
    exec_val = _execute_code(code_ctx, verifier_info["qVerifier"]["code"])

    x_n = pow(xi, n, FR)
    z = (x_n - 1) % FR
    if z * int(proof["evaluations"].get("invZh", 0)) % FR != 1:
        warn("Invalid invZh evaluation")
        return False

    q = exec_val * proof["evaluations"]["invZh"] % FR

    evaluations = dict(proof["evaluations"])
    if vk["maxQDegree"] == 0:
        evaluations["Q"] = q  # non-committed: verifier-derived
    else:
        x_acc = 1
        q_sum = 0
        for i, qname in enumerate(vk["qNames"]):
            if qname not in evaluations:
                warn(f"{qname} evaluation missing")
                return False
            q_sum = (q_sum + x_acc * evaluations[qname]) % FR
            for _ in range(vk["maxQDegree"]):
                x_acc = x_acc * x_n % FR
        if q_sum != q:
            warn("Invalid Q")
            return False

    polynomials = {}
    for fi in vk["f"]:
        key = f"f{fi['index']}"
        if key not in proof["polynomials"]:
            warn(f"{key} commit is missing")
            return False
        polynomials[key] = proof["polynomials"][key]
    for wkey in ("W1", "W2"):
        if wkey not in proof["polynomials"]:
            warn(f"{wkey} commit is missing")
            return False
        polynomials[wkey] = proof["polynomials"][wkey]

    # const commitments must match the verification key (the reference
    # absorbs vk commits into the transcript, which binds them; we also
    # check equality explicitly)
    for key, cm in vk.get("constCommits", {}).items():
        fkey = "f" + key.split("_")[0][1:]
        pt = polynomials.get(fkey)
        # tuple/list agnostic: points may have crossed a JSON round-trip
        if (None if pt is None else tuple(pt)) != \
                (None if cm is None else tuple(cm)):
            warn(f"proof const commitment {fkey} differs from vk")
            return False

    # invZh is not a shplonk evaluation: drop before the opening check
    evaluations.pop("invZh", None)
    ok = shplonk_verify(vk, polynomials, evaluations, xi_seed, logger=logger)
    if not ok:
        warn("shplonk opening check failed")
    return ok


def _calculate_transcript(vk, fflonk_info, proof, publics):
    """fflonk_verify.js calculateTranscript: replay the stage schedule."""
    tr = Keccak256Transcript()
    hash_commits = fflonk_info.get("hashCommits")

    const_inputs = []
    for fi in vk["f"]:
        if fi["stages"][0]["stage"] == 0:
            key = f"f{fi['index']}_0"
            const_inputs.append(vk["constCommits"][key])
    if not hash_commits:
        for cm in const_inputs:
            tr.add_commit(cm)
        for p in publics:
            tr.add_scalar(int(p) % FR)
    else:
        tr.add_scalar(_hash_commits(const_inputs, []))
        tr.add_scalar(_hash_commits([], [int(p) % FR for p in publics]))

    challenges = []
    n_stages = fflonk_info["nStages"]
    for stage in range(1, n_stages + 1):
        n_ch = sum(1 for c in fflonk_info["challengesMap"] if c["stage"] == stage)
        vals = []
        for _ in range(n_ch):
            c = tr.get_challenge()
            vals.append(c)
            tr.reset()
            tr.add_scalar(c)
        challenges.append(vals)
        stage_commits = [
            proof["polynomials"][f"f{fi['index']}"]
            for fi in vk["f"] if fi["stages"][0]["stage"] == stage
        ]
        if not hash_commits:
            for cm in stage_commits:
                tr.add_commit(cm)
        else:
            tr.add_scalar(_hash_commits(stage_commits, []))

    q_stage = n_stages + 1
    n_ch_q = sum(1 for c in fflonk_info["challengesMap"] if c["stage"] == q_stage)
    vals = []
    for _ in range(max(1, n_ch_q)):
        c = tr.get_challenge()
        vals.append(c)
        tr.reset()
        tr.add_scalar(c)
    challenges.append(vals)

    q_commits = [
        proof["polynomials"][f"f{fi['index']}"]
        for fi in vk["f"] if fi["stages"][0]["stage"] == q_stage
    ]
    if not hash_commits:
        for cm in q_commits:
            tr.add_commit(cm)
    else:
        tr.add_scalar(_hash_commits(q_commits, []))

    xi_seed = tr.get_challenge()
    return challenges, xi_seed


def _hash_commits(commits, scalars):
    tr = Keccak256Transcript()
    for cm in commits:
        tr.add_commit(cm)
    for s in scalars:
        tr.add_scalar(s)
    return tr.get_challenge()


def _execute_code(ctx, code):
    """Scalar TAC interpreter over Fr (fflonk_verify.js:213-263)."""
    tmp = {}

    def get_ref(r):
        t = r["type"]
        if t == "tmp":
            return tmp[r["id"]]
        if t == "eval":
            v = ctx["evals"][r["id"]]
            if v is None:
                raise ValueError(f"missing evaluation for eval id {r['id']}")
            return int(v) % FR
        if t == "number":
            return int(r["value"]) % FR
        if t == "public":
            return ctx["publics"][r["id"]]
        if t == "challenge":
            return ctx["challenges"][r["stage"] - 1][r["stageId"]]
        if t == "x":
            return ctx["x"]
        raise ValueError(f"Invalid reference type get: {t}")

    res = 0
    for inst in code:
        src = [get_ref(s) for s in inst["src"]]
        op = inst["op"]
        if op == "add":
            res = (src[0] + src[1]) % FR
        elif op == "sub":
            res = (src[0] - src[1]) % FR
        elif op == "mul":
            res = src[0] * src[1] % FR
        elif op == "muladd":
            res = (src[0] * src[1] + src[2]) % FR
        elif op == "copy":
            res = src[0]
        else:
            raise ValueError(f"Invalid op: {op}")
        if inst["dest"]["type"] != "tmp":
            raise ValueError("Invalid reference type set")
        tmp[inst["dest"]["id"]] = res
    return res
