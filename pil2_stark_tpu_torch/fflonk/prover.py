"""pil-fflonk prover: the generic stage driver instantiated over BN254-Fr
with shplonk composed commitments.

Mirrors the fflonk branch of pil2-stark-js src/prover/prover.js
(proofGen) with the stage implementations of
src/fflonk/helpers/fflonk_prover_helpers.js: per stage — resolve hints
to fixpoint → im-pols → iFFT to coefficients → ZK-blind with
b·X^j·(X^N−1) → extend to the ext domain → shplonk-commit; then the
quotient Q = C/Z_H by exact coefficient division, the xiSeed challenge,
and one batched shplonk opening (W1/W2 + single pairing on the verifier
side).

Deliberate deviation, documented: when a stage's first challenge is
requested before any squeeze happened (stage 1 has no challenges), it is
squeezed lazily from the accumulated transcript — the stark side of the
reference does exactly this (setChallengesStark's `!challenge` branch);
the fflonk side would propagate `undefined`.  Our verifier replays the
same schedule, which also matches fflonk_verify.js's calculateTranscript.
"""
from __future__ import annotations

import random

import numpy as np

from ..ops.fft_bn128 import FR, intt, ntt
from ..protocol.shplonk import shplonk_commit, shplonk_open
from ..stark import hints
from . import fr_ctx
from .fr_ctx import FrProverCtx, execute_code
from . import chelpers as fflonk_chelpers


def fflonk_prove(zkey, ptau, pil_info, expressions_info, cm1_values, publics,
                 rng=None, debug=False, logger=None, chelpers=None):
    """Returns {"proof", "publics", "challenges"} (or the error list in
    debug mode).  cm1_values: (N, nCm1) array of Fr ints; publics: list.
    rng: random.Random for ZK blinding (seeded in tests; defaults to
    SystemRandom).
    chelpers: flattened bytecode units from fflonk.chelpers.build()/
    read_file() — when given, stage TACs execute through the stream
    interpreter (the reference's generated-C++ placement,
    fflonk_chelpers.js:1-242) instead of the dict-dispatch executor."""
    ctx = FrProverCtx(pil_info, expressions_info, zkey, debug=debug)
    if chelpers is not None:
        # a .fflonkchelpers.bin built for a different circuit would fail
        # deep inside a stage with an obscure IndexError (or prove garbage
        # caught only at verify) — check identity up front
        # in-memory build() units carry no header; file artifacts do
        if ("pilPower" in chelpers
                and chelpers["pilPower"] != pil_info["pilPower"]):
            raise ValueError(
                f"fflonk chelpers artifact was built for pilPower="
                f"{chelpers.get('pilPower')}, circuit has "
                f"{pil_info['pilPower']} — wrong circuit?"
            )
        n_units = len(expressions_info["imPolsCode"])
        if len(chelpers["imPols"]) != n_units:
            raise ValueError(
                f"fflonk chelpers artifact has {len(chelpers['imPols'])} "
                f"imPols units, circuit expects {n_units} — wrong circuit?"
            )
        if not any(u["expId"] == pil_info["cExpId"]
                   for u in chelpers["expressions"]):
            raise ValueError(
                f"fflonk chelpers artifact lacks the constraint expression "
                f"cExpId={pil_info['cExpId']} — wrong circuit?"
            )
    ctx.chelpers = chelpers
    ctx.ptau = ptau
    ctx.rng = rng or random.SystemRandom()

    if not debug:
        for k, v in zkey["constCommits"].items():
            ctx.committed_pols[k] = dict(v)
        ctx.pols.update(zkey["constPolsCoefs"])

    n_cm1 = sum(1 for c in pil_info["cmPolsMap"] if c["stage"] == 1)
    cm1 = np.asarray(cm1_values, dtype=object)
    ctx.buffers["cm1_n"][:, : cm1.shape[1]] = cm1 % FR
    for i in range(n_cm1):
        ctx.set_symbol_calculated({"op": "cm", "id": i})
    for i in range(pil_info["nPublics"]):
        ctx.publics[i] = int(publics[i]) % FR
        ctx.set_symbol_calculated({"op": "public", "stage": 1, "id": i})

    challenge = None
    q_stage = pil_info["nStages"] + 1

    for stage in range(1, q_stage + 1):
        if stage == q_stage and debug:
            continue
        if _n_challenges(pil_info, stage) > 0:
            challenge = _set_challenges(stage, ctx, challenge)
        _compute_stage(stage, ctx)

        if stage == 1 and not debug:
            _add_publics_transcript(ctx)

        if not debug:
            if stage == q_stage:
                commits = _compute_q(ctx)
            else:
                commits = _extend_and_commit(stage, ctx)
            _add_transcript(ctx.transcript, commits)
            if _n_challenges(pil_info, stage) > 0:
                challenge = ctx.transcript.get_challenge()
                ctx.transcript.reset()

    if debug:
        return ctx.errors

    xi_seed = challenge
    cmts, evaluations = shplonk_open(
        zkey, ptau, ctx.pols, ctx.committed_pols, xi_seed, logger=logger
    )
    xi = pow(xi_seed, zkey["powerW"], FR)
    z = (pow(xi, ctx.N, FR) - 1) % FR
    evaluations["invZh"] = pow(z, FR - 2, FR)

    proof = {"protocol": "pilfflonk", "curve": "bn128",
             "polynomials": {}, "evaluations": {}}
    for key, cm in cmts.items():
        proof["polynomials"][key] = cm
    for key, v in evaluations.items():
        if key in ctx.non_committed_pols:
            continue  # verifier re-derives (genProofFflonk strips "Q")
        proof["evaluations"][key] = v

    return {
        "proof": proof,
        "publics": list(ctx.publics),
        "challenges": ctx.challenges,
        "xiSeed": xi_seed,
    }


# ---------------------------------------------------------------------------


def _n_challenges(pil_info, stage):
    return sum(1 for c in pil_info["challengesMap"] if c["stage"] == stage)


def _set_challenges(stage, ctx, challenge):
    """setChallengesFflonk + the lazy first squeeze (see module doc)."""
    n = _n_challenges(ctx.pil_info, stage)
    while len(ctx.challenges) < stage:
        ctx.challenges.append([])
    vals = []
    for i in range(n):
        if i == 0:
            if challenge is None:
                challenge = ctx.transcript.get_challenge()
                ctx.transcript.reset()
            vals.append(challenge)
        else:
            ctx.transcript.reset()
            ctx.transcript.add_scalar(vals[-1])
            vals.append(ctx.transcript.get_challenge())
            ctx.transcript.reset()
    ctx.challenges[stage - 1] = vals
    if stage < ctx.pil_info["nStages"] + 1:
        for i, c in enumerate(ctx.pil_info["challengesMap"]):
            if c["stage"] == stage:
                ctx.set_symbol_calculated({"op": "challenge", "stage": stage, "id": i})
    return vals[-1]


def _compute_stage(stage, ctx):
    q_stage = ctx.pil_info["nStages"] + 1
    dom = "ext" if stage == q_stage else "n"

    if stage != q_stage:
        missing = ctx.stage_symbols_missing(stage)
        while missing > 0:
            hints.apply_hints(ctx, stage)
            updated = ctx.stage_symbols_missing(stage)
            if updated == missing:
                raise RuntimeError(
                    f"Could not resolve symbols for fflonk stage {stage}"
                )
            missing = updated
        if stage == q_stage - 1:
            if getattr(ctx, "chelpers", None) is not None:
                unit = ctx.chelpers["imPols"][stage - 1]
                if len(unit["ops"]):
                    fflonk_chelpers.execute_stream(ctx, unit, dom)
            else:
                code = ctx.expressions_info["imPolsCode"][stage - 1]
                if code["code"]:
                    execute_code(ctx, code, dom)
    else:
        if getattr(ctx, "chelpers", None) is not None:
            unit = next(
                u for u in ctx.chelpers["expressions"]
                if u["expId"] == ctx.pil_info["cExpId"]
            )
            fflonk_chelpers.execute_stream(ctx, unit, dom)
        else:
            code = next(
                e for e in ctx.expressions_info["expressionsCode"]
                if e["expId"] == ctx.pil_info["cExpId"]
            )
            execute_code(ctx, code["code"], dom)

    if ctx.debug:
        for c in ctx.expressions_info["constraints"]:
            if c["stage"] != stage:
                continue
            ctx.errors.extend(fr_ctx.check_constraint(ctx, c, dom))


def _add_publics_transcript(ctx):
    """addPublicsTranscript, fflonk flavor (prover.js:148-190): stage-0
    (const) commitments then the public values."""
    inputs = []
    for fi in ctx.zkey["f"]:
        if fi["stages"][0]["stage"] == 0:
            key = f"f{fi['index']}_0"
            inputs.append({"commit": True, "value": ctx.committed_pols[key]["commit"]})
    for p in ctx.publics:
        inputs.append({"value": int(p)})
    if ctx.pil_info.get("hashCommits"):
        inputs = [{"value": _hash_inputs(inputs[: len(inputs) - len(ctx.publics)])},
                  {"value": _hash_inputs([{"value": int(p)} for p in ctx.publics])}]
    _add_transcript(ctx.transcript, inputs)


def _hash_inputs(inputs):
    from ..protocol.shplonk import Keccak256Transcript

    tr = Keccak256Transcript()
    _add_transcript(tr, inputs)
    return tr.get_challenge()


def _add_transcript(transcript, inputs):
    for inp in inputs:
        if inp.get("commit"):
            transcript.add_commit(inp["value"])
        else:
            transcript.add_scalar(inp["value"])


def _n_blind(zkey, name, stage):
    """findNumberOpenings (fflonk_prover_helpers.js:358-367)."""
    for fi in zkey["f"]:
        if fi["stages"][0]["stage"] != stage:
            continue
        if name in fi["pols"]:
            return len(fi["openingPoints"]) + 1
    return 0


def _extend_and_commit(stage, ctx):
    """extendAndCommit: iFFT → blind with b·X^j·(X^N−1) → FFT to the ext
    domain → shplonk partial commit for this stage."""
    zkey = ctx.zkey
    pil_info = ctx.pil_info
    names = [p["name"] for p in pil_info["cmPolsMap"] if p["stage"] == stage]
    buf_n = ctx.buffers[f"cm{stage}_n"]
    buf_ext = ctx.buffers[f"cm{stage}_ext"]

    for col_idx, name in enumerate(names):
        col = [int(v) % FR for v in buf_n[:, col_idx]]
        coefs = intt(col)
        n_blind = _n_blind(zkey, name, stage)
        if n_blind:
            coefs = coefs + [0] * n_blind
            for j in range(n_blind):
                b = ctx.rng.randrange(FR)
                coefs[j] = (coefs[j] - b) % FR
                coefs[ctx.N + j] = (coefs[ctx.N + j] + b) % FR
        ctx.pols[name] = coefs
        padded = coefs + [0] * (ctx.ext_N - len(coefs))
        buf_ext[:, col_idx] = ntt(padded)

    commits = shplonk_commit(stage, zkey, ctx.pols, ctx.ptau)
    for ent in commits:
        ctx.committed_pols[ent["index"]] = ent

    out = []
    if stage > 1 and len(ctx.challenges) >= stage and ctx.challenges[stage - 1]:
        out.append({"value": ctx.challenges[stage - 1][-1]})
    stage_commits = [{"commit": True, "value": e["commit"]} for e in commits]
    if ctx.pil_info.get("hashCommits"):
        out.append({"value": _hash_inputs(stage_commits)})
    else:
        out.extend(stage_commits)
    return out


def _div_zh(coefs, n):
    """Exact division by Z_H = X^n − 1 in coefficient form
    (snarkjs Polynomial.divZh).  c[j] = q[j−n] − q[j]."""
    ext_n = len(coefs)
    q = [0] * ext_n
    for j in range(ext_n - 1, n - 1, -1):
        q[j - n] = (coefs[j] + q[j]) % FR
    for j in range(n):
        if (coefs[j] + q[j]) % FR != 0:
            raise AssertionError(
                "constraint polynomial is not divisible by Z_H "
                f"(remainder at coefficient {j})"
            )
    return q


def _compute_q(ctx):
    """computeQFflonk: Q = C/Z_H; optional Q_i split with border blinding."""
    zkey = ctx.zkey
    q_stage = ctx.pil_info["nStages"] + 1
    evals = [int(v) % FR for v in ctx.q_ext[:, 0]]
    coefs = _div_zh(intt(evals), ctx.N)

    max_q_deg = zkey["maxQDegree"]
    if max_q_deg:
        n_q = len(zkey["qNames"])
        rand1 = ctx.rng.randrange(FR)
        rand2 = ctx.rng.randrange(FR)
        domain_size_q = (ctx.pil_info["qDeg"] * ctx.N
                         + ctx.pil_info["maxPolsOpenings"] * (ctx.pil_info["qDeg"] + 1))
        for i in range(n_q):
            st = i * max_q_deg * ctx.N
            end = domain_size_q if i == n_q - 1 else (i + 1) * max_q_deg * ctx.N
            chunk = [coefs[k] if k < len(coefs) else 0 for k in range(st, end)]
            if i < n_q - 1:
                chunk = chunk + [0, 0]
            if i > 0:
                chunk[0] = (chunk[0] - rand1) % FR
                chunk[1] = (chunk[1] - rand2) % FR
            if i < n_q - 1:
                rand1 = ctx.rng.randrange(FR)
                rand2 = ctx.rng.randrange(FR)
                chunk[-2] = (chunk[-2] + rand1) % FR
                chunk[-1] = (chunk[-1] + rand2) % FR
            ctx.pols[f"Q{i}"] = chunk
    else:
        ctx.pols["Q"] = coefs
        ctx.non_committed_pols.append("Q")

    commits = shplonk_commit(q_stage, zkey, ctx.pols, ctx.ptau)
    for ent in commits:
        ctx.committed_pols[ent["index"]] = ent

    out = []
    if len(ctx.challenges) >= q_stage and ctx.challenges[q_stage - 1]:
        out.append({"value": ctx.challenges[q_stage - 1][-1]})
    stage_commits = [{"commit": True, "value": e["commit"]} for e in commits]
    if ctx.pil_info.get("hashCommits"):
        out.append({"value": _hash_inputs(stage_commits)})
    else:
        out.extend(stage_commits)
    return out
