"""STARK proof generation on one device — the stage loop.

Counterpart of the device-planar path of pil2_stark_tpu/stark/prover.py
(itself pil2-stark-js src/prover/prover.js proofGen and
src/stark/stark_gen_helpers.js).  Per Fiat-Shamir stage: resolve hints to
fixpoint on the host → evaluate the im-pols on the device → upload, LDE and
Merkelize on the device → absorb the root → squeeze challenges; then the Q
split, the DEEP evals, xDivXSubXi, the FRI polynomial, the FRI folds and
one batched query gather.  The transcript and the control flow stay on the
host.  The LDEs and the Q split run on kernels B2/B3 (ops/cuda_ntt.py) up
to 2^24 points and on the row route's B1 above, the FRI folds on B1, every
GL Merkle tree on kernel B4 (hash/cuda_poseidon.py; BN128 trees are built
on the host through ctx.mh, hash/mh.py), the im-pol, Q and FRI
programs on T1 (ops/torch_tac.py) and xDivXSubXi on T2 (ops/cuda_tac.py).

With a mesh (parallel/distributed.py; ref prover.py:429-484, 588-590) the
extended domain stays row-sharded through the whole prove, as the
reference's GSPMD programs keep it: each stage's columns and Q's split run
the four-step network with its exchanges (parallel/ntt_sharded.py), every
tree keeps each rank's rows and subtree on that rank with the top on the
lead (parallel/merkle_sharded.py; the caller splits the const tree once
per mesh),
the Q and FRI programs (T1) run on each rank's rows with a halo of the rows
its openings reach (``Mesh.halos``) and a row base, xDivXSubXi (T2) on each
rank's slice of x, and the evals sum each rank's rows, added on the lead.
Only the FRI polynomial is gathered on the lead, for the folds, which run
there as the reference runs FRI replicated; the im-pols (base domain) run
on the lead too, and each query reads its rows on the rank that owns them
(merkle_sharded.gather_group_proofs_multi).
The proof equals the single-device proof bit for bit.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..field import f3, gl64
from ..field import torch_gl as gl
from ..ops import ntt as ntt_ops
from ..ops import torch_tac
from ..parallel import merkle_sharded, ntt_sharded
from ..parallel.merkle_sharded import ShardedTree
from ..utils.timing import PhaseTimer
from . import device as dev
from . import expr_eval, hints
from .context import ProverCtx, resolve_device
from .fri import FRI


def prove(stark_info, expressions_info, const_pols, const_tree, inputs, device=None,
          logger=None, debug=False, profile_dir=None, external_challenges=None, mesh=None):
    """Returns {proof, publics, challenges, challengesFRISteps, timings,
    peakBytes, devicePeakBytes}; peakBytes holds each phase's peak device
    memory on the prove's card, devicePeakBytes each card's.

    inputs = (stage-1 witness columns as an (N, nCm1) u64 array, publics).
    const_tree is the tree from stark.setup.load_setup (a DeviceTree, or
    for verificationHashType BN128 an mh.TreeBN128).  device=None
    means "cuda" and raises when CUDA is unavailable; tests pass "cpu".

    debug=True (pil2_stark_tpu/stark/prover.py:101-130): with a debug setup
    (pilinfo's {"debug": True}, whose expressionsInfo has "constraints"),
    no commits and no Q stage; each stage's constraints are checked on the
    base domain and the list of errors is returned.  const_tree may be None.
    The first challenge of each stage after the first comes from
    default_rng(0xC0FFEE), the others from a transcript that absorbed
    nothing.

    profile_dir: run under torch.profiler (CPU and, on a card, CUDA
    activities) and write its Chrome trace to profile_dir/trace.json; the
    prove is the span "prove" in it, each phase a span of its own.
    utils/timing.py::idle_share reads the card's idle share from it.

    external_challenges (vadcop, pil2_stark_tpu/stark/prover.py:79-86):
    {"stages": [[3-tuple, ...] for stages 1..nStages+3], "friSteps": [one
    per FRI step, then the query challenge]} replace the transcript's.

    mesh (parallel.distributed.Mesh): keep the extended domain sharded
    over its ranks (the module docstring); the host side, the im-pols and
    the FRI folds run on its lead device, which `device` may name.  The
    const tree is then split over that mesh (merkle_sharded.shard_tree,
    once for all the proves on the mesh), its top on the lead.  Across processes every process runs this prove on the same
    inputs and gets the same proof.  A mesh refuses debug mode and BN128
    trees (the reference's device backend refuses them), and a transform
    whose factors the mesh does not divide raises.  The result then also
    holds "rankBytes": for each rank of this process, the bytes of extended
    rows it held at the end (every tree's element rows) and the most of the
    halo-padded copies a program run made ({"sections", "padded"}).
    """
    if mesh is not None:
        if device is not None and resolve_device(device) != mesh.lead:
            raise ValueError(f"device {device} is not the mesh's lead device {mesh.lead}")
        if debug:
            raise ValueError("a debug prove runs on one device: pass no mesh")
        if stark_info["starkStruct"].get("verificationHashType", "GL") != "GL":
            raise ValueError("a mesh builds GL trees only; BN128 trees are built on the host")
        if not (isinstance(const_tree, ShardedTree) and const_tree.mesh is mesh):
            raise ValueError("a mesh prove takes the const tree split over its mesh "
                             "(parallel.merkle_sharded.shard_tree)")
        device = mesh.lead
    device = resolve_device(device)
    if profile_dir is not None:
        return _profiled(profile_dir, device, lambda: prove(
            stark_info, expressions_info, const_pols, const_tree, inputs, device=device,
            logger=logger, debug=debug, external_challenges=external_challenges, mesh=mesh))
    const_at = None if debug else (const_tree.top[-1] if isinstance(const_tree, ShardedTree)
                                   else const_tree.elements).device
    if not debug and const_at != device:
        raise ValueError(f"the const tree lives on {const_at}, the prove on {device}")
    timer = PhaseTimer(logger, device, None if mesh is None else mesh.local_devices())
    with timer.phase("init"):
        ctx = ProverCtx(stark_info, expressions_info, const_pols, const_tree, device, debug=debug)
        if mesh is not None:
            ctx.dshards["const"] = const_tree.shards
    ctx.timer = timer
    ctx.mesh = mesh
    ctx.external_challenges = external_challenges

    cm1_values, publics_inputs = inputs
    n_cm1 = sum(1 for c in stark_info["cmPolsMap"] if c["stage"] == 1)
    ctx.buffers["cm1_n"][:, : cm1_values.shape[1]] = cm1_values
    for i in range(n_cm1):
        ctx.set_symbol_calculated({"op": "cm", "id": i})
    for i in range(stark_info["nPublics"]):
        ctx.publics[i] = int(publics_inputs[i])
        ctx.set_symbol_calculated({"op": "public", "stage": 1, "id": i})

    challenge = None
    q_stage = stark_info["nStages"] + 1
    rng = np.random.default_rng(0xC0FFEE) if debug else None
    for stage in range(1, q_stage + (0 if debug else 1)):
        if _n_challenges(stark_info, stage) > 0:
            _set_challenges(stage, ctx, challenge)
        with timer.phase(f"stage{stage}.witness"):
            _compute_stage(stage, ctx)
        if debug:
            challenge = _random_challenge(rng)
            continue
        if stage == 1:
            _add_publics_transcript(ctx)
        with timer.phase(f"stage{stage}.commit"):
            commits = _compute_q(ctx) if stage == q_stage else _extend_and_merkelize(stage, ctx)
        _add_transcript(ctx.transcript, commits)
        if _n_challenges(stark_info, stage) > 0:
            challenge = ctx.transcript.get_field()

    if debug:
        return ctx.errors
    if ctx.dpending:
        raise RuntimeError(
            f"device TAC writes to section(s) {sorted(ctx.dpending)} "
            "were never consumed by a stage commit")

    _set_challenges(stark_info["nStages"] + 2, ctx, challenge)
    with timer.phase("evals"):
        evals_commits = _compute_evals(ctx)
    _add_transcript(ctx.transcript, evals_commits)
    challenge = ctx.transcript.get_field()

    _set_challenges(stark_info["nStages"] + 3, ctx, challenge)
    with timer.phase("friPol"):
        pol = _compute_fri_pol(ctx)

    ss = stark_info["starkStruct"]
    fri = FRI(ss, ctx.mh)
    fri_proof = [{}]
    fri_trees = [[ctx.trees[i + 1] for i in range(stark_info["nStages"] + 1)] + [ctx.const_tree]]
    n_steps = len(ss["steps"])
    for step in range(n_steps):
        challenge = ctx.transcript.get_field()
        if external_challenges is not None:
            challenge = tuple(int(x) for x in external_challenges["friSteps"][step])
        ctx.challenges_fri_steps.append(challenge)
        with timer.phase(f"friFold{step}"):
            fold = fri.fold(step, pol, challenge)
        pol = fold["pol"]
        fri_proof.append(fold["proof"])
        if step < n_steps - 1:
            fri_trees.append(fold["tree"])
            commits = [fold["proof"]["root"]]
        elif ss.get("hashCommits"):
            commits = [_hash_commits(ctx, pol)]
        else:
            commits = [tuple(int(x) for x in v) for v in pol]
        _add_transcript(ctx.transcript, commits)

    challenge_queries = ctx.transcript.get_field()
    if external_challenges is not None:
        challenge_queries = tuple(int(x) for x in external_challenges["friSteps"][n_steps])
    ctx.challenges_fri_steps.append(challenge_queries)
    fri_queries = _get_permutations(ctx, challenge_queries)
    with timer.phase("queries"):
        fri.proof_queries(fri_proof, fri_trees, fri_queries,
                          None if mesh is None else merkle_sharded.gather_group_proofs_multi)

    proof = {"evals": ctx.evals, "subproofValues": ctx.subproof_values, "fri": fri_proof}
    for i in range(stark_info["nStages"] + 1):
        proof[f"root{i + 1}"] = ctx.mh.root(ctx.trees[i + 1])

    rank_bytes = None
    if mesh is not None:
        trees = [ctx.trees[i + 1] for i in range(stark_info["nStages"] + 1)] + [ctx.const_tree]
        held = [sum(t.rank_bytes()[r] for t in trees if isinstance(t, ShardedTree))
                for r in range(mesh.size)]
        rank_bytes = {"sections": [held[r] for r in mesh.local_ranks],
                      "padded": [ctx.padded_bytes.get(r, 0) for r in mesh.local_ranks]}

    # the witness upload is timed inside the commit phase: report it apart
    for key, t_up in list(timer.timings.items()):
        if key.endswith(".upload"):
            ckey = key.replace(".upload", ".commit")
            if ckey in timer.timings:
                timer.timings[ckey] = max(0.0, timer.timings[ckey] - t_up)

    return {
        "proof": proof,
        "publics": ctx.publics,
        "challenges": ctx.challenges,
        "challengesFRISteps": ctx.challenges_fri_steps,
        "timings": timer.summary(),
        "peakBytes": timer.peaks,
        "devicePeakBytes": timer.device_peaks,
        **({} if rank_bytes is None else {"rankBytes": rank_bytes}),
    }


# ---------------------------------------------------------------------------
# stages


def _profiled(profile_dir, device, run):
    """run() under torch.profiler, its Chrome trace written to
    profile_dir/trace.json; the result gets the trace's path as "trace"."""
    import os

    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        with record_function("prove"):
            res = run()
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    if isinstance(res, dict):
        res["trace"] = path
    return res


def _n_challenges(pil_info, stage):
    return sum(1 for c in pil_info["challengesMap"] if c["stage"] == stage)


def _set_challenges(stage, ctx, challenge):
    """setChallengesStark (stark_gen_helpers.js:414-439); the external
    challenges of a vadcop prove take the transcript's place."""
    n = _n_challenges(ctx.pil_info, stage)
    while len(ctx.challenges) < stage:
        ctx.challenges.append([])
    ctx.challenges[stage - 1] = []
    if ctx.external_challenges is not None:
        given = [tuple(int(x) for x in c) for c in ctx.external_challenges["stages"][stage - 1]]
        if len(given) != n:
            raise ValueError(f"stage {stage} needs {n} external challenges, got {len(given)}")
        ctx.challenges[stage - 1] = given
    else:
        for i in range(n):
            if i > 0 or not challenge:
                ctx.challenges[stage - 1].append(ctx.transcript.get_field())
            else:
                ctx.challenges[stage - 1].append(challenge)
    if stage < ctx.pil_info["nStages"] + 1:
        for i, c in enumerate(ctx.pil_info["challengesMap"]):
            if c["stage"] == stage:
                ctx.set_symbol_calculated({"op": "challenge", "stage": stage, "id": i})


def _random_challenge(rng):
    """A debug prove's challenge (pil2_stark_tpu/stark/prover.py:257)."""
    return tuple(int(rng.integers(0, 1 << 63)) % gl64.P_INT for _ in range(3))


def _compute_stage(stage, ctx):
    """computeStage (prover.js:192-231); in debug mode followed by the
    check of the stage's constraints on the host."""
    q_stage = ctx.pil_info["nStages"] + 1
    if stage == q_stage:
        _run_code(ctx, *torch_tac.device_program(ctx.pil_info, ctx.expressions_info, "q"))
        return
    missing = ctx.stage_symbols_missing(stage)
    while missing > 0:
        hints.apply_hints(ctx, stage)
        updated = ctx.stage_symbols_missing(stage)
        if updated == missing:
            raise RuntimeError(f"Something went wrong when calculating symbols for stage {stage}")
        missing = updated
    if stage == q_stage - 1:
        code, dom = torch_tac.device_program(ctx.pil_info, ctx.expressions_info, "imPols")
        if code["code"]:
            _run_code(ctx, code, dom)
    if ctx.debug:
        for c in ctx.expressions_info["constraints"]:
            if c["stage"] == stage:
                ctx.errors.extend(expr_eval.check_constraint(ctx, c))


def _run_code(ctx, code_obj, dom):
    """Run a TAC program on the device.  Base-domain outputs (the im-pols)
    stay on the device, staged for _extend_and_merkelize to splice into the
    section (in debug mode they go to the host buffers, which the
    constraint check reads); extended-domain programs leave Q or the FRI
    polynomial (on a mesh, Q sharded and the FRI polynomial gathered on the
    lead)."""
    if dom == "ext" and ctx.mesh is not None:
        outs = _run_code_sharded(ctx, code_obj, dom)
        if "q" in outs[ctx.mesh.local_ranks[0]]:
            ctx.dq = [None if o is None else o["q"] for o in outs]
        if "f" in outs[ctx.mesh.local_ranks[0]]:
            ctx.df = ctx.mesh.gather([None if o is None else o["f"] for o in outs])
        return
    executor = torch_tac.make_executor(code_obj, dom, ctx.pil_info, ctx.n_bits, ctx.n_bits_ext)
    out = executor(torch_tac.pack_inputs(ctx, dom))
    if ctx.debug:
        for (section, offset, dim), val in out["cm"].items():
            ctx.buffers[f"{section}_n"][:, offset:offset + dim] = gl.to_u64(val).T
        return
    if dom == "ext":
        if "q" in out:
            ctx.dq = out["q"]
        if "f" in out:
            ctx.df = out["f"]
        if out["cm"]:
            raise NotImplementedError("ext-domain TAC cm writes are not used by the stark pipeline")
        return
    for (section, offset, dim), val in out["cm"].items():
        ctx.dpending.setdefault(section, {})[offset] = (val, dim)


def _run_code_sharded(ctx, code_obj, dom):
    """An extended-domain program on each rank's rows: the sections it
    reads padded with the halo its shifts reach (one exchange of the edge
    rows for every section), x and the zerofier rows sliced to the same
    rows, xDivXSubXi computed there (T2) when the program reads it, then T1
    with the shard's rows as its window.  A rank's padded copies live only
    for its own run.  Returns each local rank's outputs."""
    mesh, ext_n = ctx.mesh, ctx.ext_N
    prog = torch_tac.compile_program(code_obj, dom, ctx.pil_info, ctx.n_bits, ctx.n_bits_ext)
    before, after = torch_tac.halo(prog)
    names = sorted({ref[1] for ref in prog.columns if ref[0] == "section"})
    arrays = [ctx.dshards[name] for name in names]
    edges = mesh.halos(arrays, before, after) if arrays and (before or after) else None
    xis = ([f3.as3(x) for x in _opening_xis(ctx)]
           if any(ref[0] == "xdiv" for ref in prog.columns) else None)
    b = ext_n // mesh.size
    outs = [None] * mesh.size
    for r in mesh.local_ranks:
        dv = mesh.device(r)
        rows = (torch.arange(before + b + after, device=ctx.device) + (r * b - before)) % ext_n
        sections, pos = {}, 0
        for name, a in zip(names, arrays):
            c = a[r].shape[0]
            if edges is None:
                sections[name] = a[r]
            else:
                pre, post = edges[r]
                sections[name] = torch.cat([pre[pos:pos + c], a[r], post[pos:pos + c]], dim=1)
            pos += c
        if edges is not None:
            padded = sum(t.numel() * 8 for t in sections.values())
            ctx.padded_bytes[r] = max(ctx.padded_bytes.get(r, 0), padded)
        x = ctx.dx["ext"][rows].to(dv)
        shard = {"sections": sections, "x": x, "Zi": ctx.dZi[:, rows].to(dv),
                 "xDivXSubXi": None if xis is None else dev.compute_xdiv(x, xis)}
        outs[r] = torch_tac.run(prog, torch_tac.pack_inputs(ctx, dom, shard), (before, b))
        del sections, shard
    return outs


def _extend_and_merkelize(stage, ctx):
    """Upload the stage's host-computed columns (splicing in the device im-pols),
    LDE, Merkelize (stark_gen_helpers.js:388-412)."""
    buff_from = ctx.buffers[f"cm{stage}_n"]
    n_pols = ctx.pil_info["mapSectionsN"][f"cm{stage}"]
    t_up0 = time.perf_counter()
    pending = ctx.dpending.pop(f"cm{stage}", {})
    parts, cursor = [], 0
    for offset in sorted(pending) + [n_pols]:
        if offset > cursor:
            host = np.ascontiguousarray(buff_from.T[cursor:offset])
            parts.append(gl.from_u64(host, ctx.device))
        if offset < n_pols:
            val, dim = pending[offset]
            parts.append(val)
            cursor = offset + dim
    if parts:
        dev_n = torch.cat(parts) if len(parts) > 1 else parts[0]
    else:
        dev_n = torch.zeros((0, ctx.N), dtype=torch.int64, device=ctx.device)
    ctx.timer.sync()
    key = f"stage{stage}.upload"
    ctx.timer.timings[key] = ctx.timer.timings.get(key, 0.0) + time.perf_counter() - t_up0
    ctx.dsections["n"][f"cm{stage}"] = dev_n
    if ctx.mesh is not None:
        if n_pols > 0:
            ext = ntt_sharded.sharded_lde(ctx.mesh.scatter(dev_n), ctx.n_bits, ctx.n_bits_ext,
                                          ctx.mesh)
        else:
            ext = _empty_shards(ctx)
        ctx.trees[stage] = _merkelize_sharded(ctx, ext, n_pols)
        ctx.dshards[f"cm{stage}"] = ext
        return [ctx.mh.root(ctx.trees[stage])]
    if n_pols > 0:
        ext = ntt_ops.lde_planar(dev_n, ctx.n_bits, ctx.n_bits_ext)
    else:
        ext = torch.zeros((0, ctx.ext_N), dtype=torch.int64, device=ctx.device)
    ctx.trees[stage] = ctx.mh.merkelize(ext, n_pols, ctx.ext_N)
    ctx.dsections["ext"][f"cm{stage}"] = ctx.trees[stage].elements
    return [ctx.mh.root(ctx.trees[stage])]


def _empty_shards(ctx):
    """The sharded array of a zero-width section."""
    b = ctx.ext_N // ctx.mesh.size
    return [torch.zeros((0, b), dtype=torch.int64, device=ctx.mesh.device(r))
            if r in ctx.mesh.local_ranks else None for r in range(ctx.mesh.size)]


def _merkelize_sharded(ctx, shards, n_pols):
    """The tree of a sharded extended section, its rows kept on their
    ranks (ref prover.py:470-484)."""
    return merkle_sharded.merkelize(ctx.mesh, shards, n_pols, ctx.ext_N,
                                    ctx.mh.split_linear_hash)


def _compute_q(ctx):
    """computeQStark (stark_gen_helpers.js:168-208): iNTT(ext) of q, split
    into qDeg chunks scaled by shiftIn^p, NTT back, Merkelize."""
    pil_info = ctx.pil_info
    q_stage = pil_info["nStages"] + 1
    q_dim, q_deg = pil_info["qDim"], pil_info["qDeg"]
    n, ext_n = ctx.N, ctx.ext_N
    shift_in = pow(pow(gl64.SHIFT_INT, gl64.P_INT - 2, gl64.P_INT), n, gl64.P_INT)
    n_inv = pow(ext_n, gl64.P_INT - 2, gl64.P_INT)
    n_pols_q = pil_info["mapSectionsN"].get(f"cm{q_stage}", 0)
    if ctx.mesh is not None:
        return _compute_q_sharded(ctx, q_stage, n_pols_q, shift_in, n_inv)
    # 1/extN of the iNTT folded into the shiftIn^p scale
    scale = gl.from_u64(gl64.powers(shift_in, q_deg, start=n_inv), ctx.device)
    qq1 = ntt_ops.planar_ntt(ctx.dq, ctx.n_bits_ext, True)
    ctx.dq = None  # nothing reads Q's values after its iNTT
    qq2 = gl.mul(qq1[:, : q_deg * n].reshape(q_dim, q_deg, n), scale[None, :, None])
    del qq1
    padded = torch.zeros((q_deg * q_dim, ext_n), dtype=torch.int64, device=ctx.device)
    padded[:, :n] = qq2.permute(1, 0, 2).reshape(q_deg * q_dim, n)
    ext = ntt_ops.planar_ntt(padded, ctx.n_bits_ext, False)
    ctx.dsections["ext"][f"cm{q_stage}"] = ext
    ctx.trees[q_stage] = ctx.mh.merkelize(ext, n_pols_q, ext_n)
    return [ctx.mh.root(ctx.trees[q_stage])]


def _compute_q_sharded(ctx, q_stage, n_pols_q, shift_in, n_inv):
    """_compute_q over the mesh: the iNTT of Q's sharded (qDim, extN)
    columns as the Q program left them on the ranks, the move of each
    chunk p (its columns [p·N, (p+1)·N)) to rows p·qDim of the first N
    columns, scaled by n_inv·shiftIn^p, and the NTT of the (qDeg·qDim,
    extN) result."""
    q_dim, q_deg = ctx.pil_info["qDim"], ctx.pil_info["qDeg"]
    mesh, n = ctx.mesh, ctx.N
    qq1 = ntt_sharded.sharded_ntt(ctx.dq, ctx.n_bits_ext, mesh, inverse=True)
    ctx.dq = None
    factors = gl64.powers(shift_in, q_deg, start=n_inv)
    moves = [(p * n, p * q_dim, 0, n, int(factors[p])) for p in range(q_deg)]
    padded = ntt_sharded.relayout(mesh, qq1, ctx.ext_N, q_deg * q_dim, moves)
    del qq1
    ext = ntt_sharded.sharded_ntt(padded, ctx.n_bits_ext, mesh)
    ctx.trees[q_stage] = _merkelize_sharded(ctx, ext, n_pols_q)
    ctx.dshards[f"cm{q_stage}"] = ext
    return [ctx.mh.root(ctx.trees[q_stage])]


def _opening_xis(ctx):
    xi = ctx.challenges[ctx.pil_info["nStages"] + 1][0]
    out = []
    for opening in ctx.pil_info["openingPoints"]:
        w = pow(gl64.w(ctx.n_bits), abs(int(opening)), gl64.P_INT)
        if opening < 0:
            w = pow(w, gl64.P_INT - 2, gl64.P_INT)
        out.append(f3.mul(xi, w))
    return out


def _compute_evals(ctx):
    """computeEvalsStark (stark_gen_helpers.js:210-273) on the device."""
    xis = [f3.mul(x, f3.inv1(gl64.SHIFT_INT)) for x in _opening_xis(ctx)]
    if ctx.mesh is not None:
        ctx.evals = dev.compute_evals_sharded(
            ctx.pil_info, ctx.dshards, xis, ctx.n_bits, 1 << ctx.extend_bits, ctx.mesh)
    else:
        ctx.evals = dev.compute_evals(
            ctx.pil_info, ctx.dsections["ext"], xis, ctx.n_bits, 1 << ctx.extend_bits,
            ctx.device)
    if ctx.pil_info["starkStruct"].get("hashCommits"):
        return [_hash_commits(ctx, ctx.evals)]
    return list(ctx.evals)


def _compute_fri_pol(ctx):
    """computeFRIStark (stark_gen_helpers.js:275-335); returns the FRI
    polynomial (3, extN).  xDivXSubXi is dropped after the FRI program, its
    only reader, and the context keeps no reference to the polynomial, so
    the folds free it after the first one.  On a mesh each rank computes
    its own rows of xDivXSubXi (_run_code_sharded)."""
    if ctx.mesh is None:
        ctx.dxdiv = dev.compute_xdiv(ctx.dx["ext"], [f3.as3(x) for x in _opening_xis(ctx)])
    _run_code(ctx, *torch_tac.device_program(ctx.pil_info, ctx.expressions_info, "fri"))
    pol, ctx.df, ctx.dxdiv = ctx.df, None, None
    return pol


def _add_publics_transcript(ctx):
    """addPublicsTranscript (prover.js:150-188)."""
    commits = [ctx.mh.root(ctx.const_tree)]
    if ctx.pil_info["starkStruct"].get("hashCommits"):
        commits.append(_hash_commits(ctx, ctx.publics))
    else:
        commits.extend(ctx.publics)
    _add_transcript(ctx.transcript, commits)


def _hash_commits(ctx, inputs):
    """calculateHashStark: absorb into a fresh transcript, return state."""
    t = ctx.mh.new_transcript()
    for v in inputs:
        t.put(_flatten(v))
    return t.get_state()


def _flatten(v):
    if isinstance(v, np.ndarray):
        return [int(x) for x in v.reshape(-1)]
    return v


def _add_transcript(transcript, inputs):
    for v in inputs:
        transcript.put(_flatten(v))


def _get_permutations(ctx, challenge):
    """getPermutationsStark: fresh transcript seeded with the query challenge."""
    t = ctx.mh.new_transcript()
    t.put(_flatten(challenge))
    ss = ctx.pil_info["starkStruct"]
    return t.get_permutations(ss["nQueries"], ss["steps"][0]["nBits"])
