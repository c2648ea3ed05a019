"""pil2circom: emit the Goldilocks STARK-verifier circom circuit for a
compiled machine, enabling the recursion tier (proof verified inside the
next machine's witness).

Counterpart of pil2-stark-js src/pil2circom.js + the EJS template
circuits.gl/stark_verifier.circom.ejs — but the circuit text here is fully
generated: the Fiat-Shamir transcript is *replayed symbolically* (the same
sponge code as hash/transcript.py, recording Poseidon calls and output
uses), and the constraint/DEEP programs are printed from the setup
compiler's verifier TACs (verifierInfo.qVerifier / queryVerifier).

Output: {"verifier.circom": ..., plus the gadget library files from
compiler.circom_gadgets}.  Structure mirrors the reference verifier
circuit template-for-template (calculateFRIQueries / Transcript /
VerifyFRI / VerifyEvaluations / CalculateFRIPolValue / VerifyQuery /
MapValues / VerifyFinalPol / StarkVerifier) so reference tooling and the
C12 compressor row layout apply unchanged.
"""
from __future__ import annotations

from ..field import gl64, f3
from . import circom_gadgets

P = gl64.P_INT


# ---------------------------------------------------------------------------
# symbolic transcript


class SymTranscript:
    """Replays the transcript.js sponge symbolically: values are circom
    expressions; every permutation is recorded as a Poseidon(12) call."""

    def __init__(self, name_prefix="transcriptHash_"):
        self.prefix = name_prefix
        self.state = ["0", "0", "0", "0"]
        self.pending = []
        self.out = []
        self.hashes = []  # [(name, inputs8, capacity4)]
        self.used = []  # per hash: set of used output indices

    def put(self, expr: str):
        self.out = []
        self.pending.append(expr)
        if len(self.pending) == 8:
            self._update()

    def _update(self):
        while len(self.pending) < 8:
            self.pending.append("0")
        name = f"{self.prefix}{len(self.hashes)}"
        self.hashes.append((name, list(self.pending), list(self.state)))
        self.used.append(set())
        self.out = [(len(self.hashes) - 1, i) for i in range(12)]
        self.pending = []
        self.state = [f"{name}[{i}]" for i in range(4)]
        for i in range(4):
            self.used[-1].add(i)  # chained capacity counts as used

    def get_fields1(self) -> str:
        if not self.out:
            self._update()
        h, i = self.out.pop(0)
        self.used[h].add(i)
        return f"{self.prefix}{h}[{i}]"

    def get_state_exprs(self) -> list:
        """transcript.js getState: flush pending, return the 4 state
        expressions (used for the hashCommits sub-transcripts)."""
        if self.pending:
            self._update()
        return list(self.state)

    def get_field(self):
        return [self.get_fields1() for _ in range(3)]

    def render(self, assignments) -> list:
        """Interleave hash declarations with the challenge assignments.
        `assignments` = [(hash_index_after_which, line), ...]."""
        lines = []
        by_hash = {}
        for h, line in assignments:
            by_hash.setdefault(h, []).append(line)
        for hi, (name, inputs, cap) in enumerate(self.hashes):
            ins = ",".join(inputs)
            caps = ",".join(cap)
            lines.append(
                f"    signal {name}[12] <== Poseidon(12)([{ins}], [{caps}]);"
            )
            for line in by_hash.get(hi, []):
                lines.append(line)
            unused = [i for i in range(12) if i not in self.used[hi]]
            for i in unused:
                lines.append(f"    _ <== {name}[{i}]; // unused squeeze slot")
        return lines

    def hash_index(self):
        return len(self.hashes) - 1


# ---------------------------------------------------------------------------
# TAC -> circom signal stream


class TacPrinter:
    """Prints a verifier TAC program as a stream of circom signals, one
    per instruction (the stark_verifier EJS code-emission semantics)."""

    def __init__(self, stark_info, ref_hook):
        self.stark_info = stark_info
        self.ref_hook = ref_hook  # maps a src ref -> (dim, comps) or None
        self.lines = []
        self.tmp_dims = {}

    # a value is (dim, comps): dim 1 -> [e]; dim 3 -> [e0, e1, e2]
    def val(self, r):
        t = r["type"]
        if t == "tmp":
            d = self.tmp_dims[r["id"]]
            if d == 1:
                return (1, [f"tmp_{r['id']}"])
            return (3, [f"tmp_{r['id']}[{k}]" for k in range(3)])
        if t == "number":
            return (1, [str(int(r["value"]) % P)])
        if t == "eval":
            return (3, [f"evals[{r['id']}][{k}]" for k in range(3)])
        if t == "public":
            return (1, [f"publics[{r['id']}]"])
        if t == "subproofValue":
            return (3, [f"subproofValues[{r['id']}][{k}]" for k in range(3)])
        if t == "challenge":
            return (3, self.challenge_comps(r))
        out = self.ref_hook(r)
        if out is None:
            raise ValueError(f"unsupported verifier ref {t}")
        return out

    def challenge_comps(self, r):
        si = self.stark_info
        stage = r["stage"]
        sid = r["stageId"]
        n_stages = si["nStages"]
        if stage <= n_stages:
            base = f"challengesStage{stage}[{sid}]"
        elif stage == n_stages + 1:
            base = "challengeQ"
        elif stage == n_stages + 2:
            base = "challengeXi"
        else:
            base = f"challengesFRI[{sid}]"
        return [f"{base}[{k}]" for k in range(3)]

    def arr_name(self, r):
        """Whole dim-3 array expression for CMul args (signal arrays)."""
        t = r["type"]
        if t == "tmp":
            return f"tmp_{r['id']}"
        if t == "eval":
            return f"evals[{r['id']}]"
        if t == "subproofValue":
            return f"subproofValues[{r['id']}]"
        if t == "challenge":
            si = self.stark_info
            stage, sid = r["stage"], r["stageId"]
            n_stages = si["nStages"]
            if stage <= n_stages:
                return f"challengesStage{stage}[{sid}]"
            if stage == n_stages + 1:
                return "challengeQ"
            if stage == n_stages + 2:
                return "challengeXi"
            return f"challengesFRI[{sid}]"
        return None

    @staticmethod
    def _neg(e):
        if e == "0":
            return "0"
        return f"-{e}" if not e.startswith("-") else e[1:]

    def emit(self, inst):
        op = inst["op"]
        dest = inst["dest"]
        assert dest["type"] == "tmp", f"verifier TAC writes {dest['type']}"
        tid = dest["id"]
        name = f"tmp_{tid}"
        srcs = inst["src"]

        if op == "copy":
            d, c = self.val(srcs[0])
            dd = dest.get("dim", d)
            if dd == 3 and d == 1:
                self.lines.append(
                    f"    signal {name}[3] <== [{c[0]}, 0, 0];"
                )
                self.tmp_dims[tid] = 3
            elif d == 3:
                arr = self.arr_name(srcs[0])
                rhs = arr if arr else f"[{c[0]}, {c[1]}, {c[2]}]"
                self.lines.append(f"    signal {name}[3] <== {rhs};")
                self.tmp_dims[tid] = 3
            else:
                self.lines.append(f"    signal {name} <== {c[0]};")
                self.tmp_dims[tid] = 1
            return

        (da, ca) = self.val(srcs[0])
        (db, cb) = self.val(srcs[1])

        if op in ("add", "sub"):
            sgn = "+" if op == "add" else "-"
            if da == 1 and db == 1:
                self.lines.append(f"    signal {name} <== {ca[0]} {sgn} {cb[0]};")
                self.tmp_dims[tid] = 1
                return
            comps = []
            for k in range(3):
                a = ca[k] if da == 3 else (ca[0] if k == 0 else None)
                b = cb[k] if db == 3 else (cb[0] if k == 0 else None)
                if a is None:
                    comps.append(cb[k] if op == "add" else self._neg(cb[k]))
                elif b is None:
                    comps.append(a)
                else:
                    comps.append(f"{a} {sgn} {b}")
            self.lines.append(
                f"    signal {name}[3] <== [{comps[0]}, {comps[1]}, {comps[2]}];"
            )
            self.tmp_dims[tid] = 3
            return

        if op == "mul":
            if da == 3 and db == 3:
                aa = self.arr_name(srcs[0])
                bb = self.arr_name(srcs[1])
                assert aa and bb, "CMul operands must be signal arrays"
                self.lines.append(f"    signal {name}[3] <== CMul()({aa}, {bb});")
                self.tmp_dims[tid] = 3
                return
            if da == 1 and db == 1:
                self.lines.append(f"    signal {name} <== {ca[0]} * {cb[0]};")
                self.tmp_dims[tid] = 1
                return
            # ext × base: scale each component
            if da == 1:
                da, ca, db, cb = db, cb, da, ca
            s = cb[0]
            comps = [f"{ca[k]} * {s}" for k in range(3)]
            self.lines.append(
                f"    signal {name}[3] <== [{comps[0]}, {comps[1]}, {comps[2]}];"
            )
            self.tmp_dims[tid] = 3
            return

        raise ValueError(f"unsupported verifier TAC op {op}")

    def run(self, code):
        for inst in code:
            self.emit(inst)
        return self.lines


# ---------------------------------------------------------------------------
# section helpers


def _stage_widths(stark_info):
    """[(tree_index 1.., section name, width)] for committed stages."""
    out = []
    for i in range(stark_info["nStages"] + 1):
        out.append((i + 1, f"cm{i + 1}", stark_info["mapSectionsN"][f"cm{i + 1}"]))
    return out


def _tree_pols(stark_info, stage):
    """Pols of one stage section ordered by stagePos -> (polIdx, dim)."""
    pols = [
        (p["stagePos"], p["dim"])
        for p in stark_info["cmPolsMap"]
        if p["stage"] == stage
    ]
    return sorted(pols)


def _n_challenges(stark_info, stage):
    return sum(1 for c in stark_info["challengesMap"] if c["stage"] == stage)


def _ch_stages(stark_info):
    """Witness stages (2..nStages) that actually carry challenges —
    stages with none emit NO challengesStage signal, matching the
    reference template's `if(...length === 0) continue` skip
    (stark_verifier.circom.ejs:781-786)."""
    return [
        s for s in range(2, stark_info["nStages"] + 1)
        if _n_challenges(stark_info, s) > 0
    ]


# ---------------------------------------------------------------------------
# template emitters


def gen_fri_queries(idx, stark_info):
    ss = stark_info["starkStruct"]
    nq = ss["nQueries"]
    qbits = ss["steps"][0]["nBits"]
    total = nq * qbits
    n_fields = (total - 1) // 63 + 1

    # fresh transcript seeded with the query challenge (transcript.js:59-84)
    t = SymTranscript("transcriptHash_friQueries_")
    for k in range(3):
        t.put(f"challengeFRIQueries[{k}]")
    fields = [t.get_fields1() for _ in range(n_fields)]

    lines = [
        "// FRI query positions: squeeze ceil(nQueries*stepBits/63) field",
        "// elements and consume 63 usable bits from each",
        f"template calculateFRIQueries{idx}() {{",
        "    signal input challengeFRIQueries[3];",
        f"    signal output queriesFRI[{nq}][{qbits}];",
        "",
    ]
    lines += t.render([])
    for fi, fexpr in enumerate(fields):
        lines.append(
            f"    signal bits_{fi}[64] <== Num2Bits_strict()({fexpr});"
        )
    lines.append("")
    lines.append("    var q = 0;")
    lines.append("    var b = 0;")
    consumed = 0
    for fi in range(n_fields):
        take = min(63, total - consumed)
        consumed += take
        lines.append(f"    for (var j = 0; j < {take}; j++) {{")
        lines.append(f"        queriesFRI[q][b] <== bits_{fi}[j];")
        lines.append("        b++;")
        lines.append(f"        if (b == {qbits}) {{ b = 0; q++; }}")
        lines.append("    }")
        lines.append(f"    for (var j = {take}; j < 64; j++) {{ _ <== bits_{fi}[j]; }}")
    lines.append("}")
    return "\n".join(lines)


def gen_transcript(idx, stark_info, const_root):
    si = stark_info
    ss = si["starkStruct"]
    n_stages = si["nStages"]
    n_evals = len(si["evMap"])
    n_publics = si["nPublics"]
    steps = ss["steps"]
    last_pol_n = 1 << steps[-1]["nBits"]

    hash_commits = bool(ss.get("hashCommits"))

    t = SymTranscript()
    assigns = []  # (after hash index, line)
    sub_blocks = []  # rendered hashCommits sub-transcripts

    def squeeze3(target):
        comps = t.get_field()
        assigns.append(
            (t.hash_index(), f"    {target} <== [{comps[0]}, {comps[1]}, {comps[2]}];")
        )

    def sub_state(prefix, exprs, target):
        """hashCommits sub-transcript: absorb exprs into a fresh sponge,
        bind its 4-element state to `target` (stark_verifier.circom.ejs
        :304-371 semantics)."""
        sub = SymTranscript(f"transcriptHash_{prefix}_")
        for e in exprs:
            sub.put(e)
        state = sub.get_state_exprs()
        lines = sub.render([])
        lines.append(
            f"    signal {target}[4] <== [{state[0]}, {state[1]}, {state[2]}, {state[3]}];"
        )
        sub_blocks.append("\n".join(lines))
        for k in range(4):
            t.put(f"{target}[{k}]")

    # absorb order: calculateTranscriptVerify.js:7-103 (GL), with the
    # hashCommits variant absorbing sub-transcript states instead of the
    # raw publics / evals / final-polynomial values
    for k in range(4):
        t.put(f"rootC[{k}]")
    if hash_commits:
        sub_state("publics", [f"publics[{k}]" for k in range(n_publics)],
                  "publicsHash")
    else:
        for k in range(n_publics):
            t.put(f"publics[{k}]")
    for stage in range(1, n_stages + 1):
        for c in range(_n_challenges(si, stage)):
            squeeze3(f"challengesStage{stage}[{c}]")
        for k in range(4):
            t.put(f"root{stage}[{k}]")
    squeeze3("challengeQ")
    for k in range(4):
        t.put(f"root{n_stages + 1}[{k}]")
    squeeze3("challengeXi")
    if hash_commits:
        sub_state(
            "evals",
            [f"evals[{e}][{k}]" for e in range(n_evals) for k in range(3)],
            "evalsHash",
        )
    else:
        for e in range(n_evals):
            for k in range(3):
                t.put(f"evals[{e}][{k}]")
    squeeze3("challengesFRI[0]")
    squeeze3("challengesFRI[1]")
    for s in range(len(steps)):
        squeeze3(f"challengesFRISteps[{s}]")
        if s < len(steps) - 1:
            for k in range(4):
                t.put(f"s{s + 1}_root[{k}]")
        elif hash_commits:
            sub_state(
                "lastPolFRI",
                [f"finalPol[{g}][{k}]" for g in range(last_pol_n) for k in range(3)],
                "lastPolFRIHash",
            )
        else:
            for g in range(last_pol_n):
                for k in range(3):
                    t.put(f"finalPol[{g}][{k}]")
    squeeze3(f"challengesFRISteps[{len(steps)}]")

    lines = [f"template Transcript{idx}() {{"]
    lines.append(f"    signal input publics[{n_publics}];")
    lines.append("    signal input rootC[4];")
    for stage in range(1, n_stages + 2):
        lines.append(f"    signal input root{stage}[4];")
    lines.append(f"    signal input evals[{n_evals}][3];")
    for s in range(1, len(steps)):
        lines.append(f"    signal input s{s}_root[4];")
    lines.append(f"    signal input finalPol[{last_pol_n}][3];")
    lines.append("")
    for stage in _ch_stages(si):
        lines.append(
            f"    signal output challengesStage{stage}[{_n_challenges(si, stage)}][3];"
        )
    lines.append("    signal output challengeQ[3];")
    lines.append("    signal output challengeXi[3];")
    lines.append("    signal output challengesFRI[2][3];")
    lines.append(
        f"    signal output challengesFRISteps[{len(steps) + 1}][3];"
    )
    nq = ss["nQueries"]
    qb = steps[0]["nBits"]
    lines.append(f"    signal output queriesFRI[{nq}][{qb}];")
    lines.append("")
    for blk in sub_blocks:
        lines.append(blk)
        lines.append("")
    lines += t.render(assigns)
    lines.append("")
    lines.append(
        f"    queriesFRI <== calculateFRIQueries{idx}()(challengesFRISteps[{len(steps)}]);"
    )
    lines.append("}")
    return "\n".join(lines)


def gen_verify_fri(idx):
    return """// One FRI fold check: group iFFT -> Horner at the fold challenge ->
// compare against the matching element of the next step (fri.js:107-174)
template parallel VerifyFRI%d(nBitsExt, prevStepBits, currStepBits, nextStepBits, e0) {
    var nextStep = currStepBits - nextStepBits;
    var step = prevStepBits - currStepBits;

    signal input queriesFRI[currStepBits];
    signal input friChallenge[3];
    signal input s_vals_curr[1 << step][3];
    signal input s_vals_next[1 << nextStep][3];
    signal input enable;

    // sinv = 1/(shift * w^idx) built bit-by-bit from the query bits
    signal sx[currStepBits];
    sx[0] <== e0 * (queriesFRI[0] * (invroots(prevStepBits) - 1) + 1);
    for (var i = 1; i < currStepBits; i++) {
        sx[i] <== sx[i-1] * (queriesFRI[i] * (invroots(prevStepBits - i) - 1) + 1);
    }

    signal coefs[1 << step][3] <== FFT(step, 3, 1)(s_vals_curr);
    signal evalXprime[3] <== [friChallenge[0] * sx[currStepBits - 1], friChallenge[1] * sx[currStepBits - 1], friChallenge[2] * sx[currStepBits - 1]];
    signal evalPol[3] <== EvalPol(1 << step)(coefs, evalXprime);

    signal keys_lowValues[nextStep];
    for (var i = 0; i < nextStep; i++) { keys_lowValues[i] <== queriesFRI[i + nextStepBits]; }
    signal lowValues[3] <== TreeSelector(nextStep, 3)(s_vals_next, keys_lowValues);

    for (var e = 0; e < 3; e++) {
        enable * (lowValues[e] - evalPol[e]) === 0;
    }
}""" % idx


def gen_verify_evaluations(idx, stark_info, verifier_info):
    si = stark_info
    ss = si["starkStruct"]
    n_bits = ss["nBits"]
    n_stages = si["nStages"]
    n_evals = len(si["evMap"])
    q_deg = si["qDeg"]

    boundaries = si["boundaries"]
    frames = [b for b in boundaries if b["name"] == "everyFrame"]

    def ref_hook(r):
        t = r["type"]
        if t == "x":
            return (3, [f"challengeXi[{k}]" for k in range(3)])
        if t == "Zi":
            b = boundaries[r["boundaryId"]]
            if b["name"] == "everyRow":
                return (3, [f"Zh[{k}]" for k in range(3)])
            if b["name"] == "firstRow":
                return (3, [f"Z_fr[{k}]" for k in range(3)])
            if b["name"] == "lastRow":
                return (3, [f"Z_lr[{k}]" for k in range(3)])
            fid = next(
                i
                for i, fb in enumerate(frames)
                if fb.get("offsetMin") == b.get("offsetMin")
                and fb.get("offsetMax") == b.get("offsetMax")
            )
            return (3, [f"Z_frame{fid}[{k}]" for k in range(3)])
        return None

    printer = TacPrinter(si, ref_hook)
    # Zi/x arr names for CMul
    orig_arr = printer.arr_name

    def arr_name(r):
        if r["type"] == "Zi":
            d, comps = ref_hook(r)
            return comps[0].split("[")[0]
        if r["type"] == "x":
            return "challengeXi"
        return orig_arr(r)

    printer.arr_name = arr_name

    lines = [
        "// Recompute the composite constraint polynomial from the openings",
        "// and check it against the Q chunks: C(z)·Zh(z)^-1 == Σ z^(N·i)·Q_i(z)",
        f"template parallel VerifyEvaluations{idx}() {{",
    ]
    for stage in _ch_stages(si):
        lines.append(
            f"    signal input challengesStage{stage}[{_n_challenges(si, stage)}][3];"
        )
    lines.append("    signal input challengeQ[3];")
    lines.append("    signal input challengeXi[3];")
    lines.append(f"    signal input evals[{n_evals}][3];")
    if si["nPublics"]:
        lines.append(f"    signal input publics[{si['nPublics']}];")
    if si.get("nSubproofValues"):
        lines.append(
            f"    signal input subproofValues[{si['nSubproofValues']}][3];"
        )
    lines.append("    signal input enable;")
    lines.append("")
    lines.append("    // z^(2^k) chain up to z^N")
    lines.append(f"    signal zMul[{n_bits}][3];")
    lines.append(f"    for (var i = 0; i < {n_bits}; i++) {{")
    lines.append("        if (i == 0) { zMul[i] <== CMul()(challengeXi, challengeXi); }")
    lines.append("        else { zMul[i] <== CMul()(zMul[i-1], zMul[i-1]); }")
    lines.append("    }")
    lines.append("")
    lines.append(
        f"    signal Z[3] <== [zMul[{n_bits - 1}][0] - 1, zMul[{n_bits - 1}][1], zMul[{n_bits - 1}][2]];"
    )
    lines.append("    signal Zh[3] <== CInv()(Z);")

    names = [b["name"] for b in boundaries]
    if "firstRow" in names:
        lines.append("    // Z_fr = (z^N - 1)/(z - 1)")
        lines.append("    signal ZfrDen[3] <== [challengeXi[0] - 1, challengeXi[1], challengeXi[2]];")
        lines.append("    signal ZfrDenInv[3] <== CInv()(ZfrDen);")
        lines.append("    signal Z_fr[3] <== CMul()(Z, ZfrDenInv);")
    if "lastRow" in names:
        root = pow(gl64.w(n_bits), (1 << n_bits) - 1, P)
        lines.append("    // Z_lr = (z^N - 1)/(z - w^(N-1))")
        lines.append(f"    signal ZlrDen[3] <== [challengeXi[0] - {root}, challengeXi[1], challengeXi[2]];")
        lines.append("    signal ZlrDenInv[3] <== CInv()(ZlrDen);")
        lines.append("    signal Z_lr[3] <== CMul()(Z, ZlrDenInv);")
    for fi, frame in enumerate(frames):
        lines.append(f"    // frame zerofier {fi}: Π (z - w^j) over the frame rows")
        terms = []
        for j in range(frame["offsetMin"]):
            terms.append(pow(gl64.w(n_bits), j, P))
        for j in range(frame["offsetMax"]):
            terms.append(pow(gl64.w(n_bits), (1 << n_bits) - j - 1, P))
        prev = None
        for tj, root in enumerate(terms):
            lines.append(
                f"    signal Zf{fi}_t{tj}[3] <== [challengeXi[0] - {root}, challengeXi[1], challengeXi[2]];"
            )
            if prev is None:
                prev = f"Zf{fi}_t{tj}"
            else:
                lines.append(
                    f"    signal Zf{fi}_m{tj}[3] <== CMul()({prev}, Zf{fi}_t{tj});"
                )
                prev = f"Zf{fi}_m{tj}"
        lines.append(f"    signal Z_frame{fi}[3] <== {prev};")
    lines.append("")

    code = verifier_info["qVerifier"]["code"]
    lines += printer.run(code[:-1])
    # last instruction's dest is the final accumulated value
    last = code[-1]
    printer.emit(last)
    lines.append(printer.lines[-1])
    res_name = f"tmp_{last['dest']['id']}"

    # Q recomposition: Σ xAcc^i · eval(Q_i), xAcc step = z^N = zMul[nBits-1]
    q_index = next(
        i
        for i, p in enumerate(si["cmPolsMap"])
        if p["stage"] == n_stages + 1 and p.get("stageId") == 0
    )
    ev_ids = []
    for i in range(q_deg):
        ev_ids.append(
            next(
                j
                for j, e in enumerate(si["evMap"])
                if e["type"] == "cm" and e["id"] == q_index + i
            )
        )
    lines.append("")
    lines.append(f"    signal xAcc[{q_deg}][3];")
    lines.append(f"    signal qAcc[{q_deg}][3];")
    if q_deg > 1:
        lines.append(f"    signal qStep[{q_deg - 1}][3];")
    for i in range(q_deg):
        if i == 0:
            lines.append("    xAcc[0] <== [1, 0, 0];")
            lines.append(f"    qAcc[0] <== evals[{ev_ids[0]}];")
        else:
            lines.append(
                f"    xAcc[{i}] <== CMul()(xAcc[{i - 1}], zMul[{n_bits - 1}]);"
            )
            lines.append(
                f"    qStep[{i - 1}] <== CMul()(xAcc[{i}], evals[{ev_ids[i]}]);"
            )
            lines.append(
                f"    qAcc[{i}] <== [qAcc[{i - 1}][0] + qStep[{i - 1}][0], qAcc[{i - 1}][1] + qStep[{i - 1}][1], qAcc[{i - 1}][2] + qStep[{i - 1}][2]];"
            )
    lines.append("")
    lines.append("    // the TAC's Zi factor is already folded into the result")
    lines.append("    for (var e = 0; e < 3; e++) {")
    lines.append(f"        enable * ({res_name}[e] - qAcc[{q_deg - 1}][e]) === 0;")
    lines.append("    }")
    lines.append("}")
    return "\n".join(lines)


def gen_map_values(idx, stark_info):
    si = stark_info
    lines = ["// Split each tree's flat leaf row into per-polynomial signals"]
    lines.append(f"template MapValues{idx}() {{")
    decls = []
    assigns = []
    for tree_i, section, width in _stage_widths(si):
        if width == 0:
            continue
        lines.append(f"    signal input vals{tree_i}[{width}];")
        pols = _tree_pols(si, tree_i)
        for pj, (pos, dim) in enumerate(pols):
            if dim == 1:
                decls.append(f"    signal output tree{tree_i}_{pj};")
                assigns.append(f"    tree{tree_i}_{pj} <== vals{tree_i}[{pos}];")
            else:
                decls.append(f"    signal output tree{tree_i}_{pj}[3];")
                assigns.append(
                    f"    tree{tree_i}_{pj} <== [vals{tree_i}[{pos}], vals{tree_i}[{pos + 1}], vals{tree_i}[{pos + 2}]];"
                )
    lines += decls
    lines += assigns
    lines.append("}")
    return "\n".join(lines)


def gen_calculate_fri_pol(idx, stark_info, verifier_info):
    si = stark_info
    ss = si["starkStruct"]
    n_bits_ext = ss["nBitsExt"]
    n_bits = ss["nBits"]
    n_evals = len(si["evMap"])
    openings = si["openingPoints"]

    # treePos -> (tree index, pol index, dim) lookup per stage
    pol_lookup = {}
    for tree_i, section, width in _stage_widths(si):
        pols = _tree_pols(si, tree_i)
        for pj, (pos, dim) in enumerate(pols):
            pol_lookup[(tree_i, pos)] = (pj, dim)

    def ref_hook(r):
        t = r["type"]
        if t.startswith("tree"):
            tree_i = int(t[4:])
            pj, dim = pol_lookup[(tree_i, r["treePos"])]
            if r["dim"] == 1:
                return (1, [f"mapValues.tree{tree_i}_{pj}"])
            return (3, [f"mapValues.tree{tree_i}_{pj}[{k}]" for k in range(3)])
        if t == "const":
            return (1, [f"consts[{r['id']}]"])
        if t == "xDivXSubXi":
            return (3, [f"xDivXSubXi[{r['id']}][{k}]" for k in range(3)])
        return None

    printer = TacPrinter(si, ref_hook)
    orig_arr = printer.arr_name

    def arr_name(r):
        if r["type"].startswith("tree"):
            tree_i = int(r["type"][4:])
            pj, dim = pol_lookup[(tree_i, r["treePos"])]
            return f"mapValues.tree{tree_i}_{pj}"
        if r["type"] == "xDivXSubXi":
            return f"xDivXSubXi[{r['id']}]"
        return orig_arr(r)

    printer.arr_name = arr_name

    lines = [
        "// Reconstruct the DEEP/FRI composition value at one query point",
        f"template parallel CalculateFRIPolValue{idx}() {{",
        f"    signal input queriesFRI[{n_bits_ext}];",
        "    signal input challengeXi[3];",
        "    signal input challengesFRI[2][3];",
        f"    signal input evals[{n_evals}][3];",
    ]
    for tree_i, section, width in _stage_widths(si):
        if width:
            lines.append(f"    signal input tree{tree_i}[{width}];")
    lines.append(f"    signal input consts[{si['nConstants']}];")
    lines.append("    signal output queryVals[3];")
    lines.append("")
    lines.append(f"    component mapValues = MapValues{idx}();")
    for tree_i, section, width in _stage_widths(si):
        if width:
            lines.append(f"    mapValues.vals{tree_i} <== tree{tree_i};")
    lines.append("")
    lines.append("    // x = shift · w^idx from the query bits")
    lines.append(f"    signal xacc[{n_bits_ext}];")
    shift = gl64.SHIFT_INT
    lines.append(
        f"    xacc[0] <== queriesFRI[0]*({shift} * roots({n_bits_ext}) - {shift}) + {shift};"
    )
    lines.append(f"    for (var i = 1; i < {n_bits_ext}; i++) {{")
    lines.append(
        f"        xacc[i] <== xacc[i-1] * (queriesFRI[i]*(roots({n_bits_ext} - i) - 1) + 1);"
    )
    lines.append("    }")
    lines.append("")
    lines.append(f"    signal xDivXSubXi[{len(openings)}][3];")
    for oi, opening in enumerate(openings):
        w = pow(gl64.w(n_bits), abs(int(opening)), P)
        if opening < 0:
            w = pow(w, P - 2, P)
        lines.append(
            f"    signal den{oi}[3] <== [xacc[{n_bits_ext - 1}] - {w} * challengeXi[0], -{w} * challengeXi[1], -{w} * challengeXi[2]];"
        )
        lines.append(f"    signal den{oi}inv[3] <== CInv()(den{oi});")
        lines.append(
            f"    xDivXSubXi[{oi}] <== [xacc[{n_bits_ext - 1}] * den{oi}inv[0], xacc[{n_bits_ext - 1}] * den{oi}inv[1], xacc[{n_bits_ext - 1}] * den{oi}inv[2]];"
        )
    lines.append("")
    code = verifier_info["queryVerifier"]["code"]
    lines += printer.run(code)
    res = f"tmp_{code[-1]['dest']['id']}"
    lines.append("")
    lines.append(f"    queryVals <== {res};")
    lines.append("}")
    return "\n".join(lines)


def gen_verify_query(idx, stark_info):
    ss = stark_info["starkStruct"]
    return """// Check the recomputed FRI value against the step-1 leaf group
template parallel VerifyQuery%d(currStepBits, nextStepBits) {
    var nextStep = currStepBits - nextStepBits;
    signal input queriesFRI[%d];
    signal input queryVals[3];
    signal input s1_vals[1 << nextStep][3];
    signal input enable;

    signal keys_lowValues[nextStep];
    for (var i = 0; i < nextStep; i++) { keys_lowValues[i] <== queriesFRI[i + nextStepBits]; }
    for (var i = 0; i < nextStepBits; i++) { _ <== queriesFRI[i]; }

    signal lowValues[3] <== TreeSelector(nextStep, 3)(s1_vals, keys_lowValues);

    for (var e = 0; e < 3; e++) {
        enable * (lowValues[e] - queryVals[e]) === 0;
    }
}""" % (idx, ss["steps"][0]["nBits"])


def gen_verify_final_pol(idx, stark_info):
    ss = stark_info["starkStruct"]
    last_bits = ss["steps"][-1]["nBits"]
    n = 1 << last_bits
    deg_shift = ss["nBitsExt"] - ss["nBits"]
    max_deg_bits = last_bits - deg_shift
    start = 0 if max_deg_bits < 0 else (1 << max_deg_bits)
    return f"""// Degree bound of the last FRI polynomial: high iFFT coefficients zero
template parallel VerifyFinalPol{idx}() {{
    signal input finalPol[{n}][3];
    signal input enable;

    signal lastIFFT[{n}][3] <== FFT({last_bits}, 3, 1)(finalPol);

    for (var k = {start}; k < {n}; k++) {{
        for (var e = 0; e < 3; e++) {{
            enable * lastIFFT[k][e] === 0;
        }}
    }}
    for (var k = 0; k < {start}; k++) {{
        _ <== lastIFFT[k];
    }}
}}"""


def gen_stark_verifier(idx, stark_info, const_root, options):
    si = stark_info
    ss = si["starkStruct"]
    steps = ss["steps"]
    nq = ss["nQueries"]
    n_evals = len(si["evMap"])
    n_publics = si["nPublics"]
    ext_bits = steps[0]["nBits"]
    n_stages = si["nStages"]
    last_n = 1 << steps[-1]["nBits"]
    widths = _stage_widths(si)

    options = options or {}
    verkey_input = bool(options.get("verkeyInput"))
    enable_input = bool(options.get("enableInput"))
    input_challenges = bool(options.get("inputChallenges"))
    multi_fri = bool(options.get("multiFRI"))
    n_subproof = si.get("nSubproofValues", 0)

    lines = [f"template StarkVerifier{idx}() {{"]
    lines.append(f"    signal input publics[{n_publics}];")
    if n_subproof:
        lines.append(f"    signal input subproofValues[{n_subproof}][3];")
    for tree_i, _, _ in widths:
        lines.append(f"    signal input root{tree_i}[4];")
    if verkey_input:
        # aggregation tiers select the verification key at run time
        # (vadcop SelectVerificationKey feeds this input)
        lines.append("    signal input rootC[4]; // constant-tree commitment (input)")
    else:
        root_vals = ", ".join(str(int(v)) for v in const_root)
        decl = "signal output rootC[4]" if input_challenges else "signal rootC[4]"
        lines.append(f"    {decl} <== [{root_vals}]; // constant-tree commitment")
    lines.append(f"    signal input evals[{n_evals}][3];")
    for tree_i, _, width in widths:
        if width:
            lines.append(f"    signal input s0_vals{tree_i}[{nq}][{width}];")
    lines.append(f"    signal input s0_valsC[{nq}][{si['nConstants']}];")
    for tree_i, _, width in widths:
        if width:
            lines.append(
                f"    signal input s0_siblings{tree_i}[{nq}][{ext_bits}][4];"
            )
    lines.append(f"    signal input s0_siblingsC[{nq}][{ext_bits}][4];")
    for s in range(1, len(steps)):
        lines.append(f"    signal input s{s}_root[4];")
    for s in range(1, len(steps)):
        group = 1 << (steps[s - 1]["nBits"] - steps[s]["nBits"])
        lines.append(f"    signal input s{s}_vals[{nq}][{group * 3}];")
        lines.append(
            f"    signal input s{s}_siblings[{nq}][{steps[s]['nBits']}][4];"
        )
    lines.append(f"    signal input finalPol[{last_n}][3];")
    lines.append("")
    if enable_input:
        lines.append("    // aggregation gate: enable=0 skips every check")
        lines.append("    signal input enable;")
        lines.append("    enable * (enable - 1) === 0;")
        lines.append("    signal enabled;")
        lines.append("    enabled <== enable;")
    else:
        lines.append("    signal enabled;")
        lines.append("    enabled <== 1;")
    lines.append("")
    qv_decl = "signal output" if multi_fri else "signal"
    lines.append(f"    {qv_decl} queryVals[{nq}][3];")
    ch_decl = "signal input" if input_challenges else "signal"
    for stage in _ch_stages(si):
        lines.append(
            f"    {ch_decl} challengesStage{stage}[{_n_challenges(si, stage)}][3];"
        )
    lines.append(f"    {ch_decl} challengeQ[3];")
    lines.append(f"    {ch_decl} challengeXi[3];")
    lines.append(f"    {ch_decl} challengesFRI[2][3];")
    lines.append(f"    {ch_decl} challengesFRISteps[{len(steps) + 1}][3];")
    lines.append(f"    signal queriesFRI[{nq}][{ext_bits}];")
    lines.append("")
    if input_challenges:
        # vadcop: challenges arrive from the outer aggregation context;
        # only the query positions are derived in-circuit
        lines.append(
            f"    queriesFRI <== calculateFRIQueries{idx}()(challengesFRISteps[{len(steps)}]);"
        )
    else:
        ch_outs = [
            f"challengesStage{stage}" for stage in _ch_stages(si)
        ] + ["challengeQ", "challengeXi", "challengesFRI", "challengesFRISteps", "queriesFRI"]
        t_ins = [f"publics", "rootC"] + [f"root{i}" for i, _, _ in widths] + ["evals"]
        t_ins += [f"s{s}_root" for s in range(1, len(steps))] + ["finalPol"]
        lines.append(
            f"    ({','.join(ch_outs)}) <== Transcript{idx}()({','.join(t_ins)});"
        )
    lines.append("")
    ve_args = [
        f"challengesStage{stage}" for stage in _ch_stages(si)
    ] + ["challengeQ", "challengeXi", "evals"]
    if n_publics:
        ve_args.append("publics")
    if n_subproof:
        ve_args.append("subproofValues")
    ve_args.append("enabled")
    lines.append(f"    VerifyEvaluations{idx}()({', '.join(ve_args)});")
    lines.append("")
    # transpose vals into [width][1] / group [g][3] arrays
    for tree_i, _, width in widths:
        if width:
            lines.append(f"    var s0_vals{tree_i}_p[{nq}][{width}][1];")
    lines.append(f"    var s0_valsC_p[{nq}][{si['nConstants']}][1];")
    for s in range(1, len(steps)):
        group = 1 << (steps[s - 1]["nBits"] - steps[s]["nBits"])
        lines.append(f"    var s{s}_vals_p[{nq}][{group}][3];")
    lines.append(f"    for (var q = 0; q < {nq}; q++) {{")
    for tree_i, _, width in widths:
        if width:
            lines.append(
                f"        for (var i = 0; i < {width}; i++) {{ s0_vals{tree_i}_p[q][i][0] = s0_vals{tree_i}[q][i]; }}"
            )
    lines.append(
        f"        for (var i = 0; i < {si['nConstants']}; i++) {{ s0_valsC_p[q][i][0] = s0_valsC[q][i]; }}"
    )
    for s in range(1, len(steps)):
        group = 1 << (steps[s - 1]["nBits"] - steps[s]["nBits"])
        lines.append(f"        for (var e = 0; e < 3; e++) {{")
        lines.append(
            f"            for (var c = 0; c < {group}; c++) {{ s{s}_vals_p[q][c][e] = s{s}_vals[q][c*3 + e]; }}"
        )
        lines.append("        }")
    lines.append("    }")
    lines.append("")
    n_leaves = 1 << ext_bits
    for tree_i, _, width in widths:
        if width:
            lines.append(f"    for (var q = 0; q < {nq}; q++) {{")
            lines.append(
                f"        VerifyMerkleHash(1, {width}, {n_leaves})(s0_vals{tree_i}_p[q], s0_siblings{tree_i}[q], queriesFRI[q], root{tree_i}, enabled);"
            )
            lines.append("    }")
    lines.append(f"    for (var q = 0; q < {nq}; q++) {{")
    lines.append(
        f"        VerifyMerkleHash(1, {si['nConstants']}, {n_leaves})(s0_valsC_p[q], s0_siblingsC[q], queriesFRI[q], rootC, enabled);"
    )
    lines.append("    }")
    for s in range(1, len(steps)):
        group = 1 << (steps[s - 1]["nBits"] - steps[s]["nBits"])
        bits = steps[s]["nBits"]
        lines.append(f"    signal s{s}_keys_merkle[{nq}][{bits}];")
        lines.append(f"    for (var q = 0; q < {nq}; q++) {{")
        lines.append(
            f"        for (var i = 0; i < {bits}; i++) {{ s{s}_keys_merkle[q][i] <== queriesFRI[q][i]; }}"
        )
        lines.append(
            f"        VerifyMerkleHash(3, {group}, {1 << bits})(s{s}_vals_p[q], s{s}_siblings[q], s{s}_keys_merkle[q], s{s}_root, enabled);"
        )
        lines.append("    }")
    lines.append("")
    fri_args = ["queriesFRI[q]", "challengeXi", "challengesFRI", "evals"]
    for tree_i, _, width in widths:
        if width:
            fri_args.append(f"s0_vals{tree_i}[q]")
    fri_args.append("s0_valsC[q]")
    lines.append(f"    for (var q = 0; q < {nq}; q++) {{")
    lines.append(
        f"        queryVals[q] <== CalculateFRIPolValue{idx}()({', '.join(fri_args)});"
    )
    lines.append("    }")
    lines.append("")
    # fold chain
    for s in range(1, len(steps)):
        bits = steps[s]["nBits"]
        lines.append(f"    signal s{s}_queriesFRI[{nq}][{bits}];")
    lines.append(f"    for (var q = 0; q < {nq}; q++) {{")
    if len(steps) > 1:
        lines.append(
            f"        VerifyQuery{idx}({ext_bits}, {steps[1]['nBits']})(queriesFRI[q], queryVals[q], s1_vals_p[q], enabled);"
        )
    else:
        lines.append(
            f"        VerifyQuery{idx}({ext_bits}, 0)(queriesFRI[q], queryVals[q], finalPol, enabled);"
        )
    shift = gl64.SHIFT_INT
    shift_inv = pow(shift, P - 2, P)
    running = shift
    for s in range(1, len(steps)):
        prev_bits = steps[s - 1]["nBits"]
        curr_bits = steps[s]["nBits"]
        next_bits = steps[s + 1]["nBits"] if s < len(steps) - 1 else 0
        # e0 = 1/shift_running (shift squares once per reduction bit so far)
        reductions = ext_bits - prev_bits
        e0 = pow(shift_inv, 1 << reductions, P)
        next_vals = f"s{s + 1}_vals_p[q]" if s < len(steps) - 1 else "finalPol"
        lines.append(
            f"        for (var i = 0; i < {curr_bits}; i++) {{ s{s}_queriesFRI[q][i] <== queriesFRI[q][i]; }}"
        )
        lines.append(
            f"        VerifyFRI{idx}({ext_bits}, {prev_bits}, {curr_bits}, {next_bits}, {e0})(s{s}_queriesFRI[q], challengesFRISteps[{s}], s{s}_vals_p[q], {next_vals}, enabled);"
        )
    lines.append("    }")
    lines.append("")
    lines.append(f"    VerifyFinalPol{idx}()(finalPol, enabled);")
    lines.append("}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# top level


def pil2circom(const_root, stark_info, verifier_info, options=None, index=0):
    """Emit the verifier circuit main file (pil2circom.js:8-43)."""
    options = options or {}
    ss = stark_info["starkStruct"]
    if ss.get("verificationHashType", "GL") != "GL":
        from .pil2circom_bn128 import pil2circom_bn128

        return pil2circom_bn128(
            const_root, stark_info, verifier_info, options, index
        )

    merklehash_inc = (
        "merklehash_gpu.circom" if ss.get("splitLinearHash") else "merklehash.circom"
    )
    parts = [
        "pragma circom 2.1.0;",
        "pragma custom_templates;",
        "",
        'include "cmul.circom";',
        'include "cinv.circom";',
        'include "poseidon.circom";',
        'include "bitify.circom";',
        'include "fft.circom";',
        'include "evalpol.circom";',
        'include "treeselector4.circom";',
        f'include "{merklehash_inc}";',
        "",
        gen_fri_queries(index, stark_info),
        "",
    ]
    if not options.get("inputChallenges"):
        parts += [gen_transcript(index, stark_info, const_root), ""]
    parts += [
        gen_verify_fri(index),
        "",
        gen_verify_evaluations(index, stark_info, verifier_info),
        "",
        gen_calculate_fri_pol(index, stark_info, verifier_info),
        "",
        gen_verify_query(index, stark_info),
        "",
        gen_map_values(index, stark_info),
        "",
        gen_verify_final_pol(index, stark_info),
        "",
        gen_stark_verifier(index, stark_info, const_root, options),
        "",
    ]
    if not options.get("skipMain"):
        parts += [
            f"component main {{public [publics]}} = StarkVerifier{index}();",
            "",
        ]
    return "\n".join(parts)


def emit_circuit_files(const_root, stark_info, verifier_info, options=None):
    files = circom_gadgets.emit_gadget_files()
    files["verifier.circom"] = pil2circom(
        const_root, stark_info, verifier_info, options
    )
    return files
