"""pil2circom, BN128 tier: emit the BN254-Fr verifier circuit for a GL
STARK whose trees are Poseidon-BN254 arity-16 (verificationHashType BN128).

Counterpart of pil2-stark-js circuits.bn128/stark_verifier.circom.ejs +
src/pil2circom.js with `verificationHashType: "BN128"`: every Goldilocks
value rides one Fr signal (unnormalized, emitter-tracked max bounds — the
reference uses circom signal tags), GL arithmetic goes through the
compiler.circom_gadgets_bn128 templates, the transcript is the t=17
Poseidon sponge of hash/transcript_bn128.py replayed symbolically, and
Merkle openings check arity-16 paths (hash/merkle_bn128.py layout).

Design deviation from the reference (documented): FRI fold checks evaluate
the group inverse-DFT as a baked constant matrix (GL constants are FREE
linear combinations over Fr — only the per-coefficient normalizations cost
constraints), instead of porting the radix-4 FFT4 gate network; group sizes
are ≤ 2^4, where the O(g²) matrix is smaller than the network.
"""
from __future__ import annotations

from ..field import gl64
from ..hash import poseidon_bn128
from . import circom_gadgets_bn128 as gbn

GL_P = gl64.P_INT
FR = poseidon_bn128.P
U64 = 1 << 64


# ---------------------------------------------------------------------------
# symbolic transcript (t=17 sponge, hash/transcript_bn128.py semantics)


class SymTranscriptBN:
    def __init__(self, prefix="tH_", arity=16, custom=False):
        self.prefix = prefix
        self.arity = arity
        self.custom = custom
        self.state = "0"
        self.pending = []
        self.out = []  # squeezable element exprs
        self.hashes = []  # (name, inputs16, capacity expr)
        self.used = []
        self.limbs = []  # pending limb exprs from the last split element
        self.splits = []  # (after-hash-idx, split-line)
        self.n_splits = 0

    def put(self, expr: str):
        self.out = []
        self.limbs = []
        self.pending.append(expr)
        if len(self.pending) == self.arity:
            self._update()

    def _update(self):
        while len(self.pending) < self.arity:
            self.pending.append("0")
        name = f"{self.prefix}{len(self.hashes)}"
        self.hashes.append((name, list(self.pending), self.state))
        self.used.append(set())
        self.out = [(len(self.hashes) - 1, i) for i in range(self.arity + 1)]
        self.pending = []
        self.state = f"{name}[0]"
        self.used[-1].add(0)  # chained capacity counts as used
        self.limbs = []

    def get_fields253(self) -> str:
        if not self.out:
            self._update()
        h, i = self.out.pop(0)
        self.used[h].add(i)
        return f"{self.prefix}{h}[{i}]"

    def get_fields1(self) -> str:
        if not self.limbs:
            el = self.get_fields253()
            name = f"{self.prefix}gl{self.n_splits}"
            self.n_splits += 1
            self.splits.append(
                (len(self.hashes) - 1, f"    signal {name}[3] <== Bn1toGL3()({el});")
            )
            self.limbs = [f"{name}[{k}]" for k in range(3)]
        return self.limbs.pop(0)

    def get_field(self):
        return [self.get_fields1() for _ in range(3)]

    def render(self, assignments) -> list:
        lines = []
        by_hash = {}
        for h, line in assignments:
            by_hash.setdefault(h, []).append(line)
        for h, line in self.splits:
            by_hash.setdefault(h, []).append(line)
        # splits must precede their consumers: emit split lines first
        t = self.arity + 1
        tmpl = (
            f"CustomPoseidon({self.arity})" if self.custom
            else f"PoseidonBN{t}()"
        )
        for hi, (name, inputs, cap) in enumerate(self.hashes):
            ins = ", ".join(inputs)
            lines.append(
                f"    signal {name}[{t}] <== {tmpl}([{ins}], {cap});"
            )
            entries = by_hash.get(hi, [])
            entries.sort(key=lambda s: 0 if "Bn1toGL3" in s else 1)
            lines.extend(entries)
            unused = [i for i in range(t) if i not in self.used[hi]]
            for i in unused:
                lines.append(f"    _ <== {name}[{i}]; // unused squeeze slot")
        return lines

    def hash_index(self):
        return len(self.hashes) - 1


# ---------------------------------------------------------------------------
# TAC -> GL-in-Fr signal stream


class BnTacPrinter:
    """Each TAC value is a 3-limb Fr signal array with a tracked max bound.
    add/sub are free linear combos; mul goes through GLCMulAdd."""

    def __init__(self, stark_info, ref_hook, name_prefix="tmp_"):
        self.stark_info = stark_info
        self.ref_hook = ref_hook  # r -> (comps3, maxnum) or None
        self.lines = []
        self.vals = {}  # tmp id -> (comps, maxnum)
        self.prefix = name_prefix
        self.n_aux = 0

    def val(self, r):
        t = r["type"]
        if t == "tmp":
            return self.vals[r["id"]]
        if t == "number":
            v = int(r["value"]) % GL_P
            return ([str(v), "0", "0"], max(v + 1, 1))
        if t == "eval":
            return ([f"evals[{r['id']}][{k}]" for k in range(3)], GL_P)
        if t == "public":
            return ([f"publics[{r['id']}]", "0", "0"], GL_P)
        if t == "challenge":
            si = self.stark_info
            stage, sid = r["stage"], r["stageId"]
            n_stages = si["nStages"]
            if stage <= n_stages:
                base = f"challengesStage{stage}[{sid}]"
            elif stage == n_stages + 1:
                base = "challengeQ"
            elif stage == n_stages + 2:
                base = "challengeXi"
            else:
                base = f"challengesFRI[{sid}]"
            return ([f"{base}[{k}]" for k in range(3)], U64)
        out = self.ref_hook(r)
        if out is None:
            raise ValueError(f"unsupported verifier ref {r['type']}")
        return out

    def _fresh(self):
        self.n_aux += 1
        return f"{self.prefix}aux{self.n_aux}"

    def materialize(self, comps, maxnum):
        """Ensure the value is a named signal array (for component args)."""
        if comps[0].endswith("[0]"):
            base = comps[0][:-3]
            if comps[1] == f"{base}[1]" and comps[2] == f"{base}[2]":
                return base
        name = self._fresh()
        self.lines.append(
            f"    signal {name}[3] <== [{comps[0]}, {comps[1]}, {comps[2]}];"
        )
        return name

    def emit(self, inst):
        op = inst["op"]
        dest = inst["dest"]
        assert dest["type"] == "tmp"
        tid = dest["id"]
        name = f"{self.prefix}{tid}"
        srcs = [self.val(s) for s in inst["src"]]

        if op == "copy":
            (ca, ma) = srcs[0]
            self.lines.append(
                f"    signal {name}[3] <== [{ca[0]}, {ca[1]}, {ca[2]}];"
            )
            self.vals[tid] = ([f"{name}[{k}]" for k in range(3)], ma)
            return

        (ca, ma) = srcs[0]
        (cb, mb) = srcs[1]

        def par(e):
            return f"({e})" if (" " in e) else e

        if op == "add":
            comps = []
            for k in range(3):
                if ca[k] == "0":
                    comps.append(cb[k])
                elif cb[k] == "0":
                    comps.append(ca[k])
                else:
                    comps.append(f"{par(ca[k])} + {par(cb[k])}")
            self.vals[tid] = (comps, ma + mb)
            return
        if op == "sub":
            # a - b + k·p with k·p >= maxB (gl.circom GLSub)
            k = (mb - 1) // GL_P + 1
            off = k * GL_P
            comps = []
            for kk in range(3):
                if cb[kk] == "0":
                    comps.append(ca[kk] if ca[kk] != "0" else "0")
                elif ca[kk] == "0":
                    comps.append(f"{off} - {par(cb[kk])}")
                else:
                    comps.append(f"{par(ca[kk])} + {off} - {par(cb[kk])}")
            self.vals[tid] = (comps, ma + off)
            return
        if op in ("mul", "muladd"):
            if op == "muladd":
                (cc, mc) = srcs[2]
            else:
                cc, mc = ["0", "0", "0"], 1
            # bound check: 5·ma·mb + mc must stay far below Fr
            if 5 * ma * mb + mc >= FR:
                aname = self.materialize(ca, ma)
                nn = self._fresh()
                self.lines.append(
                    f"    signal {nn}[3] <== GLCNorm({ma})({aname});"
                )
                ca, ma = [f"{nn}[{k}]" for k in range(3)], GL_P
            a3 = self.materialize(ca, ma)
            b3 = self.materialize(cb, mb)
            c3 = self.materialize(cc, mc)
            self.lines.append(
                f"    signal {name}[3] <== GLCMulAdd({ma}, {mb}, {mc})({a3}, {b3}, {c3});"
            )
            self.vals[tid] = ([f"{name}[{k}]" for k in range(3)], U64)
            return
        raise ValueError(f"unsupported verifier TAC op {op}")

    def run(self, code):
        for inst in code:
            self.emit(inst)
        return self.lines

    def result(self, code):
        return self.vals[code[-1]["dest"]["id"]]


# ---------------------------------------------------------------------------
# helpers shared with the GL emitter


def _stage_widths(si):
    return [
        (i + 1, f"cm{i + 1}", si["mapSectionsN"][f"cm{i + 1}"])
        for i in range(si["nStages"] + 1)
    ]


def _n_challenges(si, stage):
    return sum(1 for c in si["challengesMap"] if c["stage"] == stage)


def _tree_pols(si, stage):
    return sorted(
        (p["stagePos"], p["dim"]) for p in si["cmPolsMap"] if p["stage"] == stage
    )


def _merkle_levels(height: int, arity: int = 16) -> int:
    """Number of non-root levels of the arity-N BN128 tree."""
    n, levels = height, 0
    while n > 1:
        n = -(-n // arity)
        levels += 1
    return levels


# ---------------------------------------------------------------------------
# template emitters


def _transcript_params(ss):
    custom = bool(ss.get("merkleTreeCustom"))
    arity = ss.get("merkleTreeArity", 16) if custom else 16
    return arity, custom


def gen_transcript_bn(idx, si, const_root):
    ss = si["starkStruct"]
    n_stages = si["nStages"]
    n_evals = len(si["evMap"])
    n_publics = si["nPublics"]
    steps = ss["steps"]
    last_pol_n = 1 << steps[-1]["nBits"]
    nq = ss["nQueries"]
    qb = steps[0]["nBits"]

    t_arity, t_custom = _transcript_params(ss)
    t = SymTranscriptBN(arity=t_arity, custom=t_custom)
    assigns = []

    def squeeze3(target):
        comps = t.get_field()
        assigns.append(
            (t.hash_index(), f"    {target} <== [{comps[0]}, {comps[1]}, {comps[2]}];")
        )

    t.put("rootC")
    for k in range(n_publics):
        t.put(f"publics[{k}]")
    for stage in range(1, n_stages + 1):
        for c in range(_n_challenges(si, stage)):
            squeeze3(f"challengesStage{stage}[{c}]")
        t.put(f"root{stage}")
    squeeze3("challengeQ")
    t.put(f"root{n_stages + 1}")
    squeeze3("challengeXi")
    for e in range(n_evals):
        for k in range(3):
            t.put(f"evals[{e}][{k}]")
    squeeze3("challengesFRI[0]")
    squeeze3("challengesFRI[1]")
    for s in range(len(steps)):
        squeeze3(f"challengesFRISteps[{s}]")
        if s < len(steps) - 1:
            t.put(f"s{s + 1}_root")
        else:
            for g in range(last_pol_n):
                for k in range(3):
                    t.put(f"finalPol[{g}][{k}]")
    squeeze3(f"challengesFRISteps[{len(steps)}]")

    # query positions: FRESH sponge seeded with the last FRI-step challenge
    # (transcript.bn128.js getPermutations via a new transcript,
    # calculateFRIQueries), 253 usable bits per squeezed element
    total = nq * qb
    n_fields = (total - 1) // 253 + 1
    tq = SymTranscriptBN("tHq_", arity=t_arity, custom=t_custom)
    for k in range(3):
        tq.put(f"challengesFRISteps[{len(steps)}][{k}]")
    q_fields = [tq.get_fields253() for _ in range(n_fields)]

    lines = [f"template TranscriptBN{idx}() {{"]
    lines.append(f"    signal input publics[{n_publics}];")
    lines.append("    signal input rootC;")
    for stage in range(1, n_stages + 2):
        lines.append(f"    signal input root{stage};")
    lines.append(f"    signal input evals[{n_evals}][3];")
    for s in range(1, len(steps)):
        lines.append(f"    signal input s{s}_root;")
    lines.append(f"    signal input finalPol[{last_pol_n}][3];")
    for stage in range(2, n_stages + 1):
        lines.append(
            f"    signal output challengesStage{stage}[{_n_challenges(si, stage)}][3];"
        )
    lines.append("    signal output challengeQ[3];")
    lines.append("    signal output challengeXi[3];")
    lines.append("    signal output challengesFRI[2][3];")
    lines.append(f"    signal output challengesFRISteps[{len(steps) + 1}][3];")
    lines.append(f"    signal output queriesFRI[{nq}][{qb}];")
    lines.append("")
    lines += t.render(assigns)
    lines.append("")
    lines += tq.render([])
    lines.append("")
    for fi, fexpr in enumerate(q_fields):
        lines.append(f"    signal qbits_{fi}[254] <== Num2BitsStrictBN()({fexpr});")
    lines.append("    var q = 0;")
    lines.append("    var b = 0;")
    consumed = 0
    for fi in range(n_fields):
        take = min(253, total - consumed)
        consumed += take
        lines.append(f"    for (var j = 0; j < {take}; j++) {{")
        lines.append(f"        queriesFRI[q][b] <== qbits_{fi}[j];")
        lines.append("        b++;")
        lines.append(f"        if (b == {qb}) {{ b = 0; q++; }}")
        lines.append("    }")
        lines.append(
            f"    for (var j = {take}; j < 254; j++) {{ _ <== qbits_{fi}[j]; }}"
        )
    lines.append("}")
    return "\n".join(lines)


def gen_verify_evaluations_bn(idx, si, verifier_info):
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
            return ([f"challengeXi[{k}]" for k in range(3)], U64)
        if t == "Zi":
            b = boundaries[r["boundaryId"]]
            if b["name"] == "everyRow":
                return ([f"Zh[{k}]" for k in range(3)], U64)
            if b["name"] == "firstRow":
                return ([f"Z_fr[{k}]" for k in range(3)], U64)
            if b["name"] == "lastRow":
                return ([f"Z_lr[{k}]" for k in range(3)], U64)
            fid = next(
                i
                for i, fb in enumerate(frames)
                if fb.get("offsetMin") == b.get("offsetMin")
                and fb.get("offsetMax") == b.get("offsetMax")
            )
            return ([f"Z_frame{fid}[{k}]" for k in range(3)], U64)
        return None

    printer = BnTacPrinter(si, ref_hook)
    lines = [
        "// Recompute C(z)·Zh(z)^-1 from the openings; check vs the Q chunks",
        f"template VerifyEvaluationsBN{idx}() {{",
    ]
    for stage in range(2, n_stages + 1):
        lines.append(
            f"    signal input challengesStage{stage}[{_n_challenges(si, stage)}][3];"
        )
    lines.append("    signal input challengeQ[3];")
    lines.append("    signal input challengeXi[3];")
    lines.append(f"    signal input evals[{n_evals}][3];")
    if si["nPublics"]:
        lines.append(f"    signal input publics[{si['nPublics']}];")
    lines.append("    signal input enable;")
    lines.append("")
    lines.append(f"    signal zMul[{n_bits}][3];")
    for i in range(n_bits):
        src = "challengeXi" if i == 0 else f"zMul[{i - 1}]"
        lines.append(
            f"    zMul[{i}] <== GLCMul({U64}, {U64})({src}, {src});"
        )
    # Z = z^N - 1 (+p to stay nonneg)
    lines.append(
        f"    signal Z[3] <== [zMul[{n_bits - 1}][0] + {GL_P - 1}, zMul[{n_bits - 1}][1], zMul[{n_bits - 1}][2]];"
    )
    lines.append(f"    signal Zh[3] <== GLCInv({U64 + GL_P})(Z);")
    names = [b["name"] for b in boundaries]
    if "firstRow" in names:
        lines.append(
            f"    signal ZfrDen[3] <== [challengeXi[0] + {GL_P - 1}, challengeXi[1], challengeXi[2]];"
        )
        lines.append(f"    signal ZfrDenInv[3] <== GLCInv({U64 + GL_P})(ZfrDen);")
        lines.append(
            f"    signal Z_fr[3] <== GLCMul({U64 + GL_P}, {U64})(Z, ZfrDenInv);"
        )
    if "lastRow" in names:
        root = pow(gl64.w(n_bits), (1 << n_bits) - 1, GL_P)
        lines.append(
            f"    signal ZlrDen[3] <== [challengeXi[0] + {GL_P * 2 - root}, challengeXi[1], challengeXi[2]];"
        )
        lines.append(f"    signal ZlrDenInv[3] <== GLCInv({U64 + 2 * GL_P})(ZlrDen);")
        lines.append(
            f"    signal Z_lr[3] <== GLCMul({U64 + GL_P}, {U64})(Z, ZlrDenInv);"
        )
    for fi, frame in enumerate(frames):
        terms = []
        for j in range(frame["offsetMin"]):
            terms.append(pow(gl64.w(n_bits), j, GL_P))
        for j in range(frame["offsetMax"]):
            terms.append(pow(gl64.w(n_bits), (1 << n_bits) - j - 1, GL_P))
        prev = None
        for tj, root in enumerate(terms):
            lines.append(
                f"    signal Zf{fi}_t{tj}[3] <== [challengeXi[0] + {GL_P * 2 - root}, challengeXi[1], challengeXi[2]];"
            )
            if prev is None:
                prev = f"Zf{fi}_t{tj}"
                prev_max = U64 + 2 * GL_P
            else:
                lines.append(
                    f"    signal Zf{fi}_m{tj}[3] <== GLCMul({prev_max}, {U64 + 2 * GL_P})({prev}, Zf{fi}_t{tj});"
                )
                prev = f"Zf{fi}_m{tj}"
                prev_max = U64
        lines.append(f"    signal Z_frame{fi}[3] <== {prev};")

    lines.append("")
    code = verifier_info["qVerifier"]["code"]
    lines += printer.run(code)
    res_c, res_m = printer.result(code)

    # Q recomposition: Σ (z^N)^i · eval(Q_i)
    q_index = next(
        i
        for i, p in enumerate(si["cmPolsMap"])
        if p["stage"] == n_stages + 1 and p.get("stageId") == 0
    )
    ev_ids = [
        next(
            j
            for j, e in enumerate(si["evMap"])
            if e["type"] == "cm" and e["id"] == q_index + i
        )
        for i in range(q_deg)
    ]
    lines.append("")
    acc = f"evals[{ev_ids[0]}]"
    acc_max = GL_P
    xacc = None
    for i in range(1, q_deg):
        if xacc is None:
            xacc = f"qxacc{i}"
            lines.append(
                f"    signal qxacc{i}[3] <== zMul[{n_bits - 1}];"
            )
        else:
            lines.append(
                f"    signal qxacc{i}[3] <== GLCMul({U64}, {U64})(qxacc{i - 1}, zMul[{n_bits - 1}]);"
            )
            xacc = f"qxacc{i}"
        lines.append(
            f"    signal qstep{i}[3] <== GLCMulAdd({U64}, {GL_P}, {acc_max})({xacc}, evals[{ev_ids[i]}], {acc});"
        )
        acc = f"qstep{i}"
        acc_max = U64
    lines.append("")
    lines.append(f"    signal resN[3] <== GLCNorm({res_m})([{res_c[0]}, {res_c[1]}, {res_c[2]}]);")
    lines.append(f"    signal qAccN[3] <== GLCNorm({acc_max})({acc});")
    lines.append("    for (var e = 0; e < 3; e++) {")
    lines.append("        enable * (resN[e] - qAccN[e]) === 0;")
    lines.append("    }")
    lines.append("}")
    return "\n".join(lines)


def gen_map_values_bn(idx, si):
    lines = [f"template MapValuesBN{idx}() {{"]
    decls, assigns = [], []
    for tree_i, _, width in _stage_widths(si):
        if width == 0:
            continue
        lines.append(f"    signal input vals{tree_i}[{width}];")
        for pj, (pos, dim) in enumerate(_tree_pols(si, tree_i)):
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


def gen_calculate_fri_pol_bn(idx, si, verifier_info):
    ss = si["starkStruct"]
    n_bits_ext = ss["nBitsExt"]
    n_bits = ss["nBits"]
    n_evals = len(si["evMap"])
    openings = si["openingPoints"]

    pol_lookup = {}
    for tree_i, _, width in _stage_widths(si):
        for pj, (pos, dim) in enumerate(_tree_pols(si, tree_i)):
            pol_lookup[(tree_i, pos)] = (pj, dim)

    def ref_hook(r):
        t = r["type"]
        if t.startswith("tree"):
            tree_i = int(t[4:])
            pj, dim = pol_lookup[(tree_i, r["treePos"])]
            if r["dim"] == 1:
                return ([f"mapValues.tree{tree_i}_{pj}", "0", "0"], GL_P)
            return ([f"mapValues.tree{tree_i}_{pj}[{k}]" for k in range(3)], GL_P)
        if t == "const":
            return ([f"consts[{r['id']}]", "0", "0"], GL_P)
        if t == "xDivXSubXi":
            return ([f"xDivXSubXi[{r['id']}][{k}]" for k in range(3)], U64)
        return None

    printer = BnTacPrinter(si, ref_hook)
    lines = [
        "// DEEP/FRI composition value at one query point",
        f"template CalculateFRIPolValueBN{idx}() {{",
        f"    signal input queriesFRI[{n_bits_ext}];",
        "    signal input challengeXi[3];",
        "    signal input challengesFRI[2][3];",
        f"    signal input evals[{n_evals}][3];",
    ]
    for tree_i, _, width in _stage_widths(si):
        if width:
            lines.append(f"    signal input tree{tree_i}[{width}];")
    lines.append(f"    signal input consts[{si['nConstants']}];")
    lines.append("    signal output queryVals[3];")
    lines.append("")
    lines.append(f"    component mapValues = MapValuesBN{idx}();")
    for tree_i, _, width in _stage_widths(si):
        if width:
            lines.append(f"    mapValues.vals{tree_i} <== tree{tree_i};")
    lines.append("")
    lines.append("    // x = shift · w^idx, one GL reduction per bit")
    shift = gl64.SHIFT_INT
    c0 = (pow(gl64.w(n_bits_ext), 1, GL_P) * shift - shift) % GL_P
    lines.append(
        f"    signal xbit0 <== queriesFRI[0] * {c0} + {shift};"
    )
    lines.append(f"    signal xacc[{n_bits_ext}];")
    lines.append(f"    xacc[0] <== GLNorm({2 * GL_P})(xbit0);")
    for i in range(1, n_bits_ext):
        c = pow(gl64.w(n_bits_ext), 1 << i, GL_P)
        lines.append(
            f"    signal xfac{i} <== queriesFRI[{i}] * {c - 1} + 1;"
        )
        lines.append(
            f"    xacc[{i}] <== GLMul({U64}, {GL_P})(xacc[{i - 1}], xfac{i});"
        )
    x_expr = f"xacc[{n_bits_ext - 1}]"
    lines.append("")
    lines.append(f"    signal xDivXSubXi[{len(openings)}][3];")
    for oi, opening in enumerate(openings):
        w = pow(gl64.w(n_bits), abs(int(opening)), GL_P)
        if opening < 0:
            w = pow(w, GL_P - 2, GL_P)
        # den = x - w·xi; challenge limbs are raw 64-bit, so the nonneg
        # offset must be w·2^64 (≡ 0 mod p? no — w·2^64 mod p folds into the
        # later normalization; the offset only needs den ≡ x - w·xi (mod p))
        off = ((w * U64 - 1) // GL_P + 1) * GL_P  # smallest multiple of p ≥ w·2^64
        lines.append(
            f"    signal den{oi}[3] <== [{x_expr} + {off} - challengeXi[0] * {w}, {off} - challengeXi[1] * {w}, {off} - challengeXi[2] * {w}];"
        )
        lines.append(
            f"    signal den{oi}inv[3] <== GLCInv({U64 + off})(den{oi});"
        )
        lines.append(
            f"    xDivXSubXi[{oi}][0] <== GLMul({U64}, {U64})({x_expr}, den{oi}inv[0]);"
        )
        lines.append(
            f"    xDivXSubXi[{oi}][1] <== GLMul({U64}, {U64})({x_expr}, den{oi}inv[1]);"
        )
        lines.append(
            f"    xDivXSubXi[{oi}][2] <== GLMul({U64}, {U64})({x_expr}, den{oi}inv[2]);"
        )
    lines.append("")
    code = verifier_info["queryVerifier"]["code"]
    lines += printer.run(code)
    res_c, res_m = printer.result(code)
    lines.append(
        f"    queryVals <== GLCNorm({res_m})([{res_c[0]}, {res_c[1]}, {res_c[2]}]);"
    )
    lines.append("}")
    return "\n".join(lines)


def gen_verify_fri_bn(idx, si, step_idx):
    """One fold check at compile-time-known step geometry: group iDFT as a
    baked constant matrix + Horner at the fold point + next-step compare."""
    ss = si["starkStruct"]
    steps = ss["steps"]
    ext_bits = steps[0]["nBits"]
    prev_bits = steps[step_idx - 1]["nBits"]
    curr_bits = steps[step_idx]["nBits"]
    next_bits = steps[step_idx + 1]["nBits"] if step_idx < len(steps) - 1 else 0
    step = prev_bits - curr_bits
    g = 1 << step
    next_step = curr_bits - next_bits
    shift = gl64.SHIFT_INT
    shift_inv = pow(shift, GL_P - 2, GL_P)
    e0 = pow(shift_inv, 1 << (ext_bits - prev_bits), GL_P)

    # inverse-DFT matrix over the fold group: coefs[i] = (1/g)·Σ_j w^{-ij} v_j
    wg_inv = pow(gl64.w(step), GL_P - 2, GL_P) if step > 0 else 1
    g_inv = pow(g, GL_P - 2, GL_P)
    mat = [
        [pow(wg_inv, i * j, GL_P) * g_inv % GL_P for j in range(g)]
        for i in range(g)
    ]

    lines = [
        f"// FRI fold check step {step_idx}: baked iDFT + Horner (fri.js:107-174)",
        f"template VerifyFRIBN{idx}_{step_idx}() {{",
        f"    signal input queriesFRI[{curr_bits}];",
        "    signal input friChallenge[3];",
        f"    signal input s_vals_curr[{g}][3];",
        f"    signal input s_vals_next[{1 << next_step}][3];",
        "    signal input enable;",
        "",
        "    // sinv = e0 · Π w_inv^bit — one GL reduction per bit",
    ]
    winv_bits = [
        pow(pow(gl64.w(prev_bits), GL_P - 2, GL_P), 1 << i, GL_P)
        for i in range(curr_bits)
    ]
    sc0 = (e0 * winv_bits[0] - e0) % GL_P
    lines.append(
        f"    signal sx0 <== queriesFRI[0] * {sc0} + {e0};"
    )
    lines.append(f"    signal sx[{curr_bits}];")
    lines.append(f"    sx[0] <== GLNorm({2 * GL_P})(sx0);")
    for i in range(1, curr_bits):
        lines.append(
            f"    signal sxf{i} <== queriesFRI[{i}] * {winv_bits[i] - 1} + 1;"
        )
        lines.append(
            f"    sx[{i}] <== GLMul({U64}, {GL_P})(sx[{i - 1}], sxf{i});"
        )
    sx = f"sx[{curr_bits - 1}]"
    lines.append("")
    lines.append("    // group iDFT as constant linear combos + normalization")
    lines.append(f"    signal coefs[{g}][3];")
    for i in range(g):
        comps = []
        for e in range(3):
            terms = " + ".join(
                f"{mat[i][j]} * s_vals_curr[{j}][{e}]" for j in range(g)
            )
            comps.append(terms)
        lines.append(
            f"    coefs[{i}] <== GLCNorm({g * GL_P * U64})([{comps[0]}, {comps[1]}, {comps[2]}]);"
        )
    lines.append("")
    lines.append("    // xprime = friChallenge · sinv")
    lines.append("    signal xprime[3];")
    for e in range(3):
        lines.append(
            f"    xprime[{e}] <== GLMul({U64}, {GL_P})(friChallenge[{e}], {sx});"
        )
    # Horner over coefs: acc = coefs[g-1]; acc = acc·x' + coefs[i]
    acc = f"coefs[{g - 1}]"
    for i in range(g - 2, -1, -1):
        lines.append(
            f"    signal hn{i}[3] <== GLCMulAdd({GL_P}, {U64}, {GL_P})({acc}, xprime, coefs[{i}]);"
        )
        acc = f"hn{i}"
    lines.append("")
    lines.append(f"    signal evalPolN[3] <== GLCNorm({U64})({acc});")
    lines.append("")
    # select the next-step group element at key bits [next_bits, curr_bits)
    lines.append(f"    signal keyLow[{next_step}];")
    lines.append(
        f"    for (var i = 0; i < {next_step}; i++) {{ keyLow[i] <== queriesFRI[i + {next_bits}]; }}"
    )
    lines.append(
        f"    signal oh[{1 << next_step}] <== OneHot{next_step}()(keyLow);"
    )
    lines.append(f"    signal sel[{1 << next_step}][3];")
    lines.append("    var low[3] = [0, 0, 0];")
    lines.append(f"    for (var k = 0; k < {1 << next_step}; k++) {{")
    lines.append("        for (var e = 0; e < 3; e++) {")
    lines.append("            sel[k][e] <== oh[k] * s_vals_next[k][e];")
    lines.append("            low[e] += sel[k][e];")
    lines.append("        }")
    lines.append("    }")
    lines.append(f"    signal lowN[3] <== GLCNorm({(1 << next_step) * U64})(low);")
    lines.append("    for (var e = 0; e < 3; e++) {")
    lines.append("        enable * (lowN[e] - evalPolN[e]) === 0;")
    lines.append("    }")
    lines.append("}")
    return "\n".join(lines)


def gen_verify_query_bn(idx, si):
    ss = si["starkStruct"]
    steps = ss["steps"]
    ext_bits = steps[0]["nBits"]
    next_bits = steps[1]["nBits"] if len(steps) > 1 else 0
    next_step = ext_bits - next_bits
    return f"""// Check the recomputed FRI value against the step-1 leaf group
template VerifyQueryBN{idx}() {{
    signal input queriesFRI[{ext_bits}];
    signal input queryVals[3];
    signal input s1_vals[{1 << next_step}][3];
    signal input enable;

    signal keyLow[{next_step}];
    for (var i = 0; i < {next_step}; i++) {{ keyLow[i] <== queriesFRI[i + {next_bits}]; }}
    for (var i = 0; i < {next_bits}; i++) {{ _ <== queriesFRI[i]; }}
    signal oh[{1 << next_step}] <== OneHot{next_step}()(keyLow);
    signal sel[{1 << next_step}][3];
    var low[3] = [0, 0, 0];
    for (var k = 0; k < {1 << next_step}; k++) {{
        for (var e = 0; e < 3; e++) {{
            sel[k][e] <== oh[k] * s1_vals[k][e];
            low[e] += sel[k][e];
        }}
    }}
    signal lowN[3] <== GLCNorm({(1 << next_step) * U64})(low);
    for (var e = 0; e < 3; e++) {{
        enable * (lowN[e] - queryVals[e]) === 0;
    }}
}}"""


def gen_verify_final_pol_bn(idx, si):
    ss = si["starkStruct"]
    last_bits = ss["steps"][-1]["nBits"]
    n = 1 << last_bits
    deg_shift = ss["nBitsExt"] - ss["nBits"]
    max_deg_bits = last_bits - deg_shift
    start = 0 if max_deg_bits < 0 else (1 << max_deg_bits)
    w_inv = pow(gl64.w(last_bits), GL_P - 2, GL_P) if last_bits else 1
    n_inv = pow(n, GL_P - 2, GL_P)
    lines = [
        "// Degree bound of the last FRI polynomial (baked iDFT rows)",
        f"template VerifyFinalPolBN{idx}() {{",
        f"    signal input finalPol[{n}][3];",
        "    signal input enable;",
    ]
    # only rows >= start need checking — emit exactly those iDFT rows
    for i in range(start, n):
        comps = []
        for e in range(3):
            comps.append(
                " + ".join(
                    f"{pow(w_inv, i * j, GL_P) * n_inv % GL_P} * finalPol[{j}][{e}]"
                    for j in range(n)
                )
            )
        lines.append(
            f"    signal co{i}[3] <== GLCNorm({n * GL_P * U64})([{comps[0]}, {comps[1]}, {comps[2]}]);"
        )
        lines.append(
            f"    for (var e = 0; e < 3; e++) {{ enable * co{i}[e] === 0; }}"
        )
    lines.append("}")
    return "\n".join(lines)


def gen_stark_verifier_bn(idx, si, const_root, options):
    ss = si["starkStruct"]
    steps = ss["steps"]
    nq = ss["nQueries"]
    n_evals = len(si["evMap"])
    n_publics = si["nPublics"]
    ext_bits = steps[0]["nBits"]
    n_stages = si["nStages"]
    last_n = 1 << steps[-1]["nBits"]
    widths = _stage_widths(si)
    custom = bool(ss.get("merkleTreeCustom"))
    arity = ss.get("merkleTreeArity", 16) if custom else 16
    abits = (arity - 1).bit_length()
    s0_levels = _merkle_levels(1 << ext_bits, arity)

    lines = [f"template StarkVerifierBN{idx}() {{"]
    lines.append(f"    signal input publics[{n_publics}];")
    for tree_i, _, _ in widths:
        lines.append(f"    signal input root{tree_i};")
    lines.append(f"    signal rootC <== {int(const_root)};")
    lines.append(f"    signal input evals[{n_evals}][3];")
    for tree_i, _, width in widths:
        if width:
            lines.append(f"    signal input s0_vals{tree_i}[{nq}][{width}];")
    lines.append(f"    signal input s0_valsC[{nq}][{si['nConstants']}];")
    for tree_i, _, width in widths:
        if width:
            lines.append(
                f"    signal input s0_siblings{tree_i}[{nq}][{s0_levels}][{arity}];"
            )
    lines.append(f"    signal input s0_siblingsC[{nq}][{s0_levels}][{arity}];")
    for s in range(1, len(steps)):
        lines.append(f"    signal input s{s}_root;")
        group = 1 << (steps[s - 1]["nBits"] - steps[s]["nBits"])
        levels = _merkle_levels(1 << steps[s]["nBits"], arity)
        lines.append(f"    signal input s{s}_vals[{nq}][{group * 3}];")
        lines.append(f"    signal input s{s}_siblings[{nq}][{levels}][{arity}];")
    lines.append(f"    signal input finalPol[{last_n}][3];")
    lines.append("")
    lines.append("    signal enabled <== 1;")
    for stage in range(2, n_stages + 1):
        lines.append(
            f"    signal challengesStage{stage}[{_n_challenges(si, stage)}][3];"
        )
    lines.append("    signal challengeQ[3];")
    lines.append("    signal challengeXi[3];")
    lines.append("    signal challengesFRI[2][3];")
    lines.append(f"    signal challengesFRISteps[{len(steps) + 1}][3];")
    lines.append(f"    signal queriesFRI[{nq}][{ext_bits}];")
    lines.append("")
    ch_outs = [f"challengesStage{stage}" for stage in range(2, n_stages + 1)]
    ch_outs += ["challengeQ", "challengeXi", "challengesFRI", "challengesFRISteps", "queriesFRI"]
    t_ins = ["publics", "rootC"] + [f"root{i}" for i, _, _ in widths] + ["evals"]
    t_ins += [f"s{s}_root" for s in range(1, len(steps))] + ["finalPol"]
    lines.append(
        f"    ({', '.join(ch_outs)}) <== TranscriptBN{idx}()({', '.join(t_ins)});"
    )
    lines.append("")
    ve_args = [f"challengesStage{stage}" for stage in range(2, n_stages + 1)]
    ve_args += ["challengeQ", "challengeXi", "evals"]
    if n_publics:
        ve_args.append("publics")
    ve_args.append("enabled")
    lines.append(f"    VerifyEvaluationsBN{idx}()({', '.join(ve_args)});")
    lines.append("")
    # merkle openings: key = query bits (4 per level, zero-padded)
    lines.append(f"    signal mkey[{nq}][{s0_levels * abits}];")
    lines.append(f"    for (var q = 0; q < {nq}; q++) {{")
    lines.append(f"        for (var i = 0; i < {s0_levels * abits}; i++) {{")
    lines.append(f"            if (i < {ext_bits}) {{ mkey[q][i] <== queriesFRI[q][i]; }}")
    lines.append("            else { mkey[q][i] <== 0; }")
    lines.append("        }")
    lines.append("    }")
    for tree_i, _, width in widths:
        if width:
            lines.append(f"    for (var q = 0; q < {nq}; q++) {{")
            lines.append(
                f"        VerifyMerkleBN{width}_{s0_levels}()(s0_vals{tree_i}[q], s0_siblings{tree_i}[q], mkey[q], root{tree_i}, enabled);"
            )
            lines.append("    }")
    lines.append(f"    for (var q = 0; q < {nq}; q++) {{")
    lines.append(
        f"        VerifyMerkleBN{si['nConstants']}_{s0_levels}()(s0_valsC[q], s0_siblingsC[q], mkey[q], rootC, enabled);"
    )
    lines.append("    }")
    for s in range(1, len(steps)):
        bits = steps[s]["nBits"]
        group = 1 << (steps[s - 1]["nBits"] - bits)
        levels = _merkle_levels(1 << bits, arity)
        lines.append(f"    signal s{s}_mkey[{nq}][{levels * abits}];")
        lines.append(f"    for (var q = 0; q < {nq}; q++) {{")
        lines.append(f"        for (var i = 0; i < {levels * abits}; i++) {{")
        lines.append(f"            if (i < {bits}) {{ s{s}_mkey[q][i] <== queriesFRI[q][i]; }}")
        lines.append(f"            else {{ s{s}_mkey[q][i] <== 0; }}")
        lines.append("        }")
        lines.append(
            f"        VerifyMerkleBN{group * 3}_{levels}()(s{s}_vals[q], s{s}_siblings[q], s{s}_mkey[q], s{s}_root, enabled);"
        )
        lines.append("    }")
    lines.append("")
    # group vals reshaped to [g][3]
    for s in range(1, len(steps)):
        group = 1 << (steps[s - 1]["nBits"] - steps[s]["nBits"])
        lines.append(f"    signal s{s}_vals_p[{nq}][{group}][3];")
        lines.append(f"    for (var q = 0; q < {nq}; q++) {{")
        lines.append(f"        for (var c = 0; c < {group}; c++) {{")
        lines.append("            for (var e = 0; e < 3; e++) {")
        lines.append(f"                s{s}_vals_p[q][c][e] <== s{s}_vals[q][c * 3 + e];")
        lines.append("            }")
        lines.append("        }")
        lines.append("    }")
    lines.append("")
    fri_args = ["queriesFRI[q]", "challengeXi", "challengesFRI", "evals"]
    for tree_i, _, width in widths:
        if width:
            fri_args.append(f"s0_vals{tree_i}[q]")
    fri_args.append("s0_valsC[q]")
    lines.append(f"    signal queryVals[{nq}][3];")
    lines.append(f"    for (var q = 0; q < {nq}; q++) {{")
    lines.append(
        f"        queryVals[q] <== CalculateFRIPolValueBN{idx}()({', '.join(fri_args)});"
    )
    lines.append("    }")
    lines.append("")
    for s in range(1, len(steps)):
        bits = steps[s]["nBits"]
        lines.append(f"    signal s{s}_queriesFRI[{nq}][{bits}];")
    lines.append(f"    for (var q = 0; q < {nq}; q++) {{")
    if len(steps) > 1:
        lines.append(
            f"        VerifyQueryBN{idx}()(queriesFRI[q], queryVals[q], s1_vals_p[q], enabled);"
        )
    else:
        lines.append(
            f"        VerifyQueryBN{idx}()(queriesFRI[q], queryVals[q], finalPol, enabled);"
        )
    for s in range(1, len(steps)):
        curr_bits = steps[s]["nBits"]
        next_vals = f"s{s + 1}_vals_p[q]" if s < len(steps) - 1 else "finalPol"
        lines.append(
            f"        for (var i = 0; i < {curr_bits}; i++) {{ s{s}_queriesFRI[q][i] <== queriesFRI[q][i]; }}"
        )
        lines.append(
            f"        VerifyFRIBN{idx}_{s}()(s{s}_queriesFRI[q], challengesFRISteps[{s}], s{s}_vals_p[q], {next_vals}, enabled);"
        )
    lines.append("    }")
    lines.append("")
    lines.append(f"    VerifyFinalPolBN{idx}()(finalPol, enabled);")
    lines.append("}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# top level


def pil2circom_bn128(const_root, stark_info, verifier_info, options=None, index=0):
    """Emit the BN128-tier verifier circuit main file."""
    options = options or {}
    si = stark_info
    ss = si["starkStruct"]
    assert ss.get("verificationHashType") == "BN128"
    steps = ss["steps"]
    # merkleTreeCustom: every Poseidon rides the custom PoseidonT gate at
    # the tree arity (reference pil2circom.js:25-26 + circuits.bn128/custom)
    custom = bool(ss.get("merkleTreeCustom"))
    arity = ss.get("merkleTreeArity", 16) if custom else 16

    # gadget instantiations needed: poseidon widths, linear hash widths,
    # merkle (width, levels) pairs, one-hot sizes
    t_widths = set() if custom else {17}
    lh_widths = set()
    vm_pairs = set()
    oh_sizes = {(arity - 1).bit_length()}
    s0_levels = _merkle_levels(1 << steps[0]["nBits"], arity)
    for _, _, width in _stage_widths(si):
        if width:
            lh_widths.add(width)
            vm_pairs.add((width, s0_levels))
    lh_widths.add(si["nConstants"])
    vm_pairs.add((si["nConstants"], s0_levels))
    for s in range(1, len(steps)):
        group = 1 << (steps[s - 1]["nBits"] - steps[s]["nBits"])
        levels = _merkle_levels(1 << steps[s]["nBits"], arity)
        lh_widths.add(group * 3)
        vm_pairs.add((group * 3, levels))
    if not custom:
        for w in lh_widths:
            n3 = -(-w // 3)
            for start in range(0, n3, arity):
                csize = min(arity, n3 - start)
                if n3 > 1:
                    t_widths.add(csize + 1)
    for s in range(1, len(steps)):
        next_bits = steps[s + 1]["nBits"] if s < len(steps) - 1 else 0
        oh_sizes.add(steps[s]["nBits"] - next_bits)
    next1 = steps[1]["nBits"] if len(steps) > 1 else 0
    oh_sizes.add(steps[0]["nBits"] - next1)

    parts = ["pragma circom 2.1.0;"]
    if custom:
        parts.append("pragma custom_templates;")
    parts += [
        "",
        gbn.gen_bit_utils(),
        gbn.gen_gl_lib(),
        gbn.gen_roots_fns(),
    ]
    if t_widths:
        parts.append(gbn.gen_poseidon_bn(sorted(t_widths)))
    if custom:
        parts.append(gbn.gen_poseidon_custom_bn([arity + 1]))
    for n in sorted(oh_sizes):
        if n > 0:
            parts.append(gbn.gen_one_hot(n))
    for w in sorted(lh_widths):
        parts.append(gbn.gen_linear_hash_bn(w, arity, custom))
    for w, lv in sorted(vm_pairs):
        parts.append(gbn.gen_verify_merkle_bn(w, lv, arity, custom))

    parts.append(gen_transcript_bn(index, si, const_root))
    parts.append(gen_verify_evaluations_bn(index, si, verifier_info))
    parts.append(gen_map_values_bn(index, si))
    parts.append(gen_calculate_fri_pol_bn(index, si, verifier_info))
    for s in range(1, len(steps)):
        parts.append(gen_verify_fri_bn(index, si, s))
    parts.append(gen_verify_query_bn(index, si))
    parts.append(gen_verify_final_pol_bn(index, si))
    parts.append(gen_stark_verifier_bn(index, si, const_root, options))
    parts.append(f"component main {{public [publics]}} = StarkVerifierBN{index}();")
    return "\n\n".join(parts)
