"""On-chain exporters for the pil-fflonk tier: EVM calldata encoding and
a generated Solidity verifier contract.

Counterpart of pil2-stark-js src/fflonk/solidity/
{exportFflonkCalldata.js:11-102, exportPilFflonkVerifier.js:10-75,
verifier_pilfflonk.sol.ejs} and the CLI mains main_exportCalldata.js /
main_exportSolidityVerifier.js.  The contract text is *generated* from
the verification key + fflonkInfo (no template files): every challenge
derivation, quotient-constraint evaluation (the qVerifier TAC inlined as
mulmod/addmod chains), shplonk root-set computation, Lagrange
reconstruction and the final pairing check is emitted as straight-line
statements over a uint256 memory scratchpad, so the code both compiles
as real Solidity (no stack-depth limits) and can be executed by the
statement evaluator in tests/test_solidity.py against a live proof.

Documented divergences from the reference exporter:
  * one self-contained contract instead of the PilFflonk + ShPlonk pair
    (the reference delegates the opening check to a second contract
    emitted by shplonkjs); capability is identical.
  * when maxQDegree == 0 the reference passes the non-committed Q
    evaluation as an extra `bytes32[1]` argument and checks it; we
    re-derive Q inside the contract instead (one fewer trust input).
  * calldata layout matches the reference scheme (W, W', committed f_i
    by index, ordered committed evaluations, inv, invZh; publics as a
    second hex array) with our shplonk ordering standing in for
    shplonkjs' getOrderedEvals.
"""
from __future__ import annotations

import json

from ..ops.fft_bn128 import FR
from ..protocol.poly_fr import domain_w
from ..protocol.shplonk import _ordered_eval_names, eval_suffix

# BN254 base-field modulus (coordinates); FR is the scalar field.
FQ = 21888242871839275222246405745257275088696311157297823662689037894645226208583

# G2 generator, EIP-197 coordinate order (x_c1, x_c0, y_c1, y_c0).
_G2_EIP197 = (
    11559732032986387107991004021392285783925812861821192530917403151452391805634,
    10857046999023057135944570762232829481370756359578518086990519993285655852781,
    4082367875863433681332203403145435568316851327593401208105741076214120093531,
    8495653923123431417604973247489272438418190587263600148770280649306958101930,
)


def _is_const_f(fi):
    """A composed commitment entirely from stage 0 lives in the vk."""
    return all(s["stage"] == 0 for s in fi["stages"])


def _split_f(vk):
    """(const f_i, committed f_i), both sorted by index.  Mixed
    stage-0/stage-k groupings are not produced by our shkey builder and
    are rejected loudly."""
    const_f, committed_f = [], []
    for fi in sorted(vk["f"], key=lambda fi: fi["index"]):
        if _is_const_f(fi):
            const_f.append(fi)
        elif any(s["stage"] == 0 for s in fi["stages"]):
            raise ValueError(
                f"f{fi['index']} mixes stage 0 with committed stages; "
                "the calldata/solidity layout requires pure groupings"
            )
        else:
            committed_f.append(fi)
    return const_f, committed_f


def _non_committed(vk):
    return ["Q"] if vk["maxQDegree"] == 0 else []


def _committed_eval_names(vk):
    """Evaluation names that travel in the proof, in transcript order."""
    skip = set(_non_committed(vk))
    return [ev for ev, name, _, _ in _ordered_eval_names(vk) if name not in skip]


def calldata_layout(vk):
    """Word layout of the proof array: (g1_points, eval_names, n_words).
    g1_points is a list of labels, two words (x, y) each."""
    _, committed_f = _split_f(vk)
    points = ["W1", "W2"] + [f"f{fi['index']}" for fi in committed_f]
    evals = _committed_eval_names(vk) + ["inv", "invZh"]
    return points, evals, 2 * len(points) + len(evals)


def export_calldata(vk, proof, publics) -> str:
    """exportFflonkCalldata.js:11-102: hex bytes32 array for the proof
    (+ a second array with the publics when present)."""
    points, evals, _ = calldata_layout(vk)
    words = []
    for label in points:
        pt = proof["polynomials"].get(label)
        if pt is None and label not in proof["polynomials"]:
            raise ValueError(f"{label} commit is missing from the proof")
        x, y = (0, 0) if pt is None else (int(pt[0]), int(pt[1]))
        words += [x, y]
    for name in evals:
        if name not in proof["evaluations"]:
            raise ValueError(f"evaluation {name} is missing from the proof")
        words.append(int(proof["evaluations"][name]) % FR)

    proof_hex = [f"0x{wd:064x}" for wd in words]
    calldata = json.dumps(proof_hex)
    if publics:
        calldata += "," + json.dumps([f"0x{int(p) % FR:064x}" for p in publics])
    return calldata


def decode_calldata(vk, calldata: str):
    """Inverse of export_calldata, reconstructing the verifier inputs
    from nothing but the vk and the hex strings (what the contract
    sees).  Returns (proof, publics) ready for fflonk_verify — const
    commitments are reinstated from the vk, like the embedded contract
    constants."""
    arrays = json.loads(f"[{calldata}]")
    words = [int(h, 16) for h in arrays[0]]
    publics = [int(h, 16) for h in arrays[1]] if len(arrays) > 1 else []

    points, evals, n_words = calldata_layout(vk)
    if len(words) != n_words:
        raise ValueError(f"expected {n_words} proof words, got {len(words)}")

    proof = {"polynomials": {}, "evaluations": {}}
    for i, label in enumerate(points):
        x, y = words[2 * i], words[2 * i + 1]
        proof["polynomials"][label] = None if (x, y) == (0, 0) else (x, y)
    base = 2 * len(points)
    for j, name in enumerate(evals):
        proof["evaluations"][name] = words[base + j]

    const_f, _ = _split_f(vk)
    for fi in const_f:
        proof["polynomials"][f"f{fi['index']}"] = vk["constCommits"][
            f"f{fi['index']}_0"
        ]
    return proof, publics


# ---------------------------------------------------------------------------
# Solidity emission
# ---------------------------------------------------------------------------


class _Emit:
    """Straight-line statement emitter over a uint256 memory array.

    Values are expression strings: decimal literals, `proof[i]`,
    `pubs[i]`, or `m[k]` slots.  Every helper emits one Solidity
    statement and returns the expression naming its result, so the
    verification algorithm below reads like the Python verifier it
    mirrors (fflonk/verifier.py + protocol/shplonk.py)."""

    def __init__(self):
        self.stmts = []
        self.n_slots = 0
        # structured twin of stmts, consumed by fflonk/evm.py's bytecode
        # compiler (the in-repo "solc" for this restricted language)
        self.ops = []

    def _slot(self):
        s = self.n_slots
        self.n_slots += 1
        return f"m[{s}]"

    def comment(self, text):
        self.stmts.append(f"// {text}")

    def raw(self, stmt):
        self.stmts.append(stmt)

    def mul(self, a, b):
        d = self._slot()
        self.stmts.append(f"{d} = mulmod({a}, {b}, q);")
        self.ops.append(("mul", d, a, b))
        return d

    def add(self, a, b):
        d = self._slot()
        self.stmts.append(f"{d} = addmod({a}, {b}, q);")
        self.ops.append(("add", d, a, b))
        return d

    def sub(self, a, b):
        d = self._slot()
        self.stmts.append(f"{d} = addmod({a}, q - ({b}), q);")
        self.ops.append(("sub", d, a, b))
        return d

    def expmod(self, b, e):
        d = self._slot()
        self.stmts.append(f"{d} = expmod({b}, {e});")
        self.ops.append(("expmod", d, b, e))
        return d

    def inv(self, a):
        d = self._slot()
        self.stmts.append(f"{d} = inv({a});")
        self.ops.append(("inv", d, a))
        return d

    def hash_fr(self, parts):
        d = self._slot()
        # every packed element is typed uint256 explicitly (Solidity
        # rejects untyped literals inside abi.encodePacked)
        packed = ", ".join(f"uint256({p})" for p in parts)
        self.stmts.append(f"{d} = hashToFr(abi.encodePacked({packed}));")
        self.ops.append(("hash", d, list(parts)))
        return d

    def ec_mul(self, pt, s):
        x, y = self._slot(), self._slot()
        self.stmts.append(f"({x}, {y}) = ecMul({pt[0]}, {pt[1]}, {s});")
        self.ops.append(("ecmul", x, y, pt[0], pt[1], s))
        return (x, y)

    def ec_add(self, a, b):
        x, y = self._slot(), self._slot()
        self.stmts.append(f"({x}, {y}) = ecAdd({a[0]}, {a[1]}, {b[0]}, {b[1]});")
        self.ops.append(("ecadd", x, y, a[0], a[1], b[0], b[1]))
        return (x, y)

    def neg_y(self, pt):
        y = self._slot()
        self.stmts.append(f"{y} = negY({pt[1]});")
        self.ops.append(("negy", y, pt[1]))
        return (pt[0], y)

    def check_eq(self, a, b, label):
        self.stmts.append(f"if ({a} != {b}) return false; // {label}")
        self.ops.append(("check_eq", a, b))

    def check_fr_range(self, expr):
        self.stmts.append(f"if ({expr} >= q) return false; // Fr range")
        self.ops.append(("check_range", expr))


def _transcript_challenge(em, buf):
    """One Keccak256Transcript.get_challenge(): hash the buffer, then the
    buffer becomes [challenge] (verifier.py _calculate_transcript)."""
    c = em.hash_fr(buf)
    return c, [c]


def export_pilfflonk_verifier(vk, fflonk_info, verifier_info,
                              return_ops: bool = False):
    """Generate the complete Solidity verifier contract text.

    Mirrors fflonk/verifier.py statement by statement: transcript
    replay, qVerifier constraint recomputation at xi, invZh / Q
    consistency, then the shplonk opening check
    (protocol/shplonk.py shplonk_verify) ending in one call to the
    pairing precompile."""
    em = _Emit()
    points, eval_names, n_words = calldata_layout(vk)
    const_f, committed_f = _split_f(vk)
    n_publics = vk.get("nPublics", 0)

    point_word = {label: 2 * i for i, label in enumerate(points)}
    eval_word = {
        name: 2 * len(points) + j for j, name in enumerate(eval_names)
    }

    def proof_pt(label):
        i = point_word[label]
        return (f"proof[{i}]", f"proof[{i + 1}]")

    def commit_expr(fi):
        """Commitment of f_i: embedded vk constant or proof calldata."""
        if _is_const_f(fi):
            cm = vk["constCommits"][f"f{fi['index']}_0"]
            return (str(int(cm[0])), str(int(cm[1])))
        return proof_pt(f"f{fi['index']}")

    # ---- 0. range checks on every Fr word ----
    em.comment("calldata range checks")
    for name in eval_names:
        em.check_fr_range(f"proof[{eval_word[name]}]")
    for i in range(n_publics):
        em.check_fr_range(f"pubs[{i}]")

    # ---- 1. transcript -> challenges + xi_seed ----
    em.comment("Fiat-Shamir transcript replay")
    hash_commits = bool(fflonk_info.get("hashCommits"))
    sorted_f = sorted(vk["f"], key=lambda fi: fi["index"])

    def commits_of_stage(stage):
        out = []
        for fi in sorted_f:
            if fi["stages"][0]["stage"] == stage:
                ce = commit_expr(fi)
                out += [ce[0], ce[1]]
        return out

    buf = []
    const_inputs = commits_of_stage(0)
    publics_inputs = [f"pubs[{i}]" for i in range(n_publics)]
    if hash_commits:
        buf.append(em.hash_fr(const_inputs))
        buf.append(em.hash_fr(publics_inputs))
    else:
        buf += const_inputs + publics_inputs

    challenges = []
    n_stages = fflonk_info["nStages"]
    for stage in range(1, n_stages + 2):
        n_ch = sum(1 for c in fflonk_info["challengesMap"]
                   if c["stage"] == stage)
        if stage == n_stages + 1:
            n_ch = max(1, n_ch)
        vals = []
        for _ in range(n_ch):
            c, buf = _transcript_challenge(em, buf)
            vals.append(c)
        challenges.append(vals)
        stage_commits = commits_of_stage(stage)
        if hash_commits:
            buf.append(em.hash_fr(stage_commits))
        else:
            buf += stage_commits
    xi_seed, _ = _transcript_challenge(em, buf)

    # ---- 2. xi, Zh, invZh hint ----
    em.comment("xi and the vanishing-polynomial inverse hint")
    power = vk["power"]
    xi = em.expmod(xi_seed, vk["powerW"])
    x_n = em.expmod(xi, 1 << power)
    zh = em.sub(x_n, "1")
    inv_zh = f"proof[{eval_word['invZh']}]"
    em.check_eq(em.mul(zh, inv_zh), "1", "invZh hint")

    # ---- 3. evMap -> calldata evaluation expressions ----
    ev_exprs = []
    for ev in fflonk_info["evMap"]:
        pmap = (fflonk_info["constPolsMap"] if ev["type"] == "const"
                else fflonk_info["cmPolsMap"])
        name = pmap[ev["id"]]["name"] + eval_suffix(ev["prime"])
        ev_exprs.append(f"proof[{eval_word[name]}]" if name in eval_word
                        else None)

    # ---- 4. qVerifier TAC, inlined ----
    em.comment("constraint polynomial recomputed at xi (qVerifier)")
    exec_val = _emit_tac(
        em, verifier_info["qVerifier"]["code"], ev_exprs, challenges,
        [f"pubs[{i}]" for i in range(n_publics)], xi,
    )

    # ---- 5. Q consistency ----
    q_val = em.mul(exec_val, inv_zh)
    evaluations = {name: f"proof[{eval_word[name]}]" for name in eval_names}
    if vk["maxQDegree"] == 0:
        em.comment("non-committed Q re-derived in-contract")
        evaluations["Q"] = q_val
    else:
        em.comment("committed Q split consistency")
        x_acc, q_sum = "1", "0"
        for qname in vk["qNames"]:
            q_sum = em.add(q_sum, em.mul(x_acc, evaluations[qname]))
            for _ in range(vk["maxQDegree"]):
                x_acc = em.mul(x_acc, x_n)
        em.check_eq(q_sum, q_val, "Q split")

    # ---- 6. shplonk opening check ----
    em.comment("shplonk: alpha / y challenges")
    ordered = _ordered_eval_names(vk)
    alpha = em.hash_fr([xi_seed] + [evaluations[ev] for ev, _, _, _ in ordered])
    w1 = proof_pt("W1")
    y = em.hash_fr([alpha, w1[0], w1[1]])

    em.comment("shplonk: opening root sets (2-adic tower)")
    # roots per (c, prime), deduped statically (shplonk.py _root_sets)
    root_groups = {}
    for fi in sorted_f:
        c = fi["c"]
        a = c.bit_length() - 1
        for prime in fi["openingPoints"]:
            key = (c, prime)
            if key in root_groups:
                continue
            base = em.expmod(xi_seed, vk["powerW"] // c)
            wc = domain_w(a) if a else 1
            anchor = em.mul(base, str(pow(domain_w(power + a), prime, FR)))
            roots = [anchor]
            for _ in range(c - 1):
                roots.append(em.mul(roots[-1], str(wc)))
            root_groups[key] = roots

    def fi_roots(fi):
        return [r for prime in fi["openingPoints"]
                for r in root_groups[(fi["c"], prime)]]

    all_root_keys = []
    for fi in sorted_f:
        for prime in fi["openingPoints"]:
            if (fi["c"], prime) not in all_root_keys:
                all_root_keys.append((fi["c"], prime))
    all_roots = [r for k in all_root_keys for r in root_groups[k]]

    z_t_y = "1"
    for r in all_roots:
        z_t_y = em.mul(z_t_y, em.sub(y, r))

    em.comment("shplonk: F accumulation over composed commitments")
    f_acc = None
    const_acc = "0"
    alpha_pow = "1"
    denom_prod = "1"
    for fi in sorted_f:
        idx = fi["index"]
        # claimed f_i(r) at each root via Horner over the slot evals
        pts = []
        for prime in fi["openingPoints"]:
            suffix = eval_suffix(prime)
            for r in root_groups[(fi["c"], prime)]:
                acc = "0"
                for name in reversed(fi["pols"]):
                    acc = em.add(em.mul(acc, r), evaluations[name + suffix])
                pts.append((r, acc))
        # r_i(y) by Lagrange interpolation over the opening roots
        r_y = "0"
        for j, (rj, vj) in enumerate(pts):
            num, den = "1", "1"
            for l, (rl, _) in enumerate(pts):
                if l == j:
                    continue
                num = em.mul(num, em.sub(y, rl))
                den = em.mul(den, em.sub(rj, rl))
            r_y = em.add(r_y, em.mul(vj, em.mul(num, em.inv(den))))
        # Z_{T_i}(y) and Z_{T \ T_i}(y)
        z_ti_y = "1"
        own_roots = set()
        for prime in fi["openingPoints"]:
            own_roots.update(root_groups[(fi["c"], prime)])
        for r in fi_roots(fi):
            z_ti_y = em.mul(z_ti_y, em.sub(y, r))
        denom_prod = em.mul(denom_prod, z_ti_y)
        z_diff = "1"
        for r in all_roots:
            if r not in own_roots:
                z_diff = em.mul(z_diff, em.sub(y, r))
        coef = em.mul(alpha_pow, z_diff)
        term = em.ec_mul(commit_expr(fi), coef)
        f_acc = term if f_acc is None else em.ec_add(f_acc, term)
        const_acc = em.add(const_acc, em.mul(coef, r_y))
        alpha_pow = em.mul(alpha_pow, alpha)

    em.comment("batched-inverse hint")
    em.check_eq(em.mul(f"proof[{eval_word['inv']}]", denom_prod), "1",
                "inv hint")

    em.comment("L = F - [const_acc]G - Z_T(y) W1; pairing check")
    g1 = em.ec_mul(("1", "2"), const_acc)  # BN254 G1 generator
    f_acc = em.ec_add(f_acc, em.neg_y(g1))
    w1_term = em.ec_mul(w1, z_t_y)
    f_acc = em.ec_add(f_acc, em.neg_y(w1_term))
    w2 = proof_pt("W2")
    lhs = em.ec_add(f_acc, em.ec_mul(w2, y))
    w2_neg = em.neg_y(w2)
    x2 = vk["X_2"]
    # our G2 points are ((x_c0, x_c1), (y_c0, y_c1)); EIP-197 wants c1, c0
    x2_words = (int(x2[0][1]), int(x2[0][0]), int(x2[1][1]), int(x2[1][0]))
    pairing_args = [
        lhs[0], lhs[1], str(_G2_EIP197[0]), str(_G2_EIP197[1]),
        str(_G2_EIP197[2]), str(_G2_EIP197[3]),
        w2_neg[0], w2_neg[1], str(x2_words[0]), str(x2_words[1]),
        str(x2_words[2]), str(x2_words[3]),
    ]
    em.raw("return pairingCheck(" + ", ".join(pairing_args) + ");")
    em.ops.append(("pairing_ret", pairing_args))

    text = _render_contract(em, n_words, n_publics)
    if return_ops:
        return text, em, n_words, n_publics
    return text


def _emit_tac(em, code, ev_exprs, challenges, publics, xi):
    """Inline the qVerifier TAC program (fflonk/verifier.py
    _execute_code) as mulmod/addmod statements."""
    tmp = {}

    def ref(r):
        t = r["type"]
        if t == "tmp":
            return tmp[r["id"]]
        if t == "eval":
            e = ev_exprs[r["id"]]
            if e is None:
                raise ValueError(f"eval id {r['id']} not in the proof")
            return e
        if t == "number":
            return str(int(r["value"]) % FR)
        if t == "public":
            return publics[r["id"]]
        if t == "challenge":
            return challenges[r["stage"] - 1][r["stageId"]]
        if t == "x":
            return xi
        raise ValueError(f"Invalid reference type get: {t}")

    res = "0"
    for inst in code:
        src = [ref(s) for s in inst["src"]]
        op = inst["op"]
        if op == "add":
            res = em.add(src[0], src[1])
        elif op == "sub":
            res = em.sub(src[0], src[1])
        elif op == "mul":
            res = em.mul(src[0], src[1])
        elif op == "muladd":
            res = em.add(em.mul(src[0], src[1]), src[2])
        elif op == "copy":
            res = src[0]
        else:
            raise ValueError(f"Invalid op: {op}")
        if inst["dest"]["type"] != "tmp":
            raise ValueError("Invalid reference type set")
        tmp[inst["dest"]["id"]] = res
    return res


_RUNTIME = """
    function expmod(uint256 b, uint256 e) internal view returns (uint256 r) {
        assembly {
            let p := mload(0x40)
            mstore(p, 0x20)
            mstore(add(p, 0x20), 0x20)
            mstore(add(p, 0x40), 0x20)
            mstore(add(p, 0x60), b)
            mstore(add(p, 0x80), e)
            mstore(add(p, 0xa0), q)
            if iszero(staticcall(gas(), 0x05, p, 0xc0, p, 0x20)) {
                revert(0, 0)
            }
            r := mload(p)
        }
    }

    function inv(uint256 a) internal view returns (uint256) {
        return expmod(a, q - 2);
    }

    function hashToFr(bytes memory data) internal pure returns (uint256) {
        return uint256(keccak256(data)) % q;
    }

    function ecAdd(uint256 ax, uint256 ay, uint256 bx, uint256 by)
        internal view returns (uint256 rx, uint256 ry)
    {
        assembly {
            let p := mload(0x40)
            mstore(p, ax)
            mstore(add(p, 0x20), ay)
            mstore(add(p, 0x40), bx)
            mstore(add(p, 0x60), by)
            if iszero(staticcall(gas(), 0x06, p, 0x80, p, 0x40)) {
                revert(0, 0)
            }
            rx := mload(p)
            ry := mload(add(p, 0x20))
        }
    }

    function ecMul(uint256 ax, uint256 ay, uint256 s)
        internal view returns (uint256 rx, uint256 ry)
    {
        assembly {
            let p := mload(0x40)
            mstore(p, ax)
            mstore(add(p, 0x20), ay)
            mstore(add(p, 0x40), s)
            if iszero(staticcall(gas(), 0x07, p, 0x60, p, 0x40)) {
                revert(0, 0)
            }
            rx := mload(p)
            ry := mload(add(p, 0x20))
        }
    }

    function negY(uint256 y) internal pure returns (uint256) {
        return y == 0 ? 0 : qf - y;
    }

    function pairingCheck(
        uint256 a1x, uint256 a1y,
        uint256 b1x1, uint256 b1x0, uint256 b1y1, uint256 b1y0,
        uint256 a2x, uint256 a2y,
        uint256 b2x1, uint256 b2x0, uint256 b2y1, uint256 b2y0
    ) internal view returns (bool ok) {
        uint256[12] memory p = [
            a1x, a1y, b1x1, b1x0, b1y1, b1y0,
            a2x, a2y, b2x1, b2x0, b2y1, b2y0
        ];
        uint256[1] memory out;
        assembly {
            if iszero(staticcall(gas(), 0x08, p, 0x180, out, 0x20)) {
                revert(0, 0)
            }
            ok := eq(mload(out), 1)
        }
    }
"""


def _render_contract(em, n_words, n_publics) -> str:
    pubs_arg = (f", uint256[{n_publics}] calldata pubs"
                if n_publics else "")
    body = "\n".join(
        ("        " + s) if s else "" for s in em.stmts
    )
    return f"""// SPDX-License-Identifier: GPL-3.0
// Generated by pil2_stark_tpu (pil-fflonk verifier). Do not edit.
pragma solidity >=0.8.4;

contract PilFflonkVerifier {{
    uint256 internal constant q = {FR};
    uint256 internal constant qf = {FQ};
{_RUNTIME}
    function verifyProof(uint256[{n_words}] calldata proof{pubs_arg})
        public view returns (bool)
    {{
        uint256[] memory m = new uint256[]({em.n_slots});
{body}
    }}
}}
"""
