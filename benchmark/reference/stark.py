"""A plain eSTARK prover: the reference the benchmark holds each proof of
the timed path against.

It follows pil2-stark-js src/prover/prover.js proofGen and
src/stark/stark_gen_helpers.js (and fri.js) for the setups the benchmark
proves: GL trees, no hints, no hashed commits, no subproof values, no
split linear hash; ``prove`` refuses any other setup.  Everything is plain
torch on whole columns, processed in blocks of rows or columns where a
whole array would not fit: a radix-2 transform, a TAC interpreter that
keeps each temporary only until its last read, the Poseidon trees of
hash.py.  It imports nothing of the program and takes nothing the program
made: the setup's JSON, the fixed columns and the witness are the inputs
both sides are handed.

"""
from __future__ import annotations

import torch

from . import field as F
from .hash import Transcript, Tree

BLOCK = 1 << 25  # elements per transform pass
ROW_BLOCK = 1 << 23  # rows per block of a program


def _bitrev(bits: int, device) -> torch.Tensor:
    idx = torch.arange(1 << bits, device=device)
    rev = torch.zeros_like(idx)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def ntt(x: torch.Tensor, bits: int, inverse: bool = False) -> torch.Tensor:
    """The DFT of each row of a (C, 2^bits) tensor, natural order in and
    out (iterative radix 2); the inverse scales by 1/n."""
    out = []
    rev = _bitrev(bits, x.device)
    block = max(1, BLOCK >> bits)
    for c0 in range(0, x.shape[0], block):
        y = x[c0:c0 + block][:, rev]
        cols = y.shape[0]
        for s in range(1, bits + 1):
            half = 1 << (s - 1)
            tw = F.powers(F.w_inv(s) if inverse else F.w(s), half, x.device)
            v = y.reshape(cols, -1, 2, half)
            t = F.mul(v[:, :, 1], tw)
            y = torch.stack([F.add(v[:, :, 0], t), F.sub(v[:, :, 0], t)], 2).reshape(cols, -1)
        if inverse:
            y = F.mul(y, pow(1 << bits, F.P - 2, F.P))
        out.append(y)
    return torch.cat(out) if out else x.clone()


def lde(x: torch.Tensor, bits: int, ext_bits: int) -> torch.Tensor:
    """(C, N) evaluations on the subgroup -> (C, extN) on the coset
    SHIFT·H_ext."""
    out = []
    block = max(1, BLOCK >> ext_bits)
    for c0 in range(0, x.shape[0], block):
        coefs = F.mul(ntt(x[c0:c0 + block], bits, True),
                      F.powers(F.SHIFT, 1 << bits, x.device)[None, :])
        padded = torch.zeros((coefs.shape[0], 1 << ext_bits), dtype=torch.int64,
                             device=x.device)
        padded[:, :1 << bits] = coefs
        out.append(ntt(padded, ext_bits))
    if not out:
        return torch.zeros((0, 1 << ext_bits), dtype=torch.int64, device=x.device)
    return torch.cat(out)


# -- the TAC programs of expressionsInfo --------------------------------------


class _Program:
    """One expression's code run over a block of rows: every operand read
    whole-column at the rows of the block shifted by its opening."""

    def __init__(self, code: list, info: dict, dom_bits: int, extend_bits: int):
        self.code, self.info = code, info
        self.n = 1 << dom_bits
        self.extend_bits = extend_bits  # 0 on the base domain
        # the last instruction that reads each write of a tmp
        last, current = {}, {}
        for j, ins in enumerate(code):
            for r in ins["src"]:
                if r["type"] == "tmp":
                    last[current[r["id"]]] = j
            if ins["dest"]["type"] == "tmp":
                current[ins["dest"]["id"]] = j
                last[j] = j
        self.drop = {}
        for w_, j in last.items():
            self.drop.setdefault(j, []).append(code[w_]["dest"]["id"])

    def shift(self, prime) -> int:
        return ((prime or 0) << self.extend_bits) % self.n

    def run(self, env: dict, rows: torch.Tensor) -> dict:
        """The values written to each dest ("q", "f" or a cm id), as
        (d, len(rows)) tensors, for the given rows."""
        tmp, out = {}, {}
        written = set()
        for j, ins in enumerate(self.code):
            a = [self._read(r, env, rows, tmp, written) for r in ins["src"]]
            op = ins["op"]
            if op == "copy":
                res = a[0]
            elif op == "add":
                res = F.e_add(a[0], a[1])
            elif op == "sub":
                res = F.e_sub(a[0], a[1])
            elif op == "mul":
                res = F.e_mul(a[0], a[1])
            elif op == "muladd":
                res = F.e_add(F.e_mul(a[0], a[1]), a[2])
            else:
                raise ValueError(f"unknown op {op}")
            for tid in self.drop.get(j, ()):
                tmp.pop(tid, None)
            dest = ins["dest"]
            if dest["type"] == "tmp":
                tmp[dest["id"]] = res
                continue
            if dest["type"] == "cm":
                key, dim = dest["id"], self.info["cmPolsMap"][dest["id"]]["dim"]
                written.add(key)
            elif dest["type"] in ("q", "f"):
                key, dim = dest["type"], dest.get("dim", 3)
            else:
                raise ValueError(f"unknown dest {dest['type']}")
            if self.shift(dest.get("prime")):
                raise ValueError("a write through a row shift is not supported")
            if res.shape[0] < dim:
                res = torch.cat([res, torch.zeros((dim - res.shape[0],) + res.shape[1:],
                                                  dtype=torch.int64, device=res.device)])
            out[key] = res.expand(dim, rows.shape[0]).contiguous()
        return out

    def _read(self, r, env, rows, tmp, written):
        t = r["type"]
        if t == "tmp":
            return tmp[r["id"]]
        if t == "number":
            return torch.tensor([[F.i64(int(r["value"]))]], device=rows.device)
        if t == "public":
            return torch.tensor([[F.i64(env["publics"][r["id"]])]], device=rows.device)
        if t in ("challenge", "eval"):
            src = env["challenges"] if t == "challenge" else env["evals"]
            return F.scalar3(src[r["id"]], rows.device)
        if t == "x":
            return env["x"][None, rows]
        if t == "Zi":
            b = self.info["boundaries"][r["boundaryId"]]
            k = next(i for i, c in enumerate(self.info["boundaries"])
                     if c["name"] == b["name"] and c.get("offsetMin") == b.get("offsetMin")
                     and c.get("offsetMax") == b.get("offsetMax"))
            return env["Zi"][k][None, rows]
        if t == "xDivXSubXi":
            return env["xdiv"][r["id"]][:, rows]
        at = (rows + self.shift(r.get("prime"))) % self.n
        if t == "const":
            return env["sections"]["const"][r["id"]][None, at]
        if t == "cm":
            if r["id"] in written:
                raise ValueError("a program that reads back its own writes is not supported")
            p = self.info["cmPolsMap"][r["id"]]
            return env["sections"][f"cm{p['stage']}"][p["stagePos"]:p["stagePos"] + p["dim"]][
                :, at]
        raise ValueError(f"unknown operand {t}")


def _run_program(code: dict, info: dict, env: dict, dom_bits: int, extend_bits: int,
                 device) -> dict:
    prog = _Program(code["code"], info, dom_bits, extend_bits)
    n = 1 << dom_bits
    parts: dict = {}
    for r0 in range(0, n, ROW_BLOCK):
        rows = torch.arange(r0, min(n, r0 + ROW_BLOCK), device=device)
        for k, v in prog.run(env, rows).items():
            parts.setdefault(k, []).append(v)
    return {k: torch.cat(v, dim=1) for k, v in parts.items()}


# -- the prover --------------------------------------------------------------


def _zerofiers(info: dict, x_ext, n_bits: int, ext_bits: int, device) -> list:
    """The Zi rows of each boundary over the extended coset."""
    n, extend = 1 << n_bits, ext_bits - n_bits
    sn = pow(F.SHIFT, n, F.P)
    pat = [pow((sn * pow(F.w(extend), i, F.P) - 1) % F.P, F.P - 2, F.P) for i in range(1 << extend)]
    zh = torch.tensor([F.i64(v) for v in pat], device=device).repeat(1 << n_bits)
    wn = F.w(n_bits)
    rows = []
    for b in info["boundaries"]:
        name = b["name"]
        if name == "everyRow":
            rows.append(zh)
        elif name in ("firstRow", "lastRow"):
            root = 1 if name == "firstRow" else pow(wn, n - 1, F.P)
            rows.append(F.inv(F.mul(F.sub(x_ext, F.i64(root)), zh)))
        elif name == "everyFrame":
            roots = [pow(wn, i, F.P) for i in range(b["offsetMin"])]
            roots += [pow(wn, n - i - 1, F.P) for i in range(b["offsetMax"])]
            row = torch.ones_like(x_ext)
            for r in roots:
                row = F.mul(row, F.sub(x_ext, F.i64(r)))
            rows.append(row)
        else:
            raise ValueError(f"unknown boundary {name}")
    return rows


def check_supported(info: dict, expressions: dict) -> None:
    ss = info["starkStruct"]
    if (ss.get("verificationHashType", "GL") != "GL" or ss.get("hashCommits")
            or ss.get("splitLinearHash") or expressions.get("hintsInfo")
            or info.get("nSubproofValues") or info["nStages"] < 2):
        raise ValueError("the reference proves GL setups without hints, hashed commits, "
                         "subproof values or a split linear hash")


def const_tree(info: dict, fixed, device) -> Tree:
    """The const tree of (N, nConstants) u64 fixed columns."""
    ss = info["starkStruct"]
    const_n = F.from_u64(fixed.T, device) if fixed.shape[1] else torch.zeros(
        (0, 1 << ss["nBits"]), dtype=torch.int64, device=device)
    return Tree(lde(const_n, ss["nBits"], ss["nBitsExt"]), const_n.shape[0], 1 << ss["nBitsExt"])


def prove(info: dict, expressions: dict, fixed, witness, publics, device) -> dict:
    """The proof of a witness ((N, nCm1) u64), its publics and the setup's
    fixed columns ((N, nConstants) u64): {"proof", "constRoot"} with the
    proof laid out as the program's (rootK, evals, subproofValues, fri)."""
    check_supported(info, expressions)
    ss = info["starkStruct"]
    n_bits, ext_bits = ss["nBits"], ss["nBitsExt"]
    n, ext_n = 1 << n_bits, 1 << ext_bits
    extend = ext_bits - n_bits
    n_stages = info["nStages"]
    q_stage = n_stages + 1
    cmap = info["challengesMap"]

    trees = {"const": const_tree(info, fixed, device)}
    x_n = F.powers(F.w(n_bits), n, device)
    x_ext = F.powers(F.w(ext_bits), ext_n, device, start=F.SHIFT)
    base = {"const": F.from_u64(fixed.T, device) if fixed.shape[1] else
            torch.zeros((0, n), dtype=torch.int64, device=device)}
    ext = {"const": trees["const"].elements}
    challenges = [None] * len(cmap)
    evals: list = []
    tr = Transcript()

    def set_challenges(stage, first):
        ids = [i for i, c in enumerate(cmap) if c["stage"] == stage]
        for k, i in enumerate(ids):
            challenges[i] = first if (k == 0 and first) else tr.field3()

    def env(dom):
        e = {"publics": [int(p) % F.P for p in publics], "challenges": challenges,
             "evals": evals}
        if dom == "n":
            e.update(sections=base, x=x_n)
        else:
            e.update(sections=ext, x=x_ext, Zi=zi, xdiv=xdiv)
        return e

    zi, xdiv = None, None
    challenge = None
    for stage in range(1, q_stage + 1):
        if any(c["stage"] == stage for c in cmap):
            set_challenges(stage, challenge)
        name = f"cm{stage}"
        width = info["mapSectionsN"].get(name, 0)
        if stage == 1:
            base[name] = F.from_u64(witness[:, :width].T, device) if width else torch.zeros(
                (0, n), dtype=torch.int64, device=device)
            tr.put(trees["const"].root)
            tr.put([int(p) % F.P for p in publics])
        elif stage < q_stage:
            cols = torch.zeros((width, n), dtype=torch.int64, device=device)
            if stage == q_stage - 1:
                code = expressions["imPolsCode"][n_stages - 1]
                if code["code"]:
                    for pid, v in _run_program(code, info, env("n"), n_bits, 0, device).items():
                        p = info["cmPolsMap"][pid]
                        cols[p["stagePos"]:p["stagePos"] + p["dim"]] = v
            base[name] = cols
        if stage < q_stage:
            ext[name] = lde(base[name], n_bits, ext_bits)
        else:
            if zi is None:
                zi = _zerofiers(info, x_ext, n_bits, ext_bits, device)
            q = _run_program(_expression(expressions, info["cExpId"]), info, env("ext"),
                             ext_bits, extend, device)["q"]
            ext[name] = _split_q(q, info, n_bits, ext_bits)
            del q
        trees[name] = Tree(ext[name], ext[name].shape[0], ext_n)
        tr.put(trees[name].root)
        if any(c["stage"] == stage for c in cmap):
            challenge = tr.field3()

    # the DEEP evaluations
    set_challenges(n_stages + 2, challenge)
    xi = challenges[next(i for i, c in enumerate(cmap) if c["stage"] == n_stages + 2)]
    xis = []
    for o in info["openingPoints"]:
        wo = pow(F.w(n_bits), abs(int(o)), F.P)
        xis.append(F.f3_mul(xi, (wo if o >= 0 else pow(wo, F.P - 2, F.P), 0, 0)))
    evals.extend(_evals(info, ext, xis, n_bits, extend, device))
    for e in evals:
        tr.put(e)
    set_challenges(n_stages + 3, tr.field3())

    # the FRI polynomial, its folds and the queries
    xdiv = torch.stack([F.e_mul(F.e_inv(F.e_sub(x_ext[None], F.scalar3(x, device))), x_ext[None])
                        for x in xis])
    pol = _run_program(_expression(expressions, info["friExpId"]), info, env("ext"), ext_bits,
                       extend, device)["f"]
    xdiv = None
    steps = [s["nBits"] for s in ss["steps"]]
    fri = [{}]
    fri_trees = []
    for step in range(len(steps)):
        ch = tr.field3()
        if step > 0:
            pol = _fold(pol, step, steps, challenge=ch)
        if step < len(steps) - 1:
            n_groups = 1 << steps[step + 1]
            h = pol.shape[1] // n_groups
            leaves = pol.reshape(3, h, n_groups).permute(1, 0, 2).reshape(3 * h, n_groups)
            t = Tree(leaves.contiguous(), 3 * h, n_groups)
            fri_trees.append(t)
            fri.append({"root": t.root})
            tr.put(t.root)
        else:
            last = [tuple(int(v) for v in row) for row in F.to_u64(pol.T)]
            fri.append(last)
            for v in last:
                tr.put(v)
    qt = Transcript()
    qt.put(tr.field3())
    queries = qt.permutations(ss["nQueries"], steps[0])
    stage_trees = [trees[f"cm{s}"] for s in range(1, q_stage + 1)] + [trees["const"]]
    fri[0]["polQueries"] = [[t.group_proof(i) for t in stage_trees] for i in queries]
    for step in range(1, len(steps)):
        queries = [i % (1 << steps[step]) for i in queries]
        fri[step]["polQueries"] = [fri_trees[step - 1].group_proof(i) for i in queries]

    proof = {"evals": evals, "subproofValues": [], "fri": fri}
    for s in range(1, q_stage + 1):
        proof[f"root{s}"] = trees[f"cm{s}"].root
    return {"proof": proof, "constRoot": trees["const"].root}


def _expression(expressions: dict, exp_id: int) -> dict:
    return next(e for e in expressions["expressionsCode"] if e["expId"] == exp_id)["code"]


def _split_q(q, info, n_bits, ext_bits):
    """Q's (qDim, extN) evaluations -> its qDeg pieces of degree < N, each
    as qDim columns on the extended coset (stark_gen_helpers.js:168-208)."""
    q_dim, q_deg = info["qDim"], info["qDeg"]
    n = 1 << n_bits
    coefs = ntt(q, ext_bits, True)  # on the coset: coefficient j carries SHIFT^j
    shift_in = pow(F.SHIFT_INV, n, F.P)
    pieces = torch.zeros((q_deg * q_dim, 1 << ext_bits), dtype=torch.int64, device=q.device)
    for p in range(q_deg):
        pieces[p * q_dim:(p + 1) * q_dim, :n] = F.mul(coefs[:, p * n:(p + 1) * n],
                                                      pow(shift_in, p, F.P))
    return ntt(pieces, ext_bits)


def _evals(info, ext, xis, n_bits, extend, device) -> list:
    """evals[k] = Σ_i pol_k(SHIFT·w_N^i) · LEv_k[i], LEv the inverse
    transform of the powers of xi_k/SHIFT (stark_gen_helpers.js:210-273)."""
    n = 1 << n_bits
    levs = []
    for x in xis:
        xs = F.f3_mul(x, (F.SHIFT_INV, 0, 0))
        pw = F.scalar3((1, 0, 0), device)
        while pw.shape[1] < n:
            step = F.scalar3(_f3_pow(xs, pw.shape[1]), device)
            pw = torch.cat([pw, F.e_mul(pw, step)], dim=1)
        levs.append(ntt(pw, n_bits, True))
    opening = list(info["openingPoints"])
    out = []
    for ev in info["evMap"]:
        if ev["type"] == "const":
            col = ext["const"][ev["id"]:ev["id"] + 1]
        elif ev["type"] == "cm":
            p = info["cmPolsMap"][ev["id"]]
            col = ext[f"cm{p['stage']}"][p["stagePos"]:p["stagePos"] + p["dim"]]
        else:
            raise ValueError(f"unknown evMap type {ev['type']}")
        prod = F.e_mul(col[:, ::1 << extend], levs[opening.index(ev["prime"])])
        out.append(tuple(int(v) for v in F.to_u64(F.gl_sum(prod, 1))))
    return out


def _f3_pow(x, e: int):
    res, acc = (1, 0, 0), x
    while e:
        if e & 1:
            res = F.f3_mul(res, acc)
        acc = F.f3_mul(acc, acc)
        e >>= 1
    return res


def _fold(pol, step, steps, challenge):
    """One FRI fold (fri.js): split the (3, n) polynomial into groups of
    the cosets of the next domain, interpolate each, undo the coset shift
    and evaluate at the challenge."""
    pol_bits = pol.shape[1].bit_length() - 1
    shift_inv = pow(F.SHIFT_INV, 1 << (steps[0] - steps[step - 1]), F.P)
    m = 1 << steps[step]
    n_x = pol.shape[1] // m
    g = pol.reshape(3, n_x, m).permute(1, 0, 2).reshape(n_x, 3 * m)
    coefs = ntt(g.T.contiguous(), n_x.bit_length() - 1, True).T.reshape(n_x, 3, m)
    sinv = F.powers(F.w_inv(pol_bits), m, pol.device, start=shift_inv)
    scale = torch.ones_like(sinv)
    terms = []
    for k in range(n_x):
        terms.append(F.mul(coefs[k], scale))
        scale = F.mul(scale, sinv)
    ch = F.scalar3(challenge, pol.device)
    res = terms[-1]
    for k in range(n_x - 2, -1, -1):
        res = F.e_add(F.e_mul(res, ch), terms[k])
    return res
