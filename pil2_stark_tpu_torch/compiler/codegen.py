"""TAC (three-address code) generation from expression ASTs.

Mirrors pil2-stark-js src/pil_info/helpers/code/codegen.js (pilCodeGen,
evalExp, buildCode, findAddMul, fix* helpers) and generateCode.js (the
emitters for committed expressions, im-pols per stage, the composite
constraint polynomial, the FRI polynomial, per-constraint debug code, and
the verifier evaluation/query programs with evMap construction).

A program is {tmpUsed, code: [{op, dest, src[]}]} with ops
add/sub/mul/muladd/copy over operand refs typed
tmp/cm/const/exp/challenge/public/number/eval/xDivXSubXi/x/Zi/q/f/treeN.
"""
from __future__ import annotations

import json


def _prime_of(exp, prime):
    p = exp.get("rowOffset")
    return p if p else (prime or 0)


def pil_code_gen(ctx, symbols, expressions, exp_id, prime, ev_map_mode=False):
    """codegen.js:1-48."""
    if ctx["calculated"].get(exp_id, {}).get(prime or 0):
        return

    _calculate_deps(ctx, symbols, expressions, expressions[exp_id], prime, ev_map_mode)

    e = expressions[exp_id]
    if ctx.get("addMul"):
        e = _find_add_mul(e)

    if ev_map_mode:
        _calculate_ev_map(ctx, symbols, expressions, e, prime)
        return

    code_ctx = {
        "expId": exp_id,
        "tmpUsed": ctx["tmpUsed"],
        "calculated": ctx["calculated"],
        "dom": ctx["dom"],
        "stark": ctx["stark"],
        "verifierEvaluations": ctx.get("verifierEvaluations", False),
        "verifierQuery": ctx.get("verifierQuery", False),
        "evMap": ctx.get("evMap"),
        "airId": ctx["airId"],
        "subproofId": ctx["subproofId"],
        "openingPoints": ctx.get("openingPoints"),
        "stage": ctx["stage"],
        "code": [],
    }

    ret_ref = _eval_exp(code_ctx, symbols, expressions, e, prime)
    r = {"type": "exp", "prime": prime or 0, "id": exp_id, "dim": e.get("dim")}
    if ret_ref["type"] == "tmp":
        _fix_commit_pol(r, code_ctx, symbols)
        code_ctx["code"][-1]["dest"] = r
        code_ctx["tmpUsed"] -= 1
    else:
        _fix_commit_pol(r, code_ctx, symbols)
        code_ctx["code"].append({"op": "copy", "dest": r, "src": [ret_ref]})

    ctx["code"].extend(code_ctx["code"])
    ctx["calculated"].setdefault(exp_id, {})[prime or 0] = True
    if code_ctx["tmpUsed"] > ctx["tmpUsed"]:
        ctx["tmpUsed"] = code_ctx["tmpUsed"]


def _calculate_deps(ctx, symbols, expressions, exp, prime, ev_map_mode):
    if exp["op"] == "exp":
        p = _prime_of(exp, prime)
        pil_code_gen(ctx, symbols, expressions, exp["id"], p, ev_map_mode)
    elif exp["op"] in ("add", "sub", "mul", "muladd", "neg"):
        for v in exp["values"]:
            _calculate_deps(ctx, symbols, expressions, v, prime, ev_map_mode)


def _calculate_ev_map(ctx, symbols, expressions, exp, prime):
    """codegen.js:50-77 — register openings into ctx.evMap."""
    prime = prime or 0
    op = exp["op"]
    if op in ("add", "sub", "mul", "muladd"):
        for v in exp["values"]:
            _calculate_ev_map(ctx, symbols, expressions, v, prime)
    elif op in ("cm", "const") or (
        op == "exp" and expressions[exp["id"]]["op"] in ("cm", "const")
    ):
        expr = expressions[exp["id"]] if op == "exp" else exp
        p = _prime_of(expr, prime)
        r = {"type": expr["op"], "id": expr["id"], "prime": p, "dim": expr.get("dim")}
        _calculate_eval(r, ctx["evMap"], ctx["openingPoints"])
    elif op == "exp":
        p = _prime_of(exp, prime)
        r = {"type": "exp", "expId": exp["id"], "id": exp["id"], "prime": p, "dim": exp.get("dim")}
        symbol = next(
            (
                s
                for s in symbols
                if s["type"] == "witness"
                and s.get("expId") == r["id"]
                and s["airId"] == ctx["airId"]
                and s["subproofId"] == ctx["subproofId"]
            ),
            None,
        )
        if symbol and symbol.get("imPol"):
            r["type"] = "cm"
            r["id"] = symbol["polId"]
            r["dim"] = symbol["dim"]
            _calculate_eval(r, ctx["evMap"], ctx["openingPoints"])


def _eval_exp(ctx, symbols, expressions, exp, prime):
    """codegen.js:79-127."""
    prime = prime or 0
    op = exp["op"]
    if op in ("add", "sub", "mul", "muladd"):
        values = [_eval_exp(ctx, symbols, expressions, v, prime) for v in exp["values"]]
        r = {"type": "tmp", "id": ctx["tmpUsed"], "dim": max(v["dim"] for v in values)}
        ctx["tmpUsed"] += 1
        ctx["code"].append({"op": op, "dest": r, "src": values})
        return r
    if op in ("cm", "const") or (
        op == "exp" and expressions[exp["id"]]["op"] in ("cm", "const")
    ):
        expr = expressions[exp["id"]] if op == "exp" else exp
        p = _prime_of(expr, prime)
        r = {"type": expr["op"], "id": expr["id"], "prime": p, "dim": expr.get("dim")}
        if ctx["verifierEvaluations"]:
            _fix_eval(r, ctx)
        elif ctx["verifierQuery"] and expr["op"] == "cm":
            _fix_commits_query(r, ctx, symbols)
        return r
    if op == "exp":
        p = _prime_of(exp, prime)
        r = {"type": "exp", "expId": exp["id"], "id": exp["id"], "prime": p, "dim": exp.get("dim")}
        _fix_commit_pol(r, ctx, symbols)
        return r
    if op == "eval":
        return {"type": "eval", "id": exp["id"], "dim": exp["dim"]}
    if op == "challenge":
        return {
            "type": "challenge",
            "id": exp["id"],
            "stageId": exp.get("stageId"),
            "dim": exp["dim"],
            "stage": exp["stage"],
        }
    if op == "public":
        return {"type": "public", "id": exp["id"], "dim": 1}
    if op == "number":
        return {"type": "number", "value": str(exp["value"]), "dim": 1}
    if op == "subproofValue":
        return {"type": "subproofValue", "id": exp["id"], "dim": exp["dim"],
                "subproofId": exp.get("subproofId"), "airId": exp.get("airId")}
    if op == "xDivXSubXi":
        return {"type": "xDivXSubXi", "id": exp["id"], "opening": exp["opening"], "dim": 3}
    if op == "Zi":
        return {"type": "Zi", "boundaryId": exp["boundaryId"], "dim": 1}
    if op == "x":
        return {"type": "x", "dim": 1}
    raise ValueError(f"Invalid op: {op}")


def _find_add_mul(exp):
    values = exp.get("values")
    if not values:
        return exp
    if exp["op"] == "add" and values[0]["op"] == "mul":
        return {
            "op": "muladd",
            "values": [
                _find_add_mul(values[0]["values"][0]),
                _find_add_mul(values[0]["values"][1]),
                _find_add_mul(values[1]),
            ],
        }
    if exp["op"] == "add" and values[1]["op"] == "mul":
        return {
            "op": "muladd",
            "values": [
                _find_add_mul(values[1]["values"][0]),
                _find_add_mul(values[1]["values"][1]),
                _find_add_mul(values[0]),
            ],
        }
    r = dict(exp)
    r["values"] = [_find_add_mul(v) for v in values]
    return r


def _fix_expression(r, ctx):
    prime = r.get("prime") or 0
    exp_map = ctx["expMap"].setdefault(prime, {})
    if r["id"] not in exp_map:
        exp_map[r["id"]] = ctx["tmpUsed"]
        ctx["tmpUsed"] += 1
    r["type"] = "tmp"
    r["id"] = exp_map[r["id"]]


def _fix_dimensions_verifier(ctx):
    tmp_dim = {}

    def get_dim(r):
        t = r["type"]
        if t == "tmp":
            d = tmp_dim[r["id"]]
        elif t.startswith("tree"):
            d = r["dim"]
        elif t in ("const", "number", "public"):
            d = 1
        elif t in ("eval", "challenge", "xDivXSubXi", "x", "Zi", "subproofValue"):
            d = 3 if ctx["stark"] else 1
        else:
            raise ValueError(f"Invalid type: {t}")
        r["dim"] = d
        return d

    for inst in ctx["code"]:
        if inst["op"] not in ("add", "sub", "mul", "muladd", "copy"):
            raise ValueError(f"Invalid op: {inst['op']}")
        if inst["dest"]["type"] != "tmp":
            raise ValueError(f"Invalid dest type: {inst['dest']['type']}")
        new_dim = max(get_dim(s) for s in inst["src"])
        tmp_dim[inst["dest"]["id"]] = new_dim
        inst["dest"]["dim"] = new_dim


def _fix_commit_pol(r, ctx, symbols):
    symbol = next(
        (
            s
            for s in symbols
            if s["type"] == "witness"
            and s.get("expId") == r["id"]
            and s["airId"] == ctx["airId"]
            and s["subproofId"] == ctx["subproofId"]
        ),
        None,
    )
    if not symbol:
        return
    if symbol.get("imPol") and symbol["stage"] <= ctx["stage"]:
        r["type"] = "cm"
        r["id"] = symbol["polId"]
        r["dim"] = symbol["dim"]
        if ctx["verifierEvaluations"]:
            _fix_eval(r, ctx)
    elif not ctx["verifierEvaluations"] and ctx["dom"] == "n":
        r["type"] = "cm"
        r["id"] = symbol["polId"]
        r["dim"] = symbol["dim"]


def _calculate_eval(r, ev_map, opening_points):
    prime = r.get("prime") or 0
    opening_pos = opening_points.index(prime)
    for i, e in enumerate(ev_map):
        if e["type"] == r["type"] and e["id"] == r["id"] and e["openingPos"] == opening_pos:
            return i
    ev_map.append({"type": r["type"], "id": r["id"], "prime": prime, "openingPos": opening_pos})
    return len(ev_map) - 1


def _fix_eval(r, ctx):
    prime = r.get("prime") or 0
    opening_pos = ctx["openingPoints"].index(prime)
    eval_index = next(
        (
            i
            for i, e in enumerate(ctx["evMap"])
            if e["type"] == r["type"] and e["id"] == r["id"] and e["openingPos"] == opening_pos
        ),
        -1,
    )
    r.pop("prime", None)
    r["id"] = eval_index
    r["type"] = "eval"
    r["dim"] = 3 if ctx["stark"] else 1
    return r


def _fix_commits_query(r, ctx, symbols):
    symbol = next(
        s
        for s in symbols
        if s.get("polId") == r["id"]
        and s["type"] == "witness"
        and s["airId"] == ctx["airId"]
        and s["subproofId"] == ctx["subproofId"]
    )
    r["type"] = f"tree{symbol['stage']}"
    r["stageId"] = symbol["stageId"]
    r["treePos"] = symbol["stagePos"]
    r["dim"] = symbol["dim"]


def build_code(ctx):
    """codegen.js:257-296."""
    ctx["expMap"] = {}
    for inst in ctx["code"]:
        for s in inst["src"]:
            if s["type"] == "exp":
                _fix_expression(s, ctx)
        if inst["dest"]["type"] == "exp":
            _fix_expression(inst["dest"], ctx)

    if ctx.get("verifierEvaluations") or ctx.get("verifierQuery"):
        _fix_dimensions_verifier(ctx)

    code = {"tmpUsed": ctx["tmpUsed"], "code": ctx["code"]}
    if ctx.get("symbolsUsed"):
        order = {"const": 0, "cm": 1, "tmp": 2}
        code["symbolsUsed"] = sorted(
            ctx["symbolsUsed"],
            key=lambda s: (
                order.get(s["op"], 3),
                s.get("stage") or 0,
                s["id"],
            ),
        )

    ctx["code"] = []
    ctx["calculated"] = {}
    ctx["symbolsUsed"] = []
    ctx["tmpUsed"] = 0
    return code


# ---------------------------------------------------------------------------
# program emitters (generateCode.js)


def _new_ctx(stage, dom, res, stark, **kw):
    ctx = {
        "stage": stage,
        "calculated": {},
        "symbolsUsed": [],
        "tmpUsed": 0,
        "code": [],
        "dom": dom,
        "airId": res["airId"],
        "subproofId": res["subproofId"],
        "stark": stark,
    }
    ctx.update(kw)
    return ctx


def _add_symbols_used(ctx, syms):
    for s in syms or []:
        if not any(
            x["op"] == s["op"] and x.get("stage") == s.get("stage") and x["id"] == s["id"]
            for x in ctx["symbolsUsed"]
        ):
            ctx["symbolsUsed"].append(s)


def generate_expressions_code(res, symbols, expressions, stark):
    """generateCode.js:3-76."""
    out = []
    for j, exp in enumerate(expressions):
        if (
            not exp.get("keep")
            and not exp.get("imPol")
            and j not in (res["cExpId"], res.get("friExpId"))
        ):
            continue
        dom = "ext" if j in (res["cExpId"], res.get("friExpId")) else "n"
        ctx = _new_ctx(exp.get("stage"), dom, res, stark)
        if j == res.get("friExpId"):
            ctx["openingPoints"] = res["openingPoints"]
        if j == res["cExpId"]:
            for s in symbols:
                if not s.get("imPol"):
                    continue
                ctx["calculated"].setdefault(s["expId"], {})
                for op_pt in res["openingPoints"]:
                    ctx["calculated"][s["expId"]][op_pt] = True
        expr_dest = None
        if exp.get("imPol"):
            symbol_dest = next(s for s in symbols if s.get("expId") == j)
            expr_dest = {
                "op": "cm",
                "stage": symbol_dest["stage"],
                "stageId": symbol_dest["stageId"],
                "id": symbol_dest["polId"],
            }
        _add_symbols_used(ctx, exp.get("symbols"))

        pil_code_gen(ctx, symbols, expressions, j, 0)
        code = build_code(ctx)
        if j == res["cExpId"]:
            code["code"][-1]["dest"] = {"type": "q", "id": 0, "dim": res["qDim"]}
        if j == res.get("friExpId"):
            code["code"][-1]["dest"] = {"type": "f", "id": 0, "dim": 3}
        out.append(
            {
                "expId": j,
                "stage": exp.get("stage"),
                "symbols": exp.get("symbols"),
                "code": code,
                "dest": expr_dest,
                "line": exp.get("line", ""),
            }
        )
    return out


def generate_im_polynomials_code(res, symbols, expressions, stark):
    """generateCode.js:78-121."""
    im_pols_code = []
    for i in range(res["nStages"]):
        stage = i + 1
        ctx = _new_ctx(stage, "n", res, stark)
        for j, exp in enumerate(expressions):
            if exp.get("imPol"):
                if exp.get("stage") != stage:
                    continue
                symbol_dest = next(
                    (
                        s
                        for s in symbols
                        if s.get("expId") == j
                        and s["airId"] == res["airId"]
                        and s["subproofId"] == res["subproofId"]
                    ),
                    None,
                )
                if not symbol_dest:
                    continue
                _add_symbols_used(ctx, exp.get("symbols"))
                pil_code_gen(ctx, symbols, expressions, j, 0)
        stage_code = build_code(ctx)
        stage_code["stage"] = stage
        im_pols_code.append(stage_code)
    return im_pols_code


def generate_constraints_debug_code(res, symbols, constraints, expressions, stark):
    """generateCode.js:123-158."""
    out = []
    for c in constraints:
        ctx = _new_ctx(c["stage"], "n", res, stark)
        e = expressions[c["e"]]
        _add_symbols_used(ctx, e.get("symbols"))
        pil_code_gen(ctx, symbols, expressions, c["e"], 0)
        code = build_code(ctx)
        code["boundary"] = c["boundary"]
        code["line"] = c.get("line")
        code["stage"] = 1 if c["stage"] == 0 else c["stage"]
        if c["boundary"] == "everyFrame":
            code["offsetMin"] = c["offsetMin"]
            code["offsetMax"] = c["offsetMax"]
        out.append(code)
    return out


def generate_constraint_polynomial_verifier_code(res, verifier_info, symbols, expressions, stark):
    """generateCode.js:160-221 — builds evMap + qVerifier program."""
    add_mul = not stark
    ctx = _new_ctx(
        res["nStages"] + 1,
        "n",
        res,
        stark,
        evMap=[],
        openingPoints=res["openingPoints"],
        addMul=add_mul,
        verifierEvaluations=True,
    )
    for s in symbols:
        if not s.get("imPol"):
            continue
        ctx["calculated"].setdefault(s["expId"], {})
        for op_pt in res["openingPoints"]:
            ctx["calculated"][s["expId"]][op_pt] = True

    pil_code_gen(ctx, symbols, expressions, res["cExpId"], 0, ev_map_mode=True)

    if stark:
        # Q split columns are cm pols opened like any other (generateCode.js
        # :187-191); in fflonk mode Q is a single shplonk polynomial whose
        # evaluation the verifier derives, so it has no evMap entries.
        q_index = next(
            i
            for i, p in enumerate(res["cmPolsMap"])
            if p["stage"] == res["nStages"] + 1 and p.get("stageId") == 0
        )
        opening_pos = res["openingPoints"].index(0)
        for i in range(res["qDeg"]):
            ctx["evMap"].append(
                {"type": "cm", "id": q_index + i, "prime": 0, "openingPos": opening_pos}
            )

    def ev_key(e):
        # cm sorts after const; then id; then prime
        return (1 if e["type"] == "cm" else -1, e["id"], e["prime"])

    ctx["evMap"].sort(key=ev_key)

    pil_code_gen(ctx, symbols, expressions, res["cExpId"], 0)
    verifier_info["qVerifier"] = build_code(ctx)
    res["evMap"] = ctx["evMap"]

    if not stark:
        # generateCode.js:209-219 — fflonk ZK sizing.  Quirks preserved:
        # the per-pol opening count is initialized to 1 and then
        # incremented (so it's actual openings + 1), and nBitsZK divides
        # pilPower (the log2 size), not the size itself.
        import math

        n_openings = {}
        for ev in res["evMap"]:
            if ev["type"] == "const":
                continue
            key = f"{ev['type']}{ev['id']}"
            if key not in n_openings:
                n_openings[key] = 1
            n_openings[key] += 1
        res["maxPolsOpenings"] = max(n_openings.values(), default=1)
        res["nBitsZK"] = math.ceil(
            math.log2((res["pilPower"] + res["maxPolsOpenings"]) / res["pilPower"])
        )


def generate_fri_verifier_code(res, verifier_info, symbols, expressions):
    """generateCode.js:223-250."""
    ctx = _new_ctx(
        res["nStages"] + 2,
        "ext",
        res,
        True,
        openingPoints=res["openingPoints"],
        verifierQuery=True,
        addMul=False,
    )
    _add_symbols_used(ctx, expressions[res["friExpId"]].get("symbols"))
    pil_code_gen(ctx, symbols, expressions, res["friExpId"], 0)
    verifier_info["queryVerifier"] = build_code(ctx)
