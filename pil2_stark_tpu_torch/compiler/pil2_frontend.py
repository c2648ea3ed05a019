"""PIL2 pilout front-end: decodes `pil2-compiler` protobuf AIRs and formats
them into the setup pipeline's {expressions, symbols, constraints, hints}.

Counterpart of pil2-stark-js src/pil_info/helpers/pil2/piloutInfo.js and
utils.js (formatExpressions/formatConstraints/formatSymbols/formatHints) and
the pilout load in main_genstarkinfo.js:44-63.  The reference loads the
schema from the external pil2-compiler package; here the wire format was
recovered empirically from pil2-stark-js's pilout fixture
(test/state_machines/pil2/sm_fibv/data/fibv.pilout) — field numbers verified
against the fixture's known PIL source:

  PilOut:    1 name, 2 baseField, 3 subproofs, 4 numChallenges (packed),
             5 numProofValues, 6 numPublicValues, 8 global expressions,
             9 global constraints, 10 hints, 11 symbols
  Subproof:  1 name, 2 aggregate flag, 3 subproofValues, 4 airs
  Air:       1 name, 2 numRows, 4 fixedCols, 5 stageWidths (packed),
             6 expressions, 7 constraints
  Expression oneof: 1 add, 2 sub, 3 mul, 4 neg — each {1 lhs, 2 rhs/value}
  Operand oneof: 1 constant{1 value BE bytes}, 2 challenge{1 stage, 2 idx},
             4 subproofValue{1 idx}, 5 publicValue{1 idx},
             7 fixedCol{1 idx, 2 rowOffset sint}, 8 witnessCol{1 stage,
             2 colIdx, 3 rowOffset sint}, 9 expression{1 idx}
  Constraint oneof: 3 everyRow{1 expressionIdx{1 idx}, 2 debugLine},
             (1 firstRow, 2 lastRow, 4 everyFrame{.., 3 offsetMin,
             4 offsetMax})
  Symbol:    1 name, 2 subproofId, 3 airId, 4 type, 5 id, 6 stage, 7 dim,
             8 lengths, 9 debugLine
  Hint:      1 name, 2 hintField{4 hintFieldArray{1 entries{1 name,
             3 operand}}}, 3 subproofId, 4 airId
"""
from __future__ import annotations

import numpy as np

# symbol type enum (piloutInfo.js piloutTypes)
FIXED_COL = 1
WITNESS_COL = 3
SUBPROOF_VALUE = 5
PUBLIC_VALUE = 6
CHALLENGE = 8


def _read_varint(buf, pos):
    shift = 0
    val = 0
    while True:
        b = buf[pos]
        pos += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, pos
        shift += 7


def _zigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def decode_message(buf) -> list:
    """Generic wire decode -> [(field, value)] with bytes for len-type."""
    out = []
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        f, w = tag >> 3, tag & 7
        if w == 0:
            v, pos = _read_varint(buf, pos)
            out.append((f, v))
        elif w == 2:
            ln, pos = _read_varint(buf, pos)
            out.append((f, buf[pos : pos + ln]))
            pos += ln
        elif w == 5:
            out.append((f, buf[pos : pos + 4]))
            pos += 4
        elif w == 1:
            out.append((f, buf[pos : pos + 8]))
            pos += 8
        else:
            raise ValueError(f"bad wire type {w}")
    return out


def _packed_varints(buf) -> list[int]:
    out = []
    pos = 0
    while pos < len(buf):
        v, pos = _read_varint(buf, pos)
        out.append(v)
    return out


def _buf2int(b: bytes) -> int:
    """Field-element bytes are big-endian (proto_out.js buf2bint)."""
    return int.from_bytes(b, "big")


def _decode_operand(buf, global_mode: bool = False) -> dict:
    (f, v), = decode_message(buf)[:1] or [(None, None)]
    fields = dict(decode_message(v))
    if f == 1:
        return {"constant": {"value": fields.get(1, b"")}}
    if f == 2:
        return {"challenge": {"stage": fields.get(1, 0), "idx": fields.get(2, 0)}}
    if f == 3:
        return {"proofValue": {"idx": fields.get(1, 0)}}
    if f == 4:
        if global_mode:
            # GlobalOperand.subproofValue = {1 subproofId, 2 idx}
            return {"subproofValue": {"subproofId": fields.get(1, 0), "idx": fields.get(2, 0)}}
        # air-local subproofValue references carry only the idx
        return {"subproofValue": {"idx": fields.get(1, 0)}}
    if f == 5:
        return {"publicValue": {"idx": fields.get(1, 0)}}
    if f == 6:
        return {"periodicCol": {"idx": fields.get(1, 0), "rowOffset": _zigzag(fields.get(2, 0))}}
    if f == 7:
        return {"fixedCol": {"idx": fields.get(1, 0), "rowOffset": _zigzag(fields.get(2, 0))}}
    if f == 8:
        return {
            "witnessCol": {
                "stage": fields.get(1, 0),
                "colIdx": fields.get(2, 0),
                "rowOffset": _zigzag(fields.get(3, 0)),
            }
        }
    if f == 9:
        return {"expression": {"idx": fields.get(1, 0)}}
    raise ValueError(
        f"pilout: unknown Operand oneof field {f} — schema extension? "
        "refusing to decode silently"
    )


def _decode_expression(buf, global_mode: bool = False) -> dict:
    (f, v), = decode_message(buf)[:1]
    parts = decode_message(v)
    if f not in (1, 2, 3, 4):
        raise ValueError(f"pilout: unknown Expression oneof field {f}")
    op = {1: "add", 2: "sub", 3: "mul", 4: "neg"}[f]
    if op == "neg":
        value = _decode_operand(dict(parts)[1], global_mode)
        return {"neg": {"value": value}}
    d = dict(parts)
    return {op: {"lhs": _decode_operand(d[1], global_mode),
                 "rhs": _decode_operand(d[2], global_mode)}}


def _decode_constraint(buf) -> dict:
    (f, v), = decode_message(buf)[:1]
    if f not in (1, 2, 3, 4):
        raise ValueError(f"pilout: unknown Constraint oneof field {f}")
    name = {1: "firstRow", 2: "lastRow", 3: "everyRow", 4: "everyFrame"}[f]
    d = dict(decode_message(v))
    expr_idx = dict(decode_message(d[1]))
    out = {"expressionIdx": {"idx": expr_idx.get(1, 0)}, "debugLine": d.get(2, b"").decode()}
    if name == "everyFrame":
        out["offsetMin"] = d.get(3, 0)
        out["offsetMax"] = d.get(4, 0)
    return {name: out}


def _decode_symbol(buf) -> dict:
    d = decode_message(buf)
    fields = {}
    lengths = []
    for f, v in d:
        if f == 8:
            if isinstance(v, bytes):
                lengths.extend(_packed_varints(v))
            else:
                lengths.append(v)
        else:
            fields[f] = v
    sym = {
        "name": fields.get(1, b"").decode(),
        "subproofId": fields.get(2, 0),
        "airId": fields.get(3, 0),
        "type": fields.get(4, 0),
        "id": fields.get(5, 0),
        "stage": fields.get(6, 0),
        "dim": fields.get(7, 0),
        "debugLine": fields.get(9, b"").decode() if isinstance(fields.get(9), bytes) else "",
    }
    if lengths:
        sym["lengths"] = lengths
    return sym


def _decode_hint(buf) -> dict:
    d = decode_message(buf)
    hint = {"name": "", "fields": [], "subproofId": 0, "airId": 0}
    for f, v in d:
        if f == 1:
            hint["name"] = v.decode()
        elif f == 2:
            inner = dict(decode_message(v))
            if 4 in inner:
                for ef, ev in decode_message(inner[4]):
                    if ef == 1:
                        entry = dict(decode_message(ev))
                        hint["fields"].append(
                            {
                                "name": entry[1].decode(),
                                "operand": _decode_operand(entry[3]),
                            }
                        )
        elif f == 3:
            hint["subproofId"] = v
        elif f == 4:
            hint["airId"] = v
    return hint


def load_pilout(path: str) -> dict:
    """Decode a .pilout file into a pilout dict (protobufjs toObject shape)."""
    with open(path, "rb") as f:
        return decode_pilout(f.read())


def decode_pilout(data: bytes) -> dict:
    """Decode the bytes of a .pilout file (``load_pilout``)."""
    top = decode_message(data)
    pilout = {
        "name": "",
        "subproofs": [],
        "numChallenges": [],
        "numProofValues": 0,
        "numPublicValues": 0,
        "hints": [],
        "symbols": [],
    }
    for f, v in top:
        if f == 1:
            pilout["name"] = v.decode()
        elif f == 2:
            pilout["baseField"] = _buf2int(v)
        elif f == 3:
            pilout["subproofs"].append(_decode_subproof(v))
        elif f == 4:
            pilout["numChallenges"] = (
                _packed_varints(v) if isinstance(v, bytes) else [v]
            )
        elif f == 5:
            pilout["numProofValues"] = v
        elif f == 6:
            pilout["numPublicValues"] = v
        elif f == 8:
            pilout.setdefault("expressions", []).append(
                _decode_expression(v, global_mode=True)
            )
        elif f == 9:
            d = dict(decode_message(v))
            expr_idx = dict(decode_message(d[1]))
            pilout.setdefault("constraints", []).append(
                {"expressionIdx": {"idx": expr_idx.get(1, 0)},
                 "debugLine": d.get(2, b"").decode()}
            )
        elif f == 10:
            pilout["hints"].append(_decode_hint(v))
        elif f == 11:
            pilout["symbols"].append(_decode_symbol(v))
        elif f == 7:
            # AirGroupValue aggregation metadata — not needed by the
            # single-air pipeline; kept raw so nothing decodes wrong
            pilout.setdefault("airGroupValuesRaw", []).append(v)
        else:
            raise ValueError(
                f"pilout: unknown PilOut field {f} — refusing to skip"
            )
    return pilout


def _decode_subproof(buf) -> dict:
    sub = {"name": "", "airs": [], "aggregationTypes": []}
    for f, v in decode_message(buf):
        if f == 1:
            sub["name"] = v.decode()
        elif f == 2:
            sub["aggregate"] = bool(v)
        elif f == 3:
            agg = dict(decode_message(v)) if isinstance(v, bytes) else {1: v}
            sub["aggregationTypes"].append(agg.get(1, 0))
        elif f == 4:
            sub["airs"].append(_decode_air(v))
        else:
            raise ValueError(f"pilout: unknown Subproof field {f}")
    return sub


def _decode_air(buf) -> dict:
    air = {
        "name": "",
        "numRows": 0,
        "fixedCols": [],
        "periodicCols": [],
        "stageWidths": [],
        "expressions": [],
        "constraints": [],
    }
    for f, v in decode_message(buf):
        if f == 1:
            air["name"] = v.decode()
        elif f == 2:
            air["numRows"] = v
        elif f == 4:
            # FixedCol { repeated bytes values = 1 } (big-endian elements)
            values = [vv for vf, vv in decode_message(v) if vf == 1]
            air["fixedCols"].append({"values": values})
        elif f == 3:
            # PeriodicCol { repeated bytes values = 1 } — short repeating
            # patterns tiled to numRows by getFixedPolsPil2
            values = [vv for vf, vv in decode_message(v) if vf == 1]
            air["periodicCols"].append({"values": values})
        elif f == 5:
            air["stageWidths"] = _packed_varints(v) if isinstance(v, bytes) else [v]
        elif f == 6:
            air["expressions"].append(_decode_expression(v))
        elif f == 7:
            air["constraints"].append(_decode_constraint(v))
        else:
            raise ValueError(f"pilout: unknown Air field {f}")
    return air


def select_air(pilout: dict, subproof_id: int = 0, air_id: int = 0) -> dict:
    """main_genstarkinfo.js:58-64: flatten one air + global fields."""
    pil = dict(pilout["subproofs"][subproof_id]["airs"][air_id])
    pil["symbols"] = pilout["symbols"]
    pil["numChallenges"] = pilout["numChallenges"]
    pil["hints"] = pilout["hints"]
    pil["airId"] = air_id
    pil["subproofId"] = subproof_id
    pil["name"] = pilout["subproofs"][subproof_id]["name"]
    pil["aggregationTypes"] = pilout["subproofs"][subproof_id]["aggregationTypes"]
    return pil


# ---------------------------------------------------------------------------
# formatting into the setup pipeline's structures (pil2/utils.js)


def format_expression(exp, pil, symbols, stark, save_symbols=False):
    if "op" in exp:
        return exp
    op = next(iter(exp))
    store = False
    if op == "expression":
        idx = exp[op]["idx"]
        target = pil["expressions"][idx]
        t_op = next(iter(target))
        # unwrap `lhs - 0` wrappers (utils.js:52-55)
        if (
            t_op != "mul"
            and "op" not in target
            and next(iter(target[t_op]["lhs"])) != "expression"
            and next(iter(target[t_op]["rhs"])) == "constant"
            and _buf2int(target[t_op]["rhs"]["constant"]["value"]) == 0
        ):
            return format_expression(target[t_op]["lhs"], pil, symbols, stark, save_symbols)
        out = {"op": "exp", "id": idx}
    elif op in ("add", "mul", "sub"):
        lhs = format_expression(exp[op]["lhs"], pil, symbols, stark, save_symbols)
        rhs = format_expression(exp[op]["rhs"], pil, symbols, stark, save_symbols)
        out = {"op": op, "values": [lhs, rhs]}
    elif op == "neg":
        value = format_expression(exp[op]["value"], pil, symbols, stark, save_symbols)
        out = {"op": "neg", "values": [value]}
    elif op == "constant":
        out = {"op": "number", "value": str(_buf2int(exp[op]["value"]))}
    elif op == "witnessCol":
        stage = exp[op]["stage"]
        col_idx = exp[op]["colIdx"]
        pid = col_idx + sum(pil["stageWidths"][: stage - 1])
        dim = 1 if stage == 1 else (3 if stark else 1)
        out = {
            "op": "cm",
            "id": pid,
            "stageId": col_idx,
            "rowOffset": exp[op]["rowOffset"],
            "stage": stage,
            "dim": dim,
            "subproofId": pil["subproofId"],
            "airId": pil["subproofId"],
        }
        store = True
    elif op == "fixedCol":
        out = {
            "op": "const",
            "id": exp[op]["idx"],
            "rowOffset": exp[op]["rowOffset"],
            "stage": 0,
            "dim": 1,
            "subproofId": pil["subproofId"],
            "airId": pil["subproofId"],
        }
        store = True
    elif op == "periodicCol":
        # periodic columns are tiled to N and appended after the fixed
        # columns (fixed_cols_array), so they address as const refs
        out = {
            "op": "const",
            "id": len(pil.get("fixedCols", [])) + exp[op]["idx"],
            "rowOffset": exp[op]["rowOffset"],
            "stage": 0,
            "dim": 1,
            "subproofId": pil["subproofId"],
            "airId": pil["subproofId"],
        }
        store = True
    elif op == "publicValue":
        out = {"op": "public", "id": exp[op]["idx"], "stage": 1}
        store = True
    elif op == "subproofValue":
        out = {
            "op": "subproofValue",
            "id": exp[op]["idx"],
            "stage": len(pil["numChallenges"]),
            "subproofId": exp[op].get("subproofId", pil["subproofId"]),
        }
        store = True
    elif op == "challenge":
        stage = exp[op]["stage"]
        cid = exp[op]["idx"] + sum(pil["numChallenges"][: stage - 1])
        out = {"op": "challenge", "stage": stage, "stageId": exp[op]["idx"], "id": cid}
        store = True
    else:
        raise ValueError(f"Unknown op: {op}")

    if save_symbols and store:
        _add_symbol(pil["name"], symbols, out, stark)
    return out


def _add_symbol(subproof_name, symbols, exp, stark):
    """utils.js addSymbol:112-151."""
    subproof_id = exp.get("subproofId", 0)
    air_id = exp.get("airId", 0)
    op = exp["op"]
    if op == "public":
        if not any(s["type"] == "public" and s["id"] == exp["id"] for s in symbols):
            symbols.append(
                {"type": "public", "dim": 1, "id": exp["id"],
                 "name": f"{subproof_name}.public_{exp['id']}", "stage": 1}
            )
    elif op == "challenge":
        if not any(
            s["type"] == "challenge" and s["stage"] == exp["stage"] and s["stageId"] == exp["stageId"]
            for s in symbols
        ):
            cid = sum(
                1
                for s in symbols
                if s["type"] == "challenge"
                and (s["stage"] < exp["stage"] or (s["stage"] == exp["stage"] and s["stageId"] < exp["stageId"]))
            )
            symbols.append(
                {"type": "challenge", "stageId": exp["stageId"], "stage": exp["stage"],
                 "id": cid, "dim": 3 if stark else 1,
                 "name": f"{subproof_name}.challenge_{exp['stage']}_{exp['stageId']}"}
            )
    elif op == "const":
        if not any(
            s["type"] == "fixed" and s["airId"] == air_id and s["subproofId"] == subproof_id
            and s["stage"] == exp["stage"] and s.get("stageId") == exp["id"]
            for s in symbols
        ):
            symbols.append(
                {"type": "fixed", "polId": exp["id"], "stageId": exp["id"], "stage": exp["stage"],
                 "dim": 1, "name": f"{subproof_name}.fixed_{exp['id']}", "airId": air_id,
                 "subproofId": subproof_id}
            )
    elif op == "cm":
        if not any(
            s["type"] == "witness" and s["airId"] == air_id and s["subproofId"] == subproof_id
            and s["stage"] == exp["stage"] and s.get("stageId") == exp["stageId"]
            for s in symbols
        ):
            dim = 1 if (exp["stage"] == 1 or not stark) else 3
            symbols.append(
                {"type": "witness", "polId": exp["id"], "stageId": exp["stageId"],
                 "stage": exp["stage"], "dim": dim,
                 "name": f"{subproof_name}.witness_{exp['stage']}_{exp['stageId']}",
                 "airId": air_id, "subproofId": subproof_id}
            )
    elif op == "subproofValue":
        if not any(
            s["type"] == "subproofValue" and s["id"] == exp["id"]
            and s["airId"] == air_id and s["subproofId"] == subproof_id
            for s in symbols
        ):
            symbols.append(
                {"type": "subproofValue", "dim": 1, "id": exp["id"],
                 "name": f"{subproof_name}.subproofvalue_{exp['id']}",
                 "airId": air_id, "subproofId": subproof_id}
            )
    else:
        raise ValueError(f"Unknown operation {op}")


def format_constraints(pil) -> list:
    out = []
    for c in pil["constraints"]:
        boundary = next(iter(c))
        constraint = {
            "boundary": boundary,
            "e": c[boundary]["expressionIdx"]["idx"],
            "line": c[boundary].get("debugLine", ""),
        }
        if boundary == "everyFrame":
            constraint["offsetMin"] = c[boundary]["offsetMin"]
            constraint["offsetMax"] = c[boundary]["offsetMax"]
        out.append(constraint)
    return out


def format_symbols(pil, stark) -> list:
    """utils.js formatSymbols:216-283 (scalar + multi-array witness/fixed)."""
    raw = pil["symbols"]
    out = []
    for s in raw:
        if s["type"] in (FIXED_COL, WITNESS_COL):
            dim = 1 if (s["stage"] in (0, 1) or not stark) else 3
            sym_type = "fixed" if s["type"] == FIXED_COL else "witness"
            previous = [
                si
                for si in raw
                if si["type"] == s["type"]
                and si["airId"] == s["airId"]
                and si["subproofId"] == s["subproofId"]
                and (si["stage"] < s["stage"] or (si["stage"] == s["stage"] and si["id"] < s["id"]))
            ]
            pol_id = 0
            for p in previous:
                if not p.get("dim"):
                    pol_id += 1
                else:
                    n = 1
                    for l in p["lengths"]:
                        n *= l
                    pol_id += n
            if not s.get("dim"):
                out.append(
                    {"name": s["name"], "stage": s["stage"], "type": sym_type,
                     "polId": pol_id, "stageId": s["id"], "dim": dim,
                     "airId": s["airId"], "subproofId": s["subproofId"]}
                )
            else:
                _multi_array_symbols(out, [], s, sym_type, dim, pol_id, 0)
        elif s["type"] == CHALLENGE:
            cid = sum(
                1
                for si in raw
                if si["type"] == CHALLENGE
                and (si["stage"] < s["stage"] or (si["stage"] == s["stage"] and si["id"] < s["id"]))
            )
            out.append(
                {"name": s["name"], "type": "challenge", "stageId": s["id"], "id": cid,
                 "stage": s["stage"], "dim": 3 if stark else 1}
            )
        elif s["type"] == PUBLIC_VALUE:
            out.append({"name": s["name"], "stage": 1, "type": "public", "dim": 1, "id": s["id"]})
        elif s["type"] == SUBPROOF_VALUE:
            out.append(
                {"name": s["name"], "type": "subproofValue", "id": s["id"],
                 "subproofId": s["subproofId"], "dim": 3 if stark else 1,
                 "airId": s["airId"]}
            )
    return out


def _multi_array_symbols(out, indexes, sym, sym_type, dim, pol_id, shift):
    if len(indexes) == len(sym["lengths"]):
        out.append(
            {"name": sym["name"], "lengths": list(indexes), "idx": shift,
             "stage": sym["stage"], "type": sym_type, "polId": pol_id + shift,
             "stageId": sym["id"] + shift, "dim": dim, "airId": sym["airId"],
             "subproofId": sym["subproofId"]}
        )
        return shift + 1
    for i in range(sym["lengths"][len(indexes)]):
        shift = _multi_array_symbols(out, indexes + [i], sym, sym_type, dim, pol_id, shift)
    return shift


def format_hints(pil, raw_hints, symbols, expressions, stark, save_symbols) -> list:
    hints = []
    for rh in raw_hints:
        hint = {"name": rh["name"]}
        for f in rh["fields"]:
            value = format_expression(f["operand"], pil, symbols, stark, save_symbols)
            if value["op"] == "exp":
                expressions[value["id"]]["keep"] = True
            hint[f["name"]] = value
        hints.append(hint)
    return hints


def get_pilout_info(res, pil, stark) -> dict:
    """piloutInfo.js getPiloutInfo:4-44."""
    res["airId"] = pil["airId"]
    res["subproofId"] = pil["subproofId"]

    constraints = format_constraints(pil)

    save_symbols = not pil.get("symbols")
    symbols_acc = []
    expressions = [
        format_expression(e, pil, symbols_acc, stark, save_symbols)
        for e in pil["expressions"]
    ]
    if save_symbols:
        symbols = symbols_acc
    else:
        symbols = format_symbols(pil, stark)

    symbols = [
        s
        for s in symbols
        if s["type"] not in ("witness", "fixed")
        or (s.get("airId") == res["airId"] and s.get("subproofId") == res["subproofId"])
    ]

    res["pilPower"] = pil["numRows"].bit_length() - 1
    res["nCommitments"] = sum(
        1
        for s in symbols
        if s["type"] == "witness"
        and s.get("airId") == res["airId"]
        and s.get("subproofId") == res["subproofId"]
    )
    res["nConstants"] = sum(
        1
        for s in symbols
        if s["type"] == "fixed"
        and s.get("airId") == res["airId"]
        and s.get("subproofId") == res["subproofId"]
    )
    res["nPublics"] = sum(1 for s in symbols if s["type"] == "public")
    res["aggregationTypes"] = pil.get("aggregationTypes", [])
    res["nSubproofValues"] = (
        len(res["aggregationTypes"])
        if pil.get("aggregationTypes")
        else sum(
            1
            for s in symbols
            if s["type"] == "subproofValue" and s.get("subproofId") == res["subproofId"]
        )
    )
    res["nStages"] = len(pil["numChallenges"]) if pil.get("numChallenges") else (
        max((s.get("stage") or 0) for s in symbols) if symbols else 0
    )

    air_hints = [
        h
        for h in pil.get("hints", [])
        if h.get("airId") == res["airId"] and h.get("subproofId") == res["subproofId"]
    ]
    hints = format_hints(pil, air_hints, symbols, expressions, stark, save_symbols)

    return {
        "expressions": expressions,
        "hints": hints,
        "constraints": constraints,
        "symbols": symbols,
    }


def fixed_cols_array(pil) -> np.ndarray:
    """getFixedPolsPil2: (N, nFixed + nPeriodic) u64 — explicit fixed
    columns followed by periodic columns tiled to N."""
    n = pil["numRows"]
    cols = pil["fixedCols"]
    periodic = pil.get("periodicCols", [])
    out = np.zeros((n, len(cols) + len(periodic)), dtype=np.uint64)
    for i, col in enumerate(cols):
        for j, v in enumerate(col["values"]):
            out[j, i] = _buf2int(v)
    for i, col in enumerate(periodic):
        vals = [_buf2int(v) for v in col["values"]]
        period = len(vals)
        if n % period:
            raise ValueError("periodic column length does not divide N")
        out[:, len(cols) + i] = np.tile(
            np.array(vals, dtype=np.uint64), n // period
        )
    return out


# ---------------------------------------------------------------------------
# vadcop global constraints (cross-subproof)


def get_global_constraints_info(pilout: dict, stark: bool = True) -> list:
    """getGlobalConstraintsInfo.js:5-48: compile the pilout's global
    (cross-subproof) constraints into TAC programs over subproofValues /
    publics / challenges, boundary "finalProof"."""
    from . import codegen
    from .prepare import add_info_expressions

    if not pilout.get("constraints"):
        return []

    constraints = [
        {"e": c["expressionIdx"]["idx"], "boundary": "finalProof",
         "line": c.get("debugLine", "")}
        for c in pilout["constraints"]
    ]

    # shim "pil" for format_expression: globals reference no air columns
    shim = {
        "expressions": pilout.get("expressions", []),
        "numChallenges": pilout.get("numChallenges", []),
        "stageWidths": [],
        "subproofId": 0,
        "name": pilout.get("name", "global"),
    }
    symbols_acc = []
    save_symbols = not pilout.get("symbols")
    expressions = [
        format_expression(e, shim, symbols_acc, stark, save_symbols)
        for e in shim["expressions"]
    ]
    symbols = symbols_acc if save_symbols else format_symbols(pilout, stark)

    for c in constraints:
        add_info_expressions(expressions, expressions[c["e"]], stark)

    ctx = {
        "calculated": {},
        "tmpUsed": 0,
        "code": [],
        "dom": "n",
        "stark": stark,
        "airId": 0,
        "subproofId": 0,
        "stage": 0,
    }
    out = []
    for c in constraints:
        codegen.pil_code_gen(ctx, symbols, expressions, c["e"], 0)
        code = codegen.build_code(ctx)
        ctx["tmpUsed"] = code["tmpUsed"]
        code["boundary"] = c["boundary"]
        code["line"] = c["line"]
        out.append(code)
    return out


# ---------------------------------------------------------------------------
# pilout encoder — produces wire bytes from the decoded dict shape, used by
# the round-trip tests (the decoder is cross-checked against its own
# inverse)


def _enc_varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _enc_tag(field: int, wire: int) -> bytes:
    return _enc_varint((field << 3) | wire)


def _enc_len(field: int, payload: bytes) -> bytes:
    return _enc_tag(field, 2) + _enc_varint(len(payload)) + payload


def _enc_zigzag(v: int) -> int:
    return (v << 1) ^ (v >> 63) if v < 0 else (v << 1)


def _enc_operand(op: dict) -> bytes:
    (kind, body), = op.items()
    fmap = {
        "constant": 1, "challenge": 2, "proofValue": 3, "subproofValue": 4,
        "publicValue": 5, "periodicCol": 6, "fixedCol": 7, "witnessCol": 8,
        "expression": 9,
    }
    f = fmap[kind]
    inner = b""
    if kind == "constant":
        inner = _enc_len(1, body["value"])
    elif kind == "challenge":
        inner = _enc_tag(1, 0) + _enc_varint(body["stage"]) + _enc_tag(2, 0) + _enc_varint(body["idx"])
    elif kind in ("proofValue", "publicValue", "subproofValue", "expression"):
        if kind == "subproofValue" and "subproofId" in body:
            # GlobalOperand.subproofValue = {1 subproofId, 2 idx}
            inner = (
                _enc_tag(1, 0) + _enc_varint(body["subproofId"])
                + _enc_tag(2, 0) + _enc_varint(body["idx"])
            )
        else:
            inner = _enc_tag(1, 0) + _enc_varint(body["idx"])
    elif kind in ("fixedCol", "periodicCol"):
        inner = _enc_tag(1, 0) + _enc_varint(body["idx"])
        if body.get("rowOffset"):
            inner += _enc_tag(2, 0) + _enc_varint(_enc_zigzag(body["rowOffset"]))
    elif kind == "witnessCol":
        inner = (
            _enc_tag(1, 0) + _enc_varint(body["stage"])
            + _enc_tag(2, 0) + _enc_varint(body["colIdx"])
        )
        if body.get("rowOffset"):
            inner += _enc_tag(3, 0) + _enc_varint(_enc_zigzag(body["rowOffset"]))
    return _enc_len(f, inner)


def _enc_expression(exp: dict) -> bytes:
    (op, body), = exp.items()
    fmap = {"add": 1, "sub": 2, "mul": 3, "neg": 4}
    if op == "neg":
        inner = _enc_len(1, _enc_operand(body["value"]))
    else:
        inner = _enc_len(1, _enc_operand(body["lhs"])) + _enc_len(
            2, _enc_operand(body["rhs"])
        )
    return _enc_len(fmap[op], inner)


def _enc_constraint(c: dict) -> bytes:
    (name, body), = c.items()
    fmap = {"firstRow": 1, "lastRow": 2, "everyRow": 3, "everyFrame": 4}
    inner = _enc_len(1, _enc_tag(1, 0) + _enc_varint(body["expressionIdx"]["idx"]))
    if body.get("debugLine"):
        inner += _enc_len(2, body["debugLine"].encode())
    if name == "everyFrame":
        inner += _enc_tag(3, 0) + _enc_varint(body.get("offsetMin", 0))
        inner += _enc_tag(4, 0) + _enc_varint(body.get("offsetMax", 0))
    return _enc_len(fmap[name], inner)


def _enc_symbol(s: dict) -> bytes:
    out = _enc_len(1, s["name"].encode())
    out += _enc_tag(2, 0) + _enc_varint(s.get("subproofId", 0))
    out += _enc_tag(3, 0) + _enc_varint(s.get("airId", 0))
    out += _enc_tag(4, 0) + _enc_varint(s.get("type", 0))
    out += _enc_tag(5, 0) + _enc_varint(s.get("id", 0))
    out += _enc_tag(6, 0) + _enc_varint(s.get("stage", 0))
    out += _enc_tag(7, 0) + _enc_varint(s.get("dim", 0))
    for ln in s.get("lengths", []):
        out += _enc_tag(8, 0) + _enc_varint(ln)
    if s.get("debugLine"):
        out += _enc_len(9, s["debugLine"].encode())
    return out


def _enc_hint(h: dict) -> bytes:
    out = _enc_len(1, h["name"].encode())
    entries = b""
    for fld in h.get("fields", []):
        entry = _enc_len(1, fld["name"].encode()) + _enc_len(
            3, _enc_operand(fld["operand"])
        )
        entries += _enc_len(1, entry)
    out += _enc_len(2, _enc_len(4, entries))
    out += _enc_tag(3, 0) + _enc_varint(h.get("subproofId", 0))
    out += _enc_tag(4, 0) + _enc_varint(h.get("airId", 0))
    return out


def _enc_air(air: dict) -> bytes:
    out = _enc_len(1, air["name"].encode())
    out += _enc_tag(2, 0) + _enc_varint(air["numRows"])
    for col in air.get("periodicCols", []):
        payload = b"".join(_enc_len(1, v) for v in col["values"])
        out += _enc_len(3, payload)
    for col in air.get("fixedCols", []):
        payload = b"".join(_enc_len(1, v) for v in col["values"])
        out += _enc_len(4, payload)
    if air.get("stageWidths"):
        out += _enc_len(5, b"".join(_enc_varint(w) for w in air["stageWidths"]))
    for e in air.get("expressions", []):
        out += _enc_len(6, _enc_expression(e))
    for c in air.get("constraints", []):
        out += _enc_len(7, _enc_constraint(c))
    return out


def encode_pilout(pilout: dict) -> bytes:
    out = _enc_len(1, pilout.get("name", "").encode())
    if "baseField" in pilout:
        out += _enc_len(2, pilout["baseField"].to_bytes(8, "big"))
    for sub in pilout.get("subproofs", []):
        inner = _enc_len(1, sub["name"].encode())
        for agg in sub.get("aggregationTypes", []):
            inner += _enc_len(3, _enc_tag(1, 0) + _enc_varint(agg))
        for air in sub.get("airs", []):
            inner += _enc_len(4, _enc_air(air))
        out += _enc_len(3, inner)
    if pilout.get("numChallenges"):
        out += _enc_len(4, b"".join(_enc_varint(c) for c in pilout["numChallenges"]))
    if pilout.get("numProofValues"):
        out += _enc_tag(5, 0) + _enc_varint(pilout["numProofValues"])
    if pilout.get("numPublicValues"):
        out += _enc_tag(6, 0) + _enc_varint(pilout["numPublicValues"])
    for e in pilout.get("expressions", []):
        out += _enc_len(8, _enc_expression(e))
    for c in pilout.get("constraints", []):
        out += _enc_len(
            9, _enc_len(1, _enc_tag(1, 0) + _enc_varint(c["expressionIdx"]["idx"]))
        )
    for h in pilout.get("hints", []):
        out += _enc_len(10, _enc_hint(h))
    for s in pilout.get("symbols", []):
        out += _enc_len(11, _enc_symbol(s))
    return out
