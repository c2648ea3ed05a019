"""`.chelpers.bin` artifact: the reference's binary constraint-evaluator
program streams, consumed by the external C++ zkevm-prover.

Byte-layout port of pil2-stark-js src/stark/chelpers/binFile.js (iden3
"chps" container, sections: 2 imPols, 3 expressions, 4 constraintsDebug,
5 hints) with the TAC flattening of getParserArgs.js:12-201 — per code
unit: an ops[] byte stream (indexes into the canonical operation table of
generateParser.js getAllOperations), an args[] u16 stream (register-
allocated tmp ids via the segment-packing of helpers.js getIdMaps, and
(stage, stagePos, openingPoint) triples for column operands), a numbers[]
u64 stream, and the sorted symbol-id lists per class.

The prover executes TACs as compiled programs (ops/torch_tac, T1)
instead of generated C++, so the artifact exists purely for reference
interop/parity.  Documented divergences:
- `copy` instructions are lowered to `add dest, src, number(0)` (the
  reference's generated codes never contain copy; ours can).
- `findPatterns` window compression is not applied (it only fires above
  400 reduced operations — zkevm-scale codes; the uncompressed stream is
  a valid instance of the same format, ops indexing the base table).
"""
from __future__ import annotations

import struct

from ..utils import binfile

MAGIC = b"chps"
SEC_IMPOLS, SEC_EXPRESSIONS, SEC_CONSTRAINTS, SEC_HINTS = 2, 3, 4, 5

P = 0xFFFFFFFF00000001

# generateParser.js:1-14
OPERATIONS_MAP = {
    "commit1": 1, "Zi": 2, "const": 3, "tmp1": 4, "public": 5, "number": 6,
    "commit3": 7, "xDivXSubXi": 8, "tmp3": 9, "subproofValue": 10,
    "challenge": 11, "eval": 12,
}


def get_all_operations() -> list:
    """generateParser.js getAllOperations:519-577 — the canonical op-table
    enumeration the ops[] bytes index into."""
    ops = []
    dest1 = ["commit1", "tmp1"]
    dest3 = ["commit3", "tmp3"]
    src1 = ["commit1", "tmp1", "public", "number"]
    src3 = ["commit3", "tmp3", "challenge", "subproofValue"]

    for d in dest1:
        for k, s0 in enumerate(src1):
            for s1 in src1[k:]:
                ops.append({"dest_type": d, "src0_type": s0, "src1_type": s1})
    for d in dest3:
        for s0 in src3:
            for s1 in src1:
                ops.append({"dest_type": d, "src0_type": s0, "src1_type": s1})
        for k, s0 in enumerate(src3):
            for s1 in src3[k:]:
                if s0 == "challenge":
                    ops.append({"op": "mul", "dest_type": d,
                                "src0_type": s1, "src1_type": s0})
                elif s1 == "challenge":
                    ops.append({"op": "mul", "dest_type": d,
                                "src0_type": s0, "src1_type": s1})
                ops.append({"dest_type": d, "src0_type": s0, "src1_type": s1})
    # step FRI extras
    ops.append({"op": "mul", "dest_type": "tmp3", "src0_type": "eval",
                "src1_type": "challenge"})
    ops.append({"dest_type": "tmp3", "src0_type": "challenge", "src1_type": "eval"})
    ops.append({"dest_type": "tmp3", "src0_type": "tmp3", "src1_type": "eval"})
    ops.append({"dest_type": "tmp3", "src0_type": "eval", "src1_type": "commit1"})
    ops.append({"dest_type": "tmp3", "src0_type": "commit3", "src1_type": "eval"})
    ops.append({"dest_type": "tmp3", "src0_type": "commit3", "src1_type": "eval"})
    return ops


def _segments_pack(segments):
    """helpers.js temporalsSubsets:101-125 — greedy closest-fit packing of
    non-intersecting live ranges onto registers."""
    segments = sorted(segments, key=lambda s: s[1])
    subsets = []
    for seg in segments:
        closest = None
        min_d = None
        for sub in subsets:
            last = sub[-1]
            if seg[0] < last[1] and last[0] < seg[1]:  # intersecting
                continue
            d = abs(last[1] - seg[0])
            if min_d is None or d < min_d:
                min_d = d
                closest = sub
        if closest is not None:
            closest.append(seg)
        else:
            subsets.append([seg])
    return subsets


def get_id_maps(code):
    """helpers.js getIdMaps:3-99 — first/last appearance live ranges per
    tmp id, packed into register ids per dim."""
    ini1, end1, ini3, end3 = {}, {}, {}, {}

    def touch(ref, j):
        if ref["type"] != "tmp":
            return
        tid, dim = ref["id"], ref["dim"]
        (ini, end) = (ini1, end1) if dim == 1 else (ini3, end3)
        if tid not in ini:
            ini[tid] = j
        end[tid] = j

    for j, r in enumerate(code):
        touch(r["dest"], j)
        for s in r["src"]:
            touch(s, j)

    id1d, id3d = {}, {}
    for (ini, end, out) in ((ini1, end1, id1d), (ini3, end3, id3d)):
        segments = [[ini[t], end[t], t] for t in sorted(ini)]
        for reg, sub in enumerate(_segments_pack(segments)):
            for seg in sub:
                out[seg[2]] = reg
    return id1d, id3d, len(_segments_pack(
        [[ini1[t], end1[t], t] for t in sorted(ini1)]
    )), len(_segments_pack([[ini3[t], end3[t], t] for t in sorted(ini3)]))


def _type_key(ref):
    t = ref["type"]
    if t == "cm":
        return OPERATIONS_MAP[f"commit{ref['dim']}"]
    if t == "tmp":
        return OPERATIONS_MAP[f"tmp{ref['dim']}"]
    if t == "x":
        return OPERATIONS_MAP["commit1"]
    return OPERATIONS_MAP[t]


def _op_type(ref):
    t = ref["type"]
    if t == "cm":
        return f"commit{ref['dim']}"
    if t in ("const", "Zi", "x"):
        return "commit1"
    if t == "xDivXSubXi":
        return "commit3"
    if t == "tmp":
        return f"tmp{ref['dim']}"
    return t


def get_operation(r):
    """generateParser.js getOperation:580-618 — canonicalize an
    instruction: sort sources by (dim desc, type id), flipping sub into
    sub_swap when the sort swaps them."""
    op = {"op": r["op"]}
    d = r["dest"]
    op["dest_type"] = (f"commit{d['dim']}" if d["type"] == "cm"
                       else f"tmp{d['dim']}" if d["type"] == "tmp"
                       else d["type"])
    src = list(r["src"])
    if len(src) == 2:
        a, b = src
        swap = (b["dim"] - a["dim"]) if a.get("dim") != b.get("dim") \
            else (_type_key(a) - _type_key(b))
        if swap > 0:
            src = [b, a]
            if r["op"] == "sub":
                op["op"] = "sub_swap"
    for i, s in enumerate(src):
        op[f"src{i}_type"] = _op_type(s)
    op["src"] = src
    return op


_OP_CODE = {"add": 0, "sub": 1, "mul": 2, "sub_swap": 3}


def get_parser_args(stark_info, operations, code_obj, dom, debug=False):
    """getParserArgs.js:12-201."""
    code = []
    for r in code_obj["code"]:
        if r["op"] == "copy":
            # documented divergence: copy -> add(src, 0)
            code.append({
                "op": "add", "dest": r["dest"],
                "src": [r["src"][0],
                        {"type": "number", "value": 0, "dim": 1}],
            })
        else:
            code.append(r)

    ops, args, numbers = [], [], []
    id1d, id3d, n_tmp1, n_tmp3 = get_id_maps(code)
    openings = list(stark_info["openingPoints"])

    def eval_map(pol_id, prime):
        p = stark_info["cmPolsMap"][pol_id]
        args.append(int(p["stage"]))
        args.append(int(p["stagePos"]))
        args.append(openings.index(prime or 0))

    def push_res(r):
        d = r["dest"]
        if d["type"] == "tmp":
            args.append(id1d[d["id"]] if d["dim"] == 1 else id3d[d["id"]])
        elif d["type"] == "cm":
            eval_map(d["id"], d.get("prime", 0))
        else:
            raise ValueError(f"Invalid reference type set: {d['type']}")

    def push_src(s):
        t = s["type"]
        if t == "tmp":
            args.append(id1d[s["id"]] if s["dim"] == 1 else id3d[s["id"]])
        elif t == "const":
            args.append(0)
            args.append(s["id"])
            args.append(openings.index(s.get("prime", 0) or 0))
        elif t == "cm":
            eval_map(s["id"], s.get("prime", 0))
        elif t == "number":
            num = int(s["value"]) % P
            if num not in numbers:
                numbers.append(num)
            args.append(numbers.index(num))
        elif t in ("public", "subproofValue", "eval", "challenge"):
            args.append(s["id"])
        elif t == "xDivXSubXi":
            args.append(stark_info["nStages"] + 2)
            args.append(0)
            args.append(3 * s["id"])
        elif t == "Zi":
            args.append(stark_info["nStages"] + 2)
            args.append(0)
            args.append(s["boundaryId"])
        elif t == "x":
            # documented divergence: the reference's getParserArgs has no
            # case for the raw domain column (its PIL2 codes never emit
            # one; PIL1 connection arguments do) — encoded Zi-style with
            # stagePos 1 to stay disjoint from the Zi triples
            args.append(stark_info["nStages"] + 2)
            args.append(1)
            args.append(0)
        else:
            raise ValueError(f"Invalid source type: {t}")

    for r in code:
        operation = get_operation(r)
        args.append(_OP_CODE[operation["op"]])
        push_res(r)
        for s in operation["src"]:
            push_src(s)

        def match(op):
            if (operation["op"] == "mul"
                    and operation["dest_type"] in ("tmp3", "commit3")
                    and operation.get("src1_type") == "challenge"):
                want_op = "mul"
            else:
                want_op = None
            return (op.get("op") == want_op
                    and op["dest_type"] == operation["dest_type"]
                    and op.get("src0_type") == operation.get("src0_type")
                    and op.get("src1_type") == operation.get("src1_type"))

        idx = next((i for i, op in enumerate(operations) if match(op)), -1)
        if idx == -1:
            raise ValueError(f"Operation not considered: {operation}")
        ops.append(idx)

    used = code_obj.get("symbolsUsed", [])

    def ids(kind):
        return sorted(s["id"] for s in used if s["op"] == kind)

    info = {
        "nTemp1": n_tmp1, "nTemp3": n_tmp3,
        "ops": ops, "args": args, "numbers": numbers,
        "constPolsIds": ids("const"), "cmPolsIds": ids("cm"),
        "challengeIds": ids("challenge"), "publicsIds": ids("public"),
        "subproofValuesIds": ids("subproofValue"),
    }
    if debug:
        # getParserArgs.js:77-85 — indexes ID1D/ID3D by the raw dest id
        # even when the dest is a committed column (the arrays are -1
        # prefilled, so non-tmp dests record 0xFFFFFFFF)
        dest = code[-1]["dest"]
        table = id1d if dest["dim"] == 1 else id3d
        info["destDim"] = dest["dim"]
        info["destId"] = (table.get(dest["id"], 0xFFFFFFFF)
                          if dest["type"] == "tmp"
                          else table.get(dest["id"], 0xFFFFFFFF))
    return info


# ---------------------------------------------------------------------------
# binary writer (binFile.js byte layout)


def _u32(v):
    return struct.pack("<I", int(v))


def _stream_tables(infos):
    """Concatenate per-unit streams + per-unit offsets (binFile.js's
    repeated offset bookkeeping)."""
    keys = ("ops", "args", "numbers", "constPolsIds", "cmPolsIds",
            "challengeIds", "publicsIds", "subproofValuesIds")
    total = {k: [] for k in keys}
    offsets = {k: [] for k in keys}
    for info in infos:
        for k in keys:
            offsets[k].append(len(total[k]))
            total[k].extend(info[k])
    return total, offsets


def _stream_bytes(total):
    out = b""
    out += bytes(bytearray(total["ops"]))
    out += b"".join(struct.pack("<H", v) for v in total["args"])
    out += b"".join(struct.pack("<Q", v) for v in total["numbers"])
    for k in ("constPolsIds", "cmPolsIds", "challengeIds", "publicsIds",
              "subproofValuesIds"):
        out += b"".join(struct.pack("<H", v) for v in total[k])
    return out


def _counts_header(total):
    out = b""
    for k in ("ops", "args", "numbers", "constPolsIds", "cmPolsIds",
              "challengeIds", "publicsIds", "subproofValuesIds"):
        out += _u32(len(total[k]))
    return out


def _unit_header(info, offsets, i):
    out = b""
    for k in ("ops", "args", "numbers", "constPolsIds", "cmPolsIds",
              "challengeIds", "publicsIds", "subproofValuesIds"):
        out += _u32(len(info[k])) + _u32(offsets[k][i])
    return out


def _impols_section(im_infos):
    total, offsets = _stream_tables(im_infos)
    out = _counts_header(total)
    out += _u32(len(im_infos))
    for i, info in enumerate(im_infos):
        out += _u32(info["nTemp1"]) + _u32(info["nTemp3"])
        out += _unit_header(info, offsets, i)
    return out + _stream_bytes(total)


def _expressions_section(exp_infos):
    total, offsets = _stream_tables(exp_infos)
    out = _counts_header(total)
    out += _u32(len(exp_infos))
    for i, info in enumerate(exp_infos):
        out += _u32(info["expId"]) + _u32(info["destDim"]) + _u32(info["destId"])
        out += _u32(info["stage"])
        out += _u32(info["nTemp1"]) + _u32(info["nTemp3"])
        out += _unit_header(info, offsets, i)
    return out + _stream_bytes(total)


def _constraints_section(con_infos):
    total, offsets = _stream_tables(con_infos)
    out = _counts_header(total)
    out += _u32(len(con_infos))
    for i, info in enumerate(con_infos):
        out += _u32(info["stage"])
        out += _u32(info["destDim"]) + _u32(info["destId"])
        out += _u32(info["firstRow"]) + _u32(info["lastRow"])
        out += _u32(info["nTemp1"]) + _u32(info["nTemp3"])
        out += _unit_header(info, offsets, i)
    return out + _stream_bytes(total)


def _hints_section(hints_info):
    out = _u32(len(hints_info))
    for hint in hints_info:
        out += hint["name"].encode() + b"\0"
        out += _u32(len(hint["fields"]))
        for f in hint["fields"]:
            out += f["name"].encode() + b"\0"
            out += f["op"].encode() + b"\0"
            if f["op"] == "number":
                out += struct.pack("<Q", int(f["value"]) % P)
            else:
                out += _u32(f.get("id", 0))
            if f["op"] == "tmp":
                out += _u32(f["dim"])
    return out


def build_chelpers(stark_info, expressions_info):
    """buildCHelpers (stark_chelpers.js:5-192), binfile half: flatten every
    code unit to parser-args streams, collect the used-op subset, and remap
    ops to subset indexes (the generated C++ switch uses the same order)."""
    operations = get_all_operations()
    used = []

    def parse(code_obj, debug=False):
        info = get_parser_args(stark_info, operations, code_obj, "n", debug)
        for o in info["ops"]:
            if o not in used:
                used.append(o)
        return info

    im_infos = []
    for i in range(stark_info["nStages"]):
        im_infos.append(parse(expressions_info["imPolsCode"][i]))

    n = 1 << stark_info["starkStruct"]["nBits"]
    con_infos = []
    for c in expressions_info["constraints"]:
        boundary = c["boundary"]
        if boundary == "everyRow":
            first, last = 0, n
        elif boundary in ("firstRow", "finalProof"):
            first, last = 0, 1
        elif boundary == "lastRow":
            first, last = n - 1, n
        elif boundary == "everyFrame":
            first, last = c["offsetMin"], n - c["offsetMax"]
        else:
            raise ValueError(f"Invalid boundary: {boundary}")
        info = parse(c, debug=True)
        info["stage"] = c["stage"]
        info["firstRow"], info["lastRow"] = first, last
        con_infos.append(info)

    import copy as _copy

    exp_infos = []
    for e in expressions_info["expressionsCode"]:
        if not e:
            continue
        ecode = _copy.deepcopy(e)
        if ecode["expId"] in (stark_info["cExpId"], stark_info["friExpId"]):
            last = ecode["code"]["code"][-1]
            last["dest"] = {"type": "tmp", "id": ecode["code"]["tmpUsed"],
                            "dim": last["dest"].get("dim", 3)}
            ecode["code"]["tmpUsed"] += 1
        info = parse(ecode["code"], debug=True)
        info["expId"] = ecode["expId"]
        info["stage"] = ecode["stage"]
        if ecode["expId"] in (stark_info["cExpId"], stark_info["friExpId"]):
            info["destDim"] = 0
            info["destId"] = 0
        exp_infos.append(info)

    used.sort()
    for infos in (im_infos, con_infos, exp_infos):
        for info in infos:
            info["ops"] = [used.index(o) for o in info["ops"]]

    hints_info = []
    for h in expressions_info.get("hintsInfo", []):
        hints_info.append(h)

    return {
        "imPolsInfo": im_infos,
        "expsInfo": exp_infos,
        "constraintsInfo": con_infos,
        "hintsInfo": hints_info,
        "opsUsed": used,
    }


def write_chelpers_file(path: str, stark_info, expressions_info) -> dict:
    """Write the .chelpers.bin artifact; returns the build info (including
    the used-op subset, which the generated parser shares)."""
    built = build_chelpers(stark_info, expressions_info)
    binfile.write_bin_file(path, MAGIC, 1, [
        (SEC_IMPOLS, _impols_section(built["imPolsInfo"])),
        (SEC_EXPRESSIONS, _expressions_section(built["expsInfo"])),
        (SEC_CONSTRAINTS, _constraints_section(built["constraintsInfo"])),
        (SEC_HINTS, _hints_section(built["hintsInfo"])),
    ])
    return built


# ---------------------------------------------------------------------------
# reader (round-trip validation; the reference's reader lives in the C++
# prover, so this is the in-repo differential check)


def _read_streams(buf, pos, counts):
    total = {}
    n_ops, n_args, n_nums, n_c, n_cm, n_ch, n_pub, n_sv = counts
    total["ops"] = list(buf[pos:pos + n_ops])
    pos += n_ops
    for key, n, fmt, sz in (
        ("args", n_args, "<H", 2), ("numbers", n_nums, "<Q", 8),
        ("constPolsIds", n_c, "<H", 2), ("cmPolsIds", n_cm, "<H", 2),
        ("challengeIds", n_ch, "<H", 2), ("publicsIds", n_pub, "<H", 2),
        ("subproofValuesIds", n_sv, "<H", 2),
    ):
        total[key] = [struct.unpack_from(fmt, buf, pos + sz * i)[0]
                      for i in range(n)]
        pos += sz * n
    return total


_KEYS = ("ops", "args", "numbers", "constPolsIds", "cmPolsIds",
         "challengeIds", "publicsIds", "subproofValuesIds")


def _read_units(buf, extra_fields):
    counts = struct.unpack_from("<8I", buf, 0)
    (n_units,) = struct.unpack_from("<I", buf, 32)
    pos = 36
    headers = []
    for _ in range(n_units):
        h = {}
        for f in extra_fields:
            (h[f],) = struct.unpack_from("<I", buf, pos)
            pos += 4
        for k in _KEYS:
            ln, off = struct.unpack_from("<II", buf, pos)
            pos += 8
            h[k] = (ln, off)
        headers.append(h)
    total = _read_streams(buf, pos, counts)
    units = []
    for h in headers:
        u = {f: h[f] for f in extra_fields}
        for k in _KEYS:
            ln, off = h[k]
            u[k] = total[k][off:off + ln]
        units.append(u)
    return units


def read_chelpers_file(path: str) -> dict:
    magic, _, sections = binfile.read_bin_file(path, MAGIC)
    out = {
        "imPolsInfo": _read_units(sections[SEC_IMPOLS],
                                  ("nTemp1", "nTemp3")),
        "expsInfo": _read_units(
            sections[SEC_EXPRESSIONS],
            ("expId", "destDim", "destId", "stage", "nTemp1", "nTemp3"),
        ),
        "constraintsInfo": _read_units(
            sections[SEC_CONSTRAINTS],
            ("stage", "destDim", "destId", "firstRow", "lastRow",
             "nTemp1", "nTemp3"),
        ),
    }
    buf = sections[SEC_HINTS]
    (n_hints,) = struct.unpack_from("<I", buf, 0)
    pos = 4

    def cstr(pos):
        end = buf.index(b"\0", pos)
        return buf[pos:end].decode(), end + 1

    hints = []
    for _ in range(n_hints):
        name, pos = cstr(pos)
        (n_fields,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        fields = []
        for _ in range(n_fields):
            fname, pos = cstr(pos)
            fop, pos = cstr(pos)
            f = {"name": fname, "op": fop}
            if fop == "number":
                (f["value"],) = struct.unpack_from("<Q", buf, pos)
                pos += 8
            else:
                (f["id"],) = struct.unpack_from("<I", buf, pos)
                pos += 4
            if fop == "tmp":
                (f["dim"],) = struct.unpack_from("<I", buf, pos)
                pos += 4
            fields.append(f)
        hints.append({"name": name, "fields": fields})
    out["hintsInfo"] = hints
    return out
