"""Fflonk chelpers twin: flattened TAC bytecode streams + `.fflonkchelpers.bin`
artifact + a column-vectorized stream interpreter the prover actually runs.

Reference counterpart: the pil-fflonk C++ codegen
(pil2-stark-js src/fflonk/chelpers/fflonk_chelpers.js:1-242 emits
`PilFflonkSteps` C++ bodies; compileCode_parser.js:12-1424 flattens each
code section into `ops[]`/`args[]` integer streams consumed by a generated
AVX interpreter; compileCode_QPolynomial.js specializes the Q section).

A redesign, NOT a translation (copied from the JAX package):
- The reference encodes (op, dest type, src types, prime flags) into a
  ~115-entry opcode cross-product so the C++ dispatch loop never inspects
  operand classes.  Here the opcode is the arithmetic op alone (add / sub /
  mul / muladd / copy — muladd is our codegen's fusion, absent upstream)
  and every operand is a self-describing packed u32 triple
  ``(class, id, prime)``.  The stream is therefore a *superset* encoding of
  the reference's: each reference opcode corresponds to one (op, operand
  classes) pattern here, with no information dropped — and it stays valid
  when codegen grows new operand-class combinations, where the reference
  enumeration would need regeneration.
- Execution is column-vectorized over Fr (whole-(N,) numpy object lanes per
  instruction) instead of the reference's per-row i-loop with AVX lanes.
  Fflonk tiers run at recursion scale (N <= 2^17, SURVEY §2.2), so this is
  deliberately host code — the same placement as the reference's generated
  C++ running on the host next to the GPU STARK pipeline.

Streams per code unit:
  ops     : u8  per instruction — index into OPS
  args    : u32 — for each instruction: dest triple then N_SRC[op] src
            triples, each (class, id, prime) with class in CLASSES, id the
            symbol id (numbers index into the unit's numbers table;
            challenges pack (stage << 16) | stageId), prime 0/1.
  numbers : deduped Fr literals (32-byte LE in the file).

File container (utils/binfile iden3 layout, magic ``fchp``):
  section 1 header — pilPower, nBitsZK, extendBits(Q), counts
  section 2 imPols units (one per witness stage, in order)
  section 3 expressions units (expId-tagged; includes the Q/cExpId unit)
  section 4 constraints-debug units (stage-tagged)
"""
from __future__ import annotations

import struct

import numpy as np

from ..ops.fft_bn128 import FR
from ..utils import binfile
from . import fr_ctx

MAGIC = b"fchp"
VERSION = 1

SEC_HEADER, SEC_IMPOLS, SEC_EXPRESSIONS, SEC_CONSTRAINTS = 1, 2, 3, 4

OPS = ("add", "sub", "mul", "muladd", "copy")
N_SRC = {"add": 2, "sub": 2, "mul": 2, "muladd": 3, "copy": 1}

# operand classes (dest classes first; 'q' is dest-only, 'x'/'eval'/... are
# src-only — the interpreter enforces that)
CLASSES = ("tmp", "cm", "q", "const", "number", "public", "challenge",
           "x", "eval", "subproofValue")
_CLS = {c: i for i, c in enumerate(CLASSES)}
_OP = {o: i for i, o in enumerate(OPS)}


def _pack_ref(r, numbers, number_ids):
    """ref dict -> (class, id, prime) u32 triple."""
    t = r["type"]
    p = r.get("prime")
    if p not in (None, False, True, 0, 1):
        # fr_ctx._shift_amount supports arbitrary row offsets, but this
        # encoding carries one bit — reject rather than silently truncate
        raise ValueError(
            f"fflonk chelpers: non-boolean row offset prime={p!r} is not "
            "encodable (only next-row references are)"
        )
    prime = 1 if p else 0
    if t == "number":
        v = int(r["value"]) % FR
        if v not in number_ids:
            number_ids[v] = len(numbers)
            numbers.append(v)
        return (_CLS["number"], number_ids[v], 0)
    if t == "challenge":
        return (_CLS["challenge"], (int(r["stage"]) << 16) | int(r["stageId"]), 0)
    if t == "x":
        return (_CLS["x"], 0, 0)
    if t == "q":
        return (_CLS["q"], 0, 0)
    if t in ("tmp", "cm", "const", "public", "eval", "subproofValue"):
        return (_CLS[t], int(r["id"]), prime)
    raise ValueError(f"fflonk chelpers: unsupported ref type {t!r}")


def flatten_code(code_obj) -> dict:
    """One TAC code unit -> {"ops", "args", "numbers", "tmpUsed"} streams."""
    code = code_obj["code"] if isinstance(code_obj, dict) else code_obj
    tmp_used = code_obj.get("tmpUsed", 0) if isinstance(code_obj, dict) else 0
    ops, args, numbers = [], [], []
    number_ids: dict = {}
    for inst in code:
        op = inst["op"]
        if op not in _OP:
            raise ValueError(f"fflonk chelpers: unsupported op {op!r}")
        if len(inst["src"]) != N_SRC[op]:
            raise ValueError(f"{op}: expected {N_SRC[op]} srcs, "
                             f"got {len(inst['src'])}")
        ops.append(_OP[op])
        args.extend(_pack_ref(inst["dest"], numbers, number_ids))
        for s in inst["src"]:
            args.extend(_pack_ref(s, numbers, number_ids))
    return {
        "ops": np.asarray(ops, dtype=np.uint8),
        "args": np.asarray(args, dtype=np.uint32),
        "numbers": numbers,
        "tmpUsed": int(tmp_used),
    }


def build(expressions_info) -> dict:
    """expressionsInfo -> flattened units for every section the prover runs
    (imPolsCode per stage, expressionsCode incl. the Q unit, constraints)."""
    im_units = [flatten_code(c) for c in expressions_info["imPolsCode"]]
    exp_units = []
    for e in expressions_info["expressionsCode"]:
        u = flatten_code(e["code"])
        u["expId"] = int(e["expId"])
        exp_units.append(u)
    con_units = []
    for c in expressions_info["constraints"]:
        u = flatten_code(c)
        u["stage"] = int(c.get("stage", 0))
        con_units.append(u)
    return {"imPols": im_units, "expressions": exp_units,
            "constraints": con_units}


# ---------------------------------------------------------------- execution

def execute_stream(ctx, unit, dom, ret=False):
    """Run one flattened unit on a FrProverCtx — bit-equal to
    fr_ctx.execute_code on the unit's source TAC (differentially tested)."""
    ops = unit["ops"]
    args = unit["args"]
    numbers = unit["numbers"]
    if len(ctx.tmp) < unit["tmpUsed"]:
        ctx.tmp.extend([None] * (unit["tmpUsed"] - len(ctx.tmp)))

    i_cm = _CLS["cm"]
    get, put = _make_get(ctx, numbers, dom), _make_set(ctx, dom)
    pos = 0
    last = None
    for op in ops:
        n_src = N_SRC[OPS[op]]
        d = args[pos:pos + 3]
        pos += 3
        srcs = [get(args[pos + 3 * k], args[pos + 3 * k + 1],
                    args[pos + 3 * k + 2]) for k in range(n_src)]
        pos += 3 * n_src
        if op == 0:
            v = srcs[0] + srcs[1]
        elif op == 1:
            v = srcs[0] - srcs[1]
        elif op == 2:
            v = srcs[0] * srcs[1]
        elif op == 3:
            v = srcs[0] * srcs[1] + srcs[2]
        else:  # copy
            v = srcs[0]
        if op != 4:
            v = fr_ctx._mod(v)
        put(d[0], d[1], d[2], v)
        last = (d, v)
    if ret and last is not None:
        d, v = last
        if d[0] == i_cm or d[0] == _CLS["tmp"]:
            return get(d[0], d[1], d[2])
        # parity with fr_ctx.execute_code(ret=True), whose get_ref has no
        # branch for non-readable dest classes ('q') and raises
        raise ValueError(
            f"execute_stream(ret=True): dest class "
            f"{CLASSES[d[0]]!r} is not readable"
        )
    return None


def _make_get(ctx, numbers, dom):
    roll, shift = fr_ctx._roll_read, fr_ctx._shift_amount
    i_tmp, i_cm, i_const = _CLS["tmp"], _CLS["cm"], _CLS["const"]
    i_num, i_pub, i_chal = _CLS["number"], _CLS["public"], _CLS["challenge"]
    i_x, i_eval, i_spv = _CLS["x"], _CLS["eval"], _CLS["subproofValue"]

    def get(cls, rid, prime):
        if cls == i_tmp:
            return ctx.tmp[rid]
        if cls == i_cm:
            p = ctx.get_pol_ref(rid, dom)
            col = p["buffer"][:, p["offset"]]
            return roll(col, shift(prime, ctx, dom))
        if cls == i_const:
            col = ctx.buffer("const", dom)[:, rid]
            return roll(col, shift(prime, ctx, dom))
        if cls == i_num:
            return numbers[rid]
        if cls == i_pub:
            return int(ctx.publics[rid]) % FR
        if cls == i_chal:
            return ctx.challenges[(rid >> 16) - 1][rid & 0xFFFF]
        if cls == i_x:
            return ctx.x_n if dom == "n" else ctx.x_ext
        if cls == i_eval:
            return ctx.evals[rid]
        if cls == i_spv:
            return int(ctx.subproof_values[rid]) % FR
        raise ValueError(f"invalid src class {cls}")

    return get


def _make_set(ctx, dom):
    i_tmp, i_cm, i_q = _CLS["tmp"], _CLS["cm"], _CLS["q"]

    def put(cls, rid, prime, val):
        if cls == i_tmp:
            ctx.tmp[rid] = val
            return
        if cls == i_q:
            fr_ctx.set_ref(ctx, {"type": "q"}, val, dom)
            return
        if cls == i_cm:
            fr_ctx.set_ref(
                ctx, {"type": "cm", "id": int(rid), "prime": bool(prime)},
                val, dom)
            return
        raise ValueError(f"invalid dest class {cls}")

    return put


# ---------------------------------------------------------------- binfile

def _unit_bytes(u, extra: int | None = None) -> bytes:
    out = [struct.pack("<IIII", u["tmpUsed"], len(u["ops"]),
                       len(u["args"]), len(u["numbers"]))]
    if extra is not None:
        out.append(struct.pack("<I", extra))
    out.append(u["ops"].tobytes())
    out.append(u["args"].astype("<u4").tobytes())
    for v in u["numbers"]:
        out.append(int(v).to_bytes(32, "little"))
    return b"".join(out)


def _read_unit(buf: bytes, pos: int, has_extra: bool):
    tmp_used, n_ops, n_args, n_num = struct.unpack_from("<IIII", buf, pos)
    pos += 16
    extra = None
    if has_extra:
        (extra,) = struct.unpack_from("<I", buf, pos)
        pos += 4
    ops = np.frombuffer(buf, dtype=np.uint8, count=n_ops, offset=pos).copy()
    pos += n_ops
    args = np.frombuffer(buf, dtype="<u4", count=n_args, offset=pos
                         ).astype(np.uint32)
    pos += 4 * n_args
    numbers = []
    for _ in range(n_num):
        numbers.append(int.from_bytes(buf[pos:pos + 32], "little"))
        pos += 32
    return {"tmpUsed": tmp_used, "ops": ops, "args": args,
            "numbers": numbers}, extra, pos


def _section(units, extras=None) -> bytes:
    out = [struct.pack("<I", len(units))]
    for i, u in enumerate(units):
        out.append(_unit_bytes(u, None if extras is None else extras[i]))
    return b"".join(out)


def _read_section(buf: bytes, has_extra: bool):
    (n,) = struct.unpack_from("<I", buf, 0)
    pos, units, extras = 4, [], []
    for _ in range(n):
        u, extra, pos = _read_unit(buf, pos, has_extra)
        units.append(u)
        extras.append(extra)
    return units, extras


def write_file(path: str, pil_info, expressions_info) -> dict:
    """Emit the `.fflonkchelpers.bin` artifact.  Returns the built units."""
    units = build(expressions_info)
    extend_bits = (pil_info["qDeg"]).bit_length()
    header = struct.pack(
        "<IIIIII", pil_info["pilPower"], pil_info["nBitsZK"], extend_bits,
        len(units["imPols"]), len(units["expressions"]),
        len(units["constraints"]))
    sections = [
        (SEC_HEADER, header),
        (SEC_IMPOLS, _section(units["imPols"])),
        (SEC_EXPRESSIONS, _section(
            units["expressions"],
            [u["expId"] for u in units["expressions"]])),
        (SEC_CONSTRAINTS, _section(
            units["constraints"],
            [u["stage"] for u in units["constraints"]])),
    ]
    binfile.write_bin_file(path, MAGIC, VERSION, sections)
    return units


def read_file(path: str) -> dict:
    magic, version, secs = binfile.read_bin_file(path, MAGIC)
    if version != VERSION:
        raise ValueError(f"{path}: fflonk chelpers version {version} != "
                         f"{VERSION}")
    (pil_power, n_bits_zk, extend_bits, n_im, n_exp, n_con
     ) = struct.unpack_from("<IIIIII", secs[SEC_HEADER], 0)
    im_units, _ = _read_section(secs[SEC_IMPOLS], False)
    exp_units, exp_ids = _read_section(secs[SEC_EXPRESSIONS], True)
    con_units, con_stages = _read_section(secs[SEC_CONSTRAINTS], True)
    for u, eid in zip(exp_units, exp_ids):
        u["expId"] = eid
    for u, st in zip(con_units, con_stages):
        u["stage"] = st
    if (len(im_units), len(exp_units), len(con_units)) != (n_im, n_exp, n_con):
        raise ValueError(f"{path}: section counts disagree with header")
    return {
        "pilPower": pil_power, "nBitsZK": n_bits_zk, "extendBits": extend_bits,
        "imPols": im_units, "expressions": exp_units,
        "constraints": con_units,
    }
