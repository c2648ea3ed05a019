"""Device TAC executor: compiles a setup's TAC program once, then evaluates
it row by row on the card (kernel T1: a CUDA kernel generated from the
program by ops/tac_codegen.py, launched by ops/cuda_tac.py) or, for CPU
tensors, whole columns at a time with torch ops (``run_plain``, T1's plain
version).

Counterpart of pil2_stark_tpu/ops/jax_tac.py (``make_executor`` :53,
``pack_inputs`` :220) in its planar form: a section is a (cols, rows) int64
tensor, a value a (d, N) tensor with d in {1, 3} (field/torch_f3), and a
rotation reads row (i + prime·2^extendBits) mod N (prover_helpers.js
getRef/evalMap).  The JAX package traces the program into one XLA
computation, which frees dead values and fuses the chain; here
``compile_program`` does the freeing itself:

  * every operand resolves to a descriptor: a slot, a column (a section
    column, x, a Zi row, an xDivXSubXi opening, or a buffer the program
    writes) with its row shift, or an entry of the scalar table (numbers,
    publics, challenges, evals, subproof values);
  * each write of a ``tmp`` is a value that takes the lowest free slot; a
    slot is freed after the last read of its value, so the slot count is
    the peak of live values;
  * each write of ``q``, ``f`` or a ``cm`` goes to a buffer of its own,
    row i's value to row (i + shift) mod N;
  * a read of a buffer written earlier in the same program through another
    row shift than the write's needs the whole buffer, so the program is
    cut there into segments run one after another; values live across the
    cut are stored to carry buffers at the end of one segment and loaded
    back at the start of the next.

A run may cover a window of rows (``window=(base, rows)``): a mesh's shard
passes its rows with the ``halo`` its shifts reach on either side, and the
program computes the shard's rows alone, each shift taken as the signed
offset prime·2^extendBits, so that no read wraps.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np
import torch

from ..field import f3, gl64
from ..field import torch_gl as gl
from ..field import torch_f3 as f3g
from ..utils import cuda_build
from . import cuda_tac, tac_codegen

OPS = ("copy", "add", "sub", "mul", "muladd")
_ARITY = {"copy": 1, "add": 2, "sub": 2, "mul": 2, "muladd": 3}
_CACHE: dict = {}


def _shift_amount(prime, dom, n, extend_bits):
    if not prime:
        return 0
    if dom == "n":
        return prime % n
    return (prime << extend_bits) % n


def _zi_index(pil_info, boundary_id):
    boundary = pil_info["boundaries"][boundary_id]
    return next(
        i for i, b in enumerate(pil_info["boundaries"])
        if b["name"] == boundary["name"]
        and b.get("offsetMin") == boundary.get("offsetMin")
        and b.get("offsetMax") == boundary.get("offsetMax")
    )


@dataclasses.dataclass
class Program:
    """A compiled TAC program.

    ins: (op, result dim, dest, srcs) per instruction, carries included.
    An operand is ("slot", s, d), ("col", c, d, shift) or ("scalar", k, d);
    a dest is ("slot", s) or ("col", c, d, shift) with c a written buffer.
    columns: what each column index reads: ("section", name, offset),
    ("x",), ("Zi", row), ("xdiv", opening) or ("buf", b).
    buffers: (output key, dim) of each written buffer; the key is "q",
    "f", ("cm", section, offset, dim) or ("carry", value).
    """

    n: int
    ins: list
    segments: list
    n_slots: int
    columns: list
    col_dims: list  # the most components any operand reads of each column
    buffers: list
    numbers: list
    scalar_groups: dict  # group -> (offset in the scalar table, entries, words each)
    # T1's generated source ("generated") and the numbers on each device
    _kernel: dict = dataclasses.field(default_factory=dict)

    def cost(self) -> dict:
        """Per row: base-field words read from distinct input columns,
        words written to the final outputs, and GL products."""
        muls = 0
        for op, _, _, srcs in self.ins:
            if op in ("mul", "muladd"):
                da, db = srcs[0][2], srcs[1][2]
                muls += 6 if da == db == 3 else max(da, db)
        read = {}
        for _, _, _, srcs in self.ins:
            for s in srcs:
                if s[0] == "col" and self.columns[s[1]][0] != "buf":
                    read[s[1]] = max(read.get(s[1], 0), s[2])
        final = {}
        for key, dim in self.buffers:
            if key[0] != "carry":
                final[key] = dim
        return {"read_words": sum(read.values()), "write_words": sum(final.values()),
                "gl_muls": muls}


PROGRAMS = ("imPols", "q", "fri")


def device_program(pil_info: dict, expressions_info: dict, which: str):
    """(code object, dom) of one of a setup's device programs: the last
    stage's im-pols ("imPols", base domain), the quotient ("q") or the FRI
    polynomial ("fri"), both on the extended domain."""
    if which == "imPols":
        return expressions_info["imPolsCode"][pil_info["nStages"] - 1], "n"
    exp_id = {"q": pil_info["cExpId"], "fri": pil_info["friExpId"]}[which]
    code = next(e for e in expressions_info["expressionsCode"] if e["expId"] == exp_id)
    return code["code"], "ext"


def make_executor(code_obj, dom: str, pil_info: dict, n_bits: int, ext_bits: int | None):
    """Returns fn(inputs) for the TAC program `code_obj`.

    inputs: {"sections": {"const"|"cm1"|…: (cols, rows) tensor},
             "x": (N,), "Zi": (nBoundaries, extN), "xDivXSubXi": (nOpenings, 3, extN),
             "publics": (nPublics,), "challenges": (nChallenges, 3), "evals": (nEvals, 3),
             "subproofValues": (nSubproofValues, 3), needed only by a program that reads them}
    Output: {"q": (d, N), "f": (3, N), "cm": {(section, offset, dim): (d, N)}}
    for whatever the program writes.  CUDA inputs run kernel T1 (its build
    at first use, unless build_programs made it), CPU inputs its plain
    version.  fn(inputs, window=(base, rows)) runs the rows [base, base +
    rows) of inputs of base + rows + halo rows and returns outputs of
    `rows` rows.
    """
    prog = compile_program(code_obj, dom, pil_info, n_bits, ext_bits)
    return lambda inputs, window=None: run(prog, inputs, window)


def run(prog: Program, inputs, window=None) -> dict:
    """run_kernel for CUDA inputs, run_plain for CPU ones (make_executor)."""
    if inputs["x"].device.type == "cpu":
        return run_plain(prog, inputs, window)
    return run_kernel(prog, inputs, window)


def compile_program(code_obj, dom: str, pil_info: dict, n_bits: int,
                    ext_bits: int | None) -> Program:
    """The compiled form of `code_obj`, cached per program object (the
    cache entry pins code_obj and pil_info, so their ids stay theirs)."""
    key = (id(code_obj), id(pil_info), dom, n_bits, ext_bits)
    hit = _CACHE.get(key)
    if hit is None:
        hit = (_compile(code_obj["code"], dom, pil_info, n_bits, ext_bits), code_obj, pil_info)
        _CACHE[key] = hit
    return hit[0]


def _values(code, src_dim):
    """Each write of a tmp is one value.  Returns (per instruction: the
    value each src reads or None, the value the dest writes or None), the
    dims of the values and the index of each value's last read."""
    current = {}
    dims, last_read, per_ins = [], [], []
    for j, inst in enumerate(code):
        reads = []
        for r in inst["src"]:
            if r["type"] == "tmp":
                if r["id"] not in current:
                    raise ValueError(f"instruction {j} reads tmp {r['id']} before any write")
                v = current[r["id"]]
                last_read[v] = j
                reads.append(v)
            else:
                reads.append(None)
        dims_in = [dims[v] if v is not None else src_dim(r) for v, r in zip(reads, inst["src"])]
        op = inst["op"]
        if op not in OPS or len(inst["src"]) != _ARITY[op]:
            raise ValueError(f"Invalid op {op} with {len(inst['src'])} sources")
        res_dim = max(dims_in)
        wrote = None
        if inst["dest"]["type"] == "tmp":
            wrote = len(dims)
            current[inst["dest"]["id"]] = wrote
            dims.append(res_dim)
            last_read.append(-1)
        per_ins.append((reads, wrote, dims_in, res_dim))
    return per_ins, dims, last_read


def _compile(code, dom, pil_info, n_bits, ext_bits) -> Program:
    n = (1 << ext_bits) if dom == "ext" else (1 << n_bits)
    extend_bits = (ext_bits - n_bits) if ext_bits is not None else 0
    cm_map = pil_info["cmPolsMap"]

    def cm_key(r):
        p = cm_map[r["id"]]
        return ("cm", f"cm{p['stage']}", p["stagePos"], p["dim"])

    def src_dim(r):
        t = r["type"]
        if t == "cm":
            return cm_map[r["id"]]["dim"]
        if t in ("challenge", "eval", "xDivXSubXi", "subproofValue"):
            return 3
        if t in ("const", "number", "public", "x", "Zi"):
            return 1
        raise ValueError(f"Invalid ref type {t}")

    per_ins, dims, last_read = _values(code, src_dim)
    columns, col_index = [], {}
    buffers, buf_segment, buf_shift, current_buf = [], [], [], {}
    numbers, number_index = [], {}
    used = {"public": 0, "challenge": 0, "eval": 0, "subproofValue": 0}
    slot_of, free, n_slots = {}, [], 0
    ins, segments, seg_start = [], [], 0

    def column(ref):
        if ref not in col_index:
            col_index[ref] = len(columns)
            columns.append(ref)
        return col_index[ref]

    def new_buffer(key, dim, shift):
        buffers.append((key, dim))
        buf_segment.append(len(segments))
        buf_shift.append(shift)
        return column(("buf", len(buffers) - 1))

    def take_slot():
        nonlocal n_slots
        if free:
            return heapq.heappop(free)
        n_slots += 1
        return n_slots - 1

    def operand(r, value, d):
        t = r["type"]
        shift = _shift_amount(r.get("prime"), dom, n, extend_bits)
        if t == "tmp":
            return ("slot", slot_of[value], d)
        if t == "const":
            return ("col", column(("section", "const", r["id"])), 1, shift)
        if t == "cm":
            key = cm_key(r)
            if key in current_buf:
                return ("col", current_buf[key], d, shift)
            return ("col", column(("section", key[1], key[2])), d, shift)
        if t == "x":
            return ("col", column(("x",)), 1, 0)
        if t == "Zi":
            return ("col", column(("Zi", _zi_index(pil_info, r["boundaryId"]))), 1, 0)
        if t == "xDivXSubXi":
            return ("col", column(("xdiv", r["id"])), 3, 0)
        if t == "number":
            v = gl.i64(int(r["value"]))
            if v not in number_index:
                number_index[v] = len(numbers)
                numbers.append(v)
            return ("scalar", ("number", number_index[v]), 1)
        used[t] = max(used[t], r["id"] + 1)
        return ("scalar", (t, r["id"]), d)

    def needs_cut(inst):
        for r in inst["src"]:
            if r["type"] != "cm" or cm_key(r) not in current_buf:
                continue
            b = columns[current_buf[cm_key(r)]][1]
            shift = _shift_amount(r.get("prime"), dom, n, extend_bits)
            if buf_segment[b] == len(segments) and buf_shift[b] != shift:
                return True
        return False

    def cut():
        """End the segment before the current instruction; the values in
        slots are all read at or after it, so each is carried."""
        nonlocal seg_start
        carries = [(slot_of[v], dims[v], new_buffer(("carry", v), dims[v], 0))
                   for v in sorted(slot_of)]
        for s, d, c in carries:
            ins.append(("copy", d, ("col", c, d, 0), [("slot", s, d)]))
        segments.append((seg_start, len(ins)))
        seg_start = len(ins)
        for s, d, c in carries:
            ins.append(("copy", d, ("slot", s), [("col", c, d, 0)]))

    for j, inst in enumerate(code):
        reads, wrote, dims_in, res_dim = per_ins[j]
        if needs_cut(inst):
            cut()
        srcs = [operand(r, v, d) for r, v, d in zip(inst["src"], reads, dims_in)]
        for v in set(x for x in reads if x is not None):
            if last_read[v] == j:
                heapq.heappush(free, slot_of.pop(v))
        dest = inst["dest"]
        t = dest["type"]
        if t == "tmp":
            s = take_slot()
            if last_read[wrote] > j:
                slot_of[wrote] = s
            else:  # never read: the slot is free again after this write
                heapq.heappush(free, s)
            out = ("slot", s)
        elif t in ("q", "f", "cm"):
            key = cm_key(dest) if t == "cm" else t
            d = {"q": dest.get("dim"), "f": 3, "cm": key[-1]}[t]
            if d not in (1, 3) or res_dim > d:
                raise ValueError(f"a dim-{res_dim} value cannot be stored to {t} of dim {d}")
            shift = _shift_amount(dest.get("prime"), dom, n, extend_bits)
            c = new_buffer(key, d, shift)
            current_buf[key] = c
            out = ("col", c, d, shift)
        else:
            raise ValueError(f"Invalid dest type {t}")
        ins.append((inst["op"], res_dim, out, srcs))
    segments.append((seg_start, len(ins)))

    groups, off = {}, 0
    for group, count, width in (("number", len(numbers), 1), ("public", used["public"], 1),
                                ("challenge", used["challenge"], 3),
                                ("eval", used["eval"], 3),
                                ("subproofValue", used["subproofValue"], 3)):
        groups[group] = (off, count, width)
        off += count * width
    ins = [(op, rd, dest, [_place_scalar(s, groups) for s in srcs])
           for op, rd, dest, srcs in ins]
    col_dims = [1] * len(columns)
    for _, _, dest, srcs in ins:
        for o in srcs + [dest]:
            if o[0] == "col":
                col_dims[o[1]] = max(col_dims[o[1]], o[2])
    return Program(n=n, ins=ins, segments=segments, n_slots=n_slots, columns=columns,
                   col_dims=col_dims, buffers=buffers, numbers=numbers,
                   scalar_groups=groups)


def _place_scalar(s, groups):
    if s[0] != "scalar":
        return s
    group, i = s[1]
    off, _, width = groups[group]
    return ("scalar", off + width * i, s[2])


# ---------------------------------------------------------------------------
# inputs shared by both versions


def _scalar_table(prog: Program, inputs, numbers: torch.Tensor) -> torch.Tensor:
    parts = [numbers]
    for group, key in (("public", "publics"), ("challenge", "challenges"), ("eval", "evals"),
                       ("subproofValue", "subproofValues")):
        _, count, width = prog.scalar_groups[group]
        if count == 0:
            continue
        t = inputs[key].reshape(-1)
        if t.numel() < count * width:
            raise ValueError(f"the program reads {count} {key}, the inputs hold "
                             f"{t.numel() // width}")
        parts.append(t[: count * width])
    return torch.cat(parts)


def _column_source(ref, inputs):
    """(tensor, first row of the column in it) for a column that is not a
    written buffer."""
    kind = ref[0]
    if kind == "section":
        return inputs["sections"][ref[1]], ref[2]
    if kind == "x":
        return inputs["x"].view(1, -1), 0
    if kind == "Zi":
        return inputs["Zi"], ref[1]
    if kind == "xdiv":
        xdiv = inputs["xDivXSubXi"]
        return xdiv.view(-1, xdiv.shape[-1]), 3 * ref[1]
    raise ValueError(f"Invalid column {ref}")


def _outputs(prog: Program, bufs, window=None) -> dict:
    out = {"cm": {}}
    for b, (key, _) in enumerate(prog.buffers):  # the last write of a key wins
        v = bufs[b]
        if window is not None and key[0] != "carry":
            v = v[:, window[0]:window[0] + window[1]].contiguous()
        if key in ("q", "f"):
            out[key] = v
        elif key[0] == "cm":
            out["cm"][key[1:]] = v
    return out


def signed_shift(shift: int, n: int) -> int:
    """A row shift (taken mod n) as the signed offset nearest 0."""
    return shift - n if shift > n // 2 else shift


def halo(prog: Program) -> tuple:
    """(rows before, rows after) that a window of the program's rows reads
    beyond itself: the largest backward and forward signed shift of its
    column reads.  A program that writes through a shift, or reads a
    written buffer through one, has no windowed run: it raises."""
    before = after = 0
    for _, _, dest, srcs in prog.ins:
        if dest[0] == "col" and dest[3]:
            raise ValueError("a windowed run writes through no row shift")
        for o in srcs:
            if o[0] != "col" or not o[3]:
                continue
            if prog.columns[o[1]][0] == "buf":
                raise ValueError("a windowed run reads no written buffer through a row shift")
            s = signed_shift(o[3], prog.n)
            before, after = max(before, -s), max(after, s)
    return before, after


def _rows(prog: Program, inputs, window) -> int:
    """The rows of the inputs' columns: prog.n for a whole run, base +
    rows + the halo after for a window."""
    n = inputs["x"].shape[-1]
    if window is None:
        if n != prog.n:
            raise ValueError(f"inputs of {n} rows for a program of {prog.n}")
        return n
    base, rows = window
    before, after = halo(prog)
    if base < before or base + rows + after > n:
        raise ValueError(f"window rows [{base}, {base + rows}) of {n} miss the halo "
                         f"({before} before, {after} after)")
    return n


# ---------------------------------------------------------------------------
# T1's plain version


def run_plain(prog: Program, inputs, window=None) -> dict:
    """The compiled program instruction by instruction over whole columns
    with torch_f3 ops; a slot holds a (d, N) tensor, or (d, 1) for a value
    of scalars only.  With a window, over every row of the inputs with the
    shifts signed, then cut to the window's rows."""
    device = inputs["x"].device
    n = _rows(prog, inputs, window)
    table = _scalar_table(prog, inputs, torch.tensor(prog.numbers, dtype=torch.int64,
                                                     device=device))
    bufs = [None] * len(prog.buffers)
    slots = [None] * prog.n_slots

    def get(o):
        if o[0] == "slot":
            return slots[o[1]]
        if o[0] == "scalar":
            return table[o[1]: o[1] + o[2]].reshape(o[2], 1)
        _, c, d, shift = o
        ref = prog.columns[c]
        if ref[0] == "buf":
            v = bufs[ref[1]]
        else:
            t, row = _column_source(ref, inputs)
            v = t[row: row + d]
        if window is not None:
            shift = signed_shift(shift, prog.n)
        return v if shift == 0 else torch.roll(v, -shift, dims=1)

    for op, _, dest, srcs in prog.ins:
        a = [get(s) for s in srcs]
        if op == "copy":
            res = a[0]
        elif op == "add":
            res = f3g.add(a[0], a[1])
        elif op == "sub":
            res = f3g.sub(a[0], a[1])
        elif op == "mul":
            res = f3g.mul(a[0], a[1])
        else:
            res = f3g.muladd(a[0], a[1], a[2])
        if dest[0] == "slot":
            slots[dest[1]] = res
            continue
        _, c, d, shift = dest
        if res.shape[0] != d:
            res = torch.cat([res, torch.zeros((d - res.shape[0],) + res.shape[1:],
                                              dtype=torch.int64, device=device)])
        v = res.expand(d, n).contiguous()
        bufs[prog.columns[c][1]] = torch.roll(v, shift, dims=1) if shift else v
    return _outputs(prog, bufs, window)


# ---------------------------------------------------------------------------
# T1


def _check_column(t: torch.Tensor, row: int, d: int, n: int, device, what: str):
    if t.device != device or t.dtype != torch.int64 or not t.is_contiguous():
        raise ValueError(f"T1 input {what}: want a contiguous int64 tensor on {device}, got "
                         f"{t.dtype} on {t.device} contiguous={t.is_contiguous()}")
    if t.dim() != 2 or t.shape[1] != n or t.shape[0] < row + d:
        raise ValueError(f"T1 input {what}: shape {tuple(t.shape)} has no rows "
                         f"[{row}, {row + d}) of {n} words")


def run_kernel(prog: Program, inputs, window=None) -> dict:
    """The compiled program on kernel T1, one launch per segment."""
    bufs, launch = prepare_kernel(prog, inputs, window)
    launch()
    return _outputs(prog, bufs, window)


def prepare_kernel(prog: Program, inputs, window=None):
    """(written buffers, a function that launches every segment): the
    column addresses, scalar table and output buffers T1 needs, made once
    so that the launches can be timed alone.  A window launches with a row
    base and the signed shifts."""
    gen, bufs, ptrs, table = kernel_args(prog, inputs, window)
    n = inputs["x"].shape[-1]
    if window is None:
        base, rows, shifts = 0, n, gen.shifts
    else:
        (base, rows), shifts = window, [signed_shift(s, prog.n) for s in gen.shifts]

    def launch():
        cuda_tac.tac_program(gen, ptrs, table, n, base, rows, shifts)

    return bufs, launch


def kernel_args(prog: Program, inputs, window=None):
    """(generated program, written buffers, column addresses, scalar
    table): what a run of T1 takes, on the inputs' device.  The addresses
    are those of every column the program names, in ``prog.columns``
    order, each checked against the rows the program reads; the table has
    room for the values the generated code derives from it."""
    device = inputs["x"].device
    n = _rows(prog, inputs, window)
    gen = tac_codegen.generate(prog)
    numbers = prog._kernel.get(str(device))
    if numbers is None:
        numbers = torch.tensor(prog.numbers, dtype=torch.int64, device=device)
        prog._kernel[str(device)] = numbers
    table = _scalar_table(prog, inputs, numbers)
    table = torch.cat([table, table.new_zeros(gen.n_scalars - table.numel())])
    bufs = [torch.empty((d, n), dtype=torch.int64, device=device) for _, d in prog.buffers]
    ptrs = []
    for ref, d in zip(prog.columns, prog.col_dims):
        if ref[0] == "buf":
            ptrs.append(bufs[ref[1]].data_ptr())
            continue
        t, row = _column_source(ref, inputs)
        _check_column(t, row, d, n, device, str(ref))
        ptrs.append(t.data_ptr() + row * n * 8)
    return gen, bufs, ptrs, table


def setup_programs(stark_info: dict, expressions_info: dict) -> dict:
    """{which: Program} of a setup's device programs that have code."""
    ss = stark_info["starkStruct"]
    progs = {}
    for which in PROGRAMS:
        code, dom = device_program(stark_info, expressions_info, which)
        if code["code"]:
            progs[which] = compile_program(code, dom, stark_info, ss["nBits"], ss["nBitsExt"])
    return progs


def build_programs(stark_info: dict, expressions_info: dict) -> dict:
    """Generate and build T1 for each of a setup's device programs, all
    nvcc runs in parallel, so that no prove waits on a compile.  Returns
    {which: library name}; a failed build raises with nvcc's output."""
    names = {which: cuda_build.add_generated(tac_codegen.generate(prog).source)
             for which, prog in setup_programs(stark_info, expressions_info).items()}
    cuda_build.build(names.values())
    return names


# ---------------------------------------------------------------------------
# the prover's inputs


def _small(values, shape, device):
    arr = np.asarray(values, dtype=np.uint64).reshape(shape)
    return gl.from_u64(arr, device)


def pack_inputs(ctx, dom: str, shard=None):
    """A ProverCtx's device buffers for make_executor.  Sections already on
    the device (ctx.dsections) pass as they are; a stage section that exists
    only on the host (the current stage's hint outputs) is uploaded
    transposed to the planar layout.  shard: one mesh rank's own rows on
    its device, {"sections", "x", "Zi", "xDivXSubXi"} (each with the halo
    its window reads), which take the place of the context's; the scalars
    are copied to that device."""
    if shard is not None:
        device = shard["x"].device
        sections = shard["sections"]
    else:
        device = ctx.device
        sections = dict(ctx.dsections[dom])
        for i in range(ctx.pil_info["nStages"] + (1 if dom == "ext" else 0)):
            name = f"cm{i + 1}"
            if name in sections:
                continue
            buf = ctx.buffers.get(f"{name}_{dom}")
            if buf is not None:
                sections[name] = gl.from_u64(np.ascontiguousarray(buf.T), device)
    publics = [int(p or 0) % gl64.P_INT for p in ctx.publics]
    challenges = [list(c) for stage in ctx.challenges for c in stage] or [[0, 0, 0]]
    evals = [list(e) for e in ctx.evals] or [[0, 0, 0]]
    subproof_values = [list(f3.as3(v)) for v in ctx.subproof_values] or [[0, 0, 0]]
    inputs = {
        "sections": sections,
        "x": ctx.dx[dom] if shard is None else shard["x"],
        "publics": _small(publics or [0], (-1,), device),
        "challenges": _small(challenges, (-1, 3), device),
        "evals": _small(evals, (-1, 3), device),
        "subproofValues": _small(subproof_values, (-1, 3), device),
    }
    if shard is not None:
        inputs["Zi"], inputs["xDivXSubXi"] = shard["Zi"], shard["xDivXSubXi"]
    elif dom == "ext":
        inputs["Zi"] = ctx.dZi
        inputs["xDivXSubXi"] = ctx.dxdiv
    return inputs
