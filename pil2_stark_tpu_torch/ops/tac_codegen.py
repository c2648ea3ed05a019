"""Kernel T1's generator: a compiled TAC program (ops/torch_tac.Program) as
CUDA C++, one ``__global__`` per segment, built by utils/cuda_build at
first use (or by ``torch_tac.build_programs`` when a setup is loaded).

T1 is the counterpart of the XLA computation the JAX package traces for
each program and jits once per program (pil2_stark_tpu/ops/jax_tac.py:53
``make_executor``, its ``_EXECUTOR_CACHE``), not of a ``pallas_call``.

What goes into the source is what the compiled program fixes: the op
sequence, each value's dim and each operand's kind.  Every value is a
``const`` local of its own (``uint64_t`` or ``f3::F3``, csrc/f3.cuh), so no
kind or dim branch is left and the values stay in registers; a column
operand is a load from ``p.col[c]`` at row (i + shift) mod n, each (column,
shift, component) loaded once per row; a read of a buffer the segment wrote
itself (always through the write's shift) takes the stored value from its
register.  What a run sets is passed at launch: n, the row shifts
(``p.sh``), the column addresses (``p.col``) in a parameter struct, and the
scalar table in ``__constant__`` memory.  So two setups whose programs differ
only in n and shifts (all_8 and all_20) share one build.

A launch computes rows [base, base + rows) of columns of n rows (``p.base``,
``p.rows``; a whole run is base 0, rows n).  A mesh's shard runs with a
row base: its columns are the shard's rows with a halo of the rows its
shifts reach on either side (n = halo + shard + halo), the shifts are
passed signed (a backward opening negative), and the launch computes the
shard's rows alone, so no read wraps (ops/torch_tac.py ``halo``).

Bound on the H100: bytes for the committed programs (each input column read
once, each output written once; at most a few GL products per word moved),
though the all-gadgets Q and FRI programs issue more instructions per row
than the card issues in that time (PERF.md §6).  One thread per row,
grid-stride, 64-bit offsets, the shift wrapped with one compare; blocks of
256 threads with a launch bound that caps the registers (``min_blocks``).
The field ops are csrc/f3.cuh's, canonical, their carries and borrows taken
from PTX carry chains.

The row bodies compile on the host as well (tests/tac_host_shim.h maps the
CUDA qualifiers to plain C++), which is how the CPU tests run them.
"""
from __future__ import annotations

import dataclasses
import re

from ..utils import cuda_build

THREADS = 256
MAX_PARAM_BYTES = 4096  # the kernel parameter space every CUDA 12 toolkit takes
MAX_SCALARS = 8192  # 64 KiB of __constant__ memory


@dataclasses.dataclass(frozen=True)
class Generated:
    """The generated source of one program and what its launch needs:
    the value of each shift parameter, the counts of columns and scalars,
    and the number of kernels (segments)."""

    source: str
    shifts: tuple
    n_cols: int
    n_base_scalars: int  # the scalar table the caller fills
    n_scalars: int  # the table's size, with the row-invariant values derive() appends
    n_segments: int

    @property
    def digest(self) -> str:
        return cuda_build.generated_digest(self.source)


def generate(prog) -> Generated:
    """CUDA C++ for `prog`; cached on the program."""
    hit = prog._kernel.get("generated")
    if hit is None:
        hit = _generate(prog)
        prog._kernel["generated"] = hit
    return hit


def min_blocks(live_values: int) -> int:
    """The blocks of 256 threads per SM that T1's launch bound asks for:
    3 (80 registers a thread) for a program of up to 16 live values, else
    1.  Without a bound ptxas gave the all-gadgets Q and FRI programs well
    over 128 registers a thread, one block per SM; of 2 to 5 blocks, 3 was
    the fastest or close to it for those two, and the fibonacci programs
    hardly moved (PERF.md §6)."""
    return 3 if live_values <= 16 else 1


def _shift_table(prog):
    """Each distinct nonzero row shift, in order of first use."""
    shifts = []
    for _, _, dest, srcs in prog.ins:
        for o in list(srcs) + [dest]:
            if o[0] == "col" and o[3] and o[3] not in shifts:
                shifts.append(o[3])
    return shifts


def _generate(prog) -> Generated:
    shifts = _shift_table(prog)
    n_cols = len(prog.columns)
    n_base = sum(count * width for _, count, width in prog.scalar_groups.values())
    param_bytes = 8 * (3 + max(len(shifts), 1) + n_cols)
    if param_bytes > MAX_PARAM_BYTES:
        raise ValueError(f"T1: {n_cols} columns and {len(shifts)} shifts need {param_bytes} B "
                         f"of kernel parameters, more than {MAX_PARAM_BYTES}")
    ins, derive, n_scalars = _fold_scalars(prog, n_base)
    if n_scalars > MAX_SCALARS:
        raise ValueError(f"T1: {n_scalars} scalars, __constant__ memory holds {MAX_SCALARS}")
    rows = [_row_function(prog, ins, k, start, end, shifts)
            for k, (start, end) in enumerate(prog.segments)]
    n_seg = len(prog.segments)
    text = _TEMPLATE.format(
        n_ins=len(prog.ins), n_seg=n_seg, n_cols=n_cols, n_shifts=len(shifts),
        n_base=n_base, n_scalars=n_scalars, sh_len=max(len(shifts), 1),
        c_len=max(n_cols, 1), s_len=max(n_scalars, 1), threads=THREADS,
        min_blocks=min_blocks(prog.n_slots),
        derive="\n".join(derive), rows="\n".join(rows),
        segments=" ".join(f"X({k})" for k in range(n_seg)))
    return Generated(source=text, shifts=tuple(shifts), n_cols=n_cols, n_base_scalars=n_base,
                     n_scalars=n_scalars, n_segments=n_seg)


def _fold_scalars(prog, n_base):
    """(the instructions the rows run, the lines of ``derive``, the size
    of the scalar table).  An instruction whose sources are all scalars
    (table entries, or values folded before it) is the same in every row:
    ``derive`` computes it once per run into a new table entry, and the rows
    read that entry (None marks a folded instruction that wrote a slot; one
    that wrote a column becomes a copy of the entry).  Each extension
    scalar that an extension product reads gets the pair sums of its
    components (Karatsuba's) in the table too.  Without this the compiler
    hoists those row-invariant values out of the grid-stride loop into
    registers.  Equal folded instructions share one entry."""
    size = n_base
    derive, ins, folded, seen = [], [], {}, {}

    def expr(o):
        off, d = o[1], o[2]
        if d == 1:
            return f"t[{off}]"
        return f"f3::make(t[{off}], t[{off + 1}], t[{off + 2}])"

    for op, rd, dest, srcs in prog.ins:
        srcs = [folded.get(o[1], o) if o[0] == "slot" else o for o in srcs]
        if all(o[0] == "scalar" for o in srcs):
            key = (op, tuple(srcs))
            if op == "copy":
                value = srcs[0]
            elif key in seen:
                value = seen[key]
            else:
                value = seen[key] = ("scalar", size, rd)
                args = ", ".join(expr(o) for o in srcs)
                comps = ["v"] if rd == 1 else ["v.c0", "v.c1", "v.c2"]
                stores = " ".join(f"t[{size + j}] = {c};" for j, c in enumerate(comps))
                derive.append(f"  {{ const {'uint64_t' if rd == 1 else 'f3::F3'} v = "
                              f"f3::{op}({args}); {stores} }}")
                size += rd
            if dest[0] == "slot":
                folded[dest[1]] = value
                ins.append(None)
            else:
                ins.append(("copy", rd, dest, [value]))
            continue
        if dest[0] == "slot":
            folded.pop(dest[1], None)
        ins.append((op, rd, dest, srcs))
    sums = {}
    for k, inst in enumerate(ins):
        if inst is None or inst[0] not in ("mul", "muladd"):
            continue
        op, rd, dest, srcs = inst
        if srcs[0][2] != 3 or srcs[1][2] != 3:
            continue
        for j in (0, 1):
            if srcs[j][0] != "scalar":
                continue
            off = srcs[j][1]
            if off not in sums:
                sums[off] = size
                derive.append(f"  t[{size}] = f3::add(t[{off}], t[{off + 1}]); "
                              f"t[{size + 1}] = f3::add(t[{off}], t[{off + 2}]); "
                              f"t[{size + 2}] = f3::add(t[{off + 1}], t[{off + 2}]);")
                size += 3
            srcs = list(srcs)
            srcs[j] = ("scalar_sums", off, 3, sums[off])
        ins[k] = (op, rd, dest, srcs)
    return ins, derive, size


def _row_function(prog, ins, seg, start, end, shifts) -> str:
    """Straight-line code for one row of segment `seg`."""
    lines = []
    rows_made = set()
    loaded = set()
    slot = {}  # slot -> name of the value it holds
    written = {}  # buffer column -> (its row shift, components of the stored value)
    buf_cols = {c for c, ref in enumerate(prog.columns) if ref[0] == "buf"}

    def row_of(shift):
        if not shift:
            return "i"
        k = shifts.index(shift)
        if k not in rows_made:
            rows_made.add(k)
            lines.append(f"  long long r{k} = i + p.sh[{k}];")
            lines.append(f"  if (r{k} >= n) r{k} -= n;")
        return f"r{k}"

    def value(comps):
        return comps[0] if len(comps) == 1 else f"f3::make({', '.join(comps)})"

    def operand(o):
        if o[0] == "slot":
            return slot[o[1]]
        if o[0] == "scalar":
            return value([f"kS[{o[1] + j}]" for j in range(o[2])])
        if o[0] == "scalar_sums":
            comps = [f"kS[{o[1] + j}]" for j in range(3)] + [f"kS[{o[3] + j}]" for j in range(3)]
            return f"f3::F3S{{{', '.join(comps)}}}"
        _, c, d, shift = o
        if c in written:
            if written[c][0] != shift:  # compile_program cuts the program there
                raise ValueError(f"T1: column {c} read through shift {shift} in the segment "
                                 f"that wrote it through {written[c][0]}")
            return value(written[c][1][:d])
        row = row_of(shift)
        names = []
        for j in range(d):
            name = f"c{c}_{row}_{j}"
            if name not in loaded:
                loaded.add(name)
                off = row if j == 0 else f"{row} + {j} * n"
                lines.append(f"  const uint64_t {name} = ld(p.col[{c}] + {off});")
            names.append(name)
        return value(names)

    for k in range(start, end):
        if ins[k] is None:
            continue
        op, rd, dest, srcs = ins[k]
        args = [operand(s) for s in srcs]
        expr = args[0] if op == "copy" else f"f3::{op}({', '.join(args)})"
        name = f"v{k}"
        lines.append(f"  const {'uint64_t' if rd == 1 else 'f3::F3'} {name} = {expr};")
        if dest[0] == "slot":
            slot[dest[1]] = name
            continue
        _, c, d, shift = dest
        if c not in buf_cols:
            raise ValueError(f"T1: instruction {k} writes column {prog.columns[c]}")
        comps = [name] if rd == 1 else [f"{name}.c{j}" for j in range(3)]
        comps = (comps + ["0ull", "0ull"])[:d]
        written[c] = (shift, comps)
        row = row_of(shift)
        for j, comp in enumerate(comps):
            off = row if j == 0 else f"{row} + {j} * n"
            lines.append(f"  p.col[{c}][{off}] = {comp};")
    lines = _drop_unread(lines)
    return (f"__device__ __forceinline__ void row_seg{seg}(const Params& p, const long long i) {{\n"
            f"  const long long n = p.n;\n" + "\n".join(lines) + "\n}\n")


_DEF = re.compile(r"^  const \S+ (\w+) = ")
_WORD = re.compile(r"\w+")


def _drop_unread(lines):
    """Drop the definitions (loads and values, all pure) that no kept line
    reads: values the program writes to a slot and never reads, and what
    only they read."""
    while True:
        used = set()
        for ln in lines:
            m = _DEF.match(ln)
            used.update(_WORD.findall(ln[m.end():] if m else ln))
        kept = [ln for ln in lines if not (m := _DEF.match(ln)) or m.group(1) in used]
        if len(kept) == len(lines):
            return lines
        lines = kept


_TEMPLATE = """\
// Kernel T1 for one compiled TAC program, generated by
// pil2_stark_tpu_torch/ops/tac_codegen.py: {n_ins} instructions in {n_seg}
// segment(s), {n_cols} columns, {n_shifts} row shifts, {n_base} scalars from
// the inputs and {n_scalars} in all.
#include <cstdint>

#include "f3.cuh"

#define TAC_SEGMENTS(X) {segments}

namespace {{

constexpr int kNumCols = {n_cols};
constexpr int kNumShifts = {n_shifts};
constexpr int kNumBase = {n_base};  // the scalar table the caller fills
constexpr int kNumScalars = {n_scalars};  // with what derive() appends
constexpr int kThreads = {threads};
constexpr int kMinBlocks = {min_blocks};  // blocks per SM the launch bound asks for

struct Params {{
  long long n;     // rows of every column: the stride of its components, the wrap
  long long base;  // the first row the launch computes
  long long rows;  // the rows it computes
  long long sh[{sh_len}];
  uint64_t* col[{c_len}];
}};

__constant__ uint64_t kS[{s_len}];

__device__ __forceinline__ uint64_t ld(const uint64_t* a) {{
  return (uint64_t)__ldg(reinterpret_cast<const unsigned long long*>(a));
}}

// The row-invariant values, computed once per run into the scalar table
// after its first kNumBase entries.
__device__ __forceinline__ void derive(uint64_t* t) {{
{derive}
}}

void fill(Params& p, const long long* cols, const long long* shifts, long long n) {{
  p.n = n;
  p.base = 0;
  p.rows = n;
  p.sh[0] = 0;
  for (int k = 0; k < kNumShifts; ++k) p.sh[k] = shifts[k];
  for (int c = 0; c < kNumCols; ++c) p.col[c] = reinterpret_cast<uint64_t*>(cols[c]);
}}

{rows}
}}  // namespace

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace {{

#define TAC_KERNEL(k)                                                                 \\
  __global__ void __launch_bounds__(kThreads, kMinBlocks) tac_seg##k(const Params p) {{ \\
    const long long step = (long long)gridDim.x * blockDim.x;                         \\
    const long long end = p.base + p.rows;                                            \\
    for (long long i = p.base + (long long)blockIdx.x * blockDim.x + threadIdx.x;       \\
         i < end; i += step)                                                          \\
      row_seg##k(p, i);                                                               \\
  }}
TAC_SEGMENTS(TAC_KERNEL)

__global__ void tac_derive(uint64_t* t) {{ derive(t); }}

// SMs of the current card, read once per card
int sm_count() {{
  constexpr int kMaxCards = 64;
  static int counts[kMaxCards] = {{}};
  int dev = 0, count = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < kMaxCards && counts[dev] > 0) return counts[dev];
  cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  if (dev >= 0 && dev < kMaxCards) counts[dev] = count;
  return count;
}}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const Params& p, cudaStream_t stream) {{
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  long long blocks = (p.rows + kThreads - 1) / kThreads;
  const long long resident = (long long)per_sm * sm_count();
  if (blocks > resident) blocks = resident;
  kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}}

}}  // namespace

// The counts the caller must match: columns, shifts, scalars (those it
// fills, and the table's size), segments.
extern "C" int tac_layout(long long* out) {{
  out[0] = kNumCols;
  out[1] = kNumShifts;
  out[2] = kNumBase;
  out[3] = kNumScalars;
#define TAC_COUNT(k) +1
  out[4] = 0 TAC_SEGMENTS(TAC_COUNT);
  return 0;
}}

// Every segment in order on `stream`, over rows [base, base + rows) of
// columns of n rows: cols holds the device address of each column (written
// buffers included), shifts each row shift, scalars the device address of
// the scalar table (kNumScalars words, the first kNumBase filled; derive()
// fills the rest in place).  The table goes to __constant__ memory on the
// same stream first, so runs of one library are ordered by their stream.
extern "C" int tac_run(const long long* cols, const long long* shifts, void* scalars,
                       long long n, long long base, long long rows, void* stream) {{
  if (n <= 0 || n >= (1LL << 40) || base < 0 || rows <= 0 || base + rows > n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  Params p;
  fill(p, cols, shifts, n);
  p.base = base;
  p.rows = rows;
  cudaError_t e = cudaSuccess;
  if (kNumScalars > kNumBase) {{
    tac_derive<<<1, 1, 0, s>>>(reinterpret_cast<uint64_t*>(scalars));
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }}
  if (kNumScalars > 0) {{
    e = cudaMemcpyToSymbolAsync(kS, scalars, sizeof(uint64_t) * kNumScalars, 0,
                                cudaMemcpyDeviceToDevice, s);
    if (e != cudaSuccess) return (int)e;
  }}
#define TAC_LAUNCH(k)                     \\
  e = launch(tac_seg##k, p, s);           \\
  if (e != cudaSuccess) return (int)e;
  TAC_SEGMENTS(TAC_LAUNCH)
  return 0;
}}
#endif
"""
