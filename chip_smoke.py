#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (pil2_stark_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. build       — compile every CUDA source of the port and the T1 kernel
                   generated for each TAC program of both proves (one nvcc
                   per source, all in parallel); registers and spills from
                   ptxas (B1's 64-point passes and T2 at two openings in
                   their own entry), and SASS instructions per permutation by
                   class (cuobjdump) of B4 and of the schedule before it,
                   which X1 still runs;
  2. kernels     — run each kernel at the shapes each prove path gives it
                   (B2 level_planar and B3 base_grid at the widest planar
                   transforms, B4 Poseidon at the leaf batch of each tree,
                   B1 base_rows at the FRI fold and the two bases of each
                   2^25 transform of the prove, T1 tac_program on each TAC
                   program of both proves at its size, with its ptxas
                   counts, nvcc seconds and SASS per row, T2 gl_xdiv with
                   2 openings at 2^22 and 2^25) on random values plus
                   near-p corners, and
                   require output equal bit for bit to its plain PyTorch
                   version; time both;
  3. tools       — the Poseidon experiment tools: kernel X2 (every variant
                   of tools/exp_poseidon, at its own 2^16 states with
                   blocks 512 and 2048) and X1 (tools/exp_stream, at 2^14
                   and 2^20 states) equal bit for bit to their plain
                   versions; every variant that computes Poseidon, and X1,
                   equal to B4 at the prove's leaf batches of 2^22 and
                   2^25 states and timed beside it; then the two tools'
                   entry points on the card, with X1/X2 launches counted;
  4. small       — prove the all-gadgets machine at 2^8 on the card and on
                   the CPU, and require the two proofs to be identical;
  5. large_ntt   — a 2^25-point transform of 3 columns (the row route on
                   B1): intt(ntt(x)) == x, ntt equal to the same route with
                   the plain B1, and 4 outputs equal to a host evaluation of
                   the polynomials; its time and peak memory;
  6. prove       — prove the all-gadgets machine at 2^20 rows (nBitsExt 22,
                   32 queries) on the card through prove(); verify the proof;
                   report cold and warm wall time, the phase breakdown and
                   peak memory;
  7. prove_large — the same for fibonacci at 2^22 rows, nBitsExt 25 (the
                   row route, setups/fibonacci_22.json).
In each prove phase the kernels' launch counters are zeroed just before the
cold prove and read just after it, and every kernel must have launched (T1
three times, once per program, and T2 once); B1's kernel launches are also
reported by shape (two per base of more than 64 rows).
Then the card's name and power limit, the kernels line, and as the last line
{"ok": true, "device": {...}}.  Any failure exits non-zero.  Needs one CUDA
card; imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
import time

P = 0xFFFFFFFF00000001
N_BITS = 20  # the all-gadgets machine at 2^20 rows, blowup 4 (setups/all_20.json)
N_COLS = 15  # the widest committed section of that machine (stage 1)
LARGE_SETUP = "fibonacci_22"  # fibonacci at 2^22 rows, blowup 8
LARGE_N_BITS = 22
LARGE_BITS = 25  # its extended domain: past the planar ceiling, the row route
LARGE_COLS = 3  # the widest transform of that prove (Q, and the evals' iNTT)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# Hopper has 64 INT32 lanes per SM against 128 FP32 lanes: its 32-bit
# integer multiply-add rate is half the FP32 FMA rate (67e12 FLOP/s / 2
# FLOP per FMA / 2).  A GL multiply (64x64->128 product + reduction) is
# counted as 4 such multiply-adds, the four 32x32->64 partial products of
# its 128-bit product: the least it needs (its reduction needs none).
IMAD_PER_S = 67e12 / 4
IMAD_PER_GL_MUL = 4
# Poseidon: 1,122 GL multiplies per permutation plus 7 products by the
# small MDS matrix, each 144 entries × 2 halves multiply-adds.
POSEIDON_IMAD = 1122 * IMAD_PER_GL_MUL + 7 * 144 * 2
# T2's operations bound counts the GL products x/(x − xi) needs (csrc/tac.cu's
# xdiv_kernel spends more: sums of products reduced once count as less,
# the block-wide scans and the serial inverse as more).  With
# x/(x − xi) = 1 + xi·adj(x − xi)/N(x − xi), the norm N is a monic cubic in
# x and the three components of xi·adj are quadratics in x, all with
# coefficients the host computes once per opening: x² once per point, then
# per opening 2 products for N (Horner), 6 for the quadratics, 3 for N's
# inverse taken in a batch across points (Montgomery's trick), and 3 to
# scale by it.
XDIV_GL_MULS_PER_POINT = 1
XDIV_GL_MULS_PER_OPENING = 2 + 6 + 3 + 3
TAC_SRC = "pil2_stark_tpu_torch/csrc/tac.cu"
T1_SRC = "pil2_stark_tpu_torch/ops/tac_codegen.py"  # generates T1 per program, on csrc/f3.cuh
PROVE_LAUNCHES = {"tac_program": 3, "gl_xdiv": 1}  # T1 once per program, T2 once
XLA_FUSION = "counterpart of an XLA fusion, not a pallas_call"
# the Poseidon experiment tools (tools/exp_poseidon.py, tools/exp_stream.py)
X2_VARIANTS = ("packed", "packed-nosq", "packed-lazy", "packed-dual", "packed-lazy-dual",
               "packed-p4x", "packed-psl", "nomxu", "packed-nops", "packed-nofs")
TOOL_BATCH = 1 << 16  # run_variant's and run_sustained's batch
TOOL_BLOCKS = (512, 2048)  # run_variant's and run_sustained's block
X1_BITS = (14, 20)  # exp_stream.main's check size and its largest timed size
X2_SRC = "pil2_stark_tpu_torch/csrc/poseidon_variants.cu"
X1_SRC = "pil2_stark_tpu_torch/csrc/poseidon_stream.cu"
CORNERS = [0, 1, 2, P - 1, P - 2, (1 << 32) - 1, 1 << 32, (1 << 32) + 1,
           (1 << 63) - 1, 1 << 63, P - (1 << 32), P - (1 << 32) - 1]


def emit(obj):
    print(json.dumps(obj), flush=True)


def canon(o):
    import numpy as np

    if isinstance(o, np.ndarray):
        return [canon(x) for x in o.tolist()]
    if isinstance(o, (list, tuple)):
        return [canon(x) for x in o]
    if isinstance(o, dict):
        return {k: canon(v) for k, v in o.items()}
    if isinstance(o, (int, np.integer)):
        return int(o)
    return o


def random_field(shape, seed, device):
    """Canonical random values with the near-p corners at the front."""
    import numpy as np

    from pil2_stark_tpu_torch.field import torch_gl as gl

    rng = np.random.default_rng(seed)
    a = rng.integers(0, P, size=shape, dtype=np.uint64)
    flat = a.reshape(-1)
    k = min(len(CORNERS), flat.size)
    flat[:k] = np.array(CORNERS[:k], dtype=np.uint64) % np.uint64(P)
    return gl.from_u64(a, device)


def cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b) -> float:
    import numpy as np

    from pil2_stark_tpu_torch.field import torch_gl as gl

    x, y = gl.to_u64(a).reshape(-1), gl.to_u64(b).reshape(-1)
    bad = np.nonzero(x != y)[0]
    if bad.size == 0:
        return 0.0
    return float(max(abs(int(x[i]) - int(y[i])) for i in bad[:100000]))


def ptxas_summary(log: str) -> list:
    """[kernel, registers, spill store bytes, spill load bytes, stack frame
    bytes] for each entry function in nvcc's -Xptxas -v output."""
    out, name, spill, stack = [], None, [0, 0], 0
    for ln in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", ln):
            name, spill, stack = m.group(1), [0, 0], 0
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln):
            spill = [int(m.group(1)), int(m.group(2))]
            if s := re.search(r"(\d+) bytes stack frame", ln):
                stack = int(s.group(1))
        elif (m := re.search(r"Used (\d+) registers", ln)) and name:
            t = re.search(r"variant_kernelILb(\d)ELb(\d)ELi(\d)ELi(\d)E", name)
            u = re.search(r"tac_seg(\d+)", name)
            x = re.search(r"xdiv_kernelILi(\d+)E", name)
            b = re.search(r"base_rows_pass_kernelILi(\d)ELb(\d)ELb(\d)ELb(\d)E", name)
            label = (f"variant_kernel<sq={t[1]},lazy={t[2]},probe={t[3]},ns={t[4]}>" if t
                     else f"tac_seg{u[1]}" if u
                     else f"xdiv_kernel<{x[1]}>" if x
                     else f"base_rows_pass<{b[1]},inv={b[2]},tw={b[3]},canon={b[4]}>" if b
                     else name)
            out.append([label, int(m.group(1)), *spill, stack])
            name = None
    return out


def cuobjdump():
    """The CUDA toolkit's cuobjdump, or Triton's bundled copy; None if
    neither is on this machine."""
    import importlib.util
    import os
    import shutil

    found = shutil.which("cuobjdump")
    if found:
        return found
    places = ["/usr/local/cuda/bin/cuobjdump"]
    spec = importlib.util.find_spec("triton")
    if spec and spec.submodule_search_locations:
        places += [os.path.join(d, "backends", "nvidia", "bin", "cuobjdump")
                   for d in spec.submodule_search_locations]
    return next((p for p in places if os.path.exists(p)), None)


SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


SASS_CLASSES = {"IMAD": "IMAD", "IADD3": "IADD3", "ISETP": "ISETP+SEL", "SEL": "ISETP+SEL",
                "MOV": "move", "LDC": "const load", "ULDC": "const load",
                "LDL": "spill", "STL": "spill", "LDG": "global load", "STG": "global store"}


def sass_class(op: str) -> str:
    if op.startswith("IMAD.MOV"):
        return "move"
    return SASS_CLASSES.get(op.split(".")[0], "other")


def sass_counts(lib_name: str, kernel: str, trips: list, outer: bool = False) -> dict:
    """SASS instructions of `kernel` in a built library (a name of
    cuda_build.library_path), by class, and per permutation: each
    instruction inside a loop (a backward branch) counts
    once per trip of every round loop around it, the round loops (the
    len(trips) largest, in order of their first address) taking `trips`
    and any other loop one.  One thread of B4 makes one permutation, so
    its count per thread is the count per permutation.  With `outer`, only
    the instructions of one trip of the loop around all others count: X1's
    stage loop, in which each thread permutes one state, or T1's
    grid-stride loop, one trip per row (no `trips`)."""
    from pil2_stark_tpu_torch.utils import cuda_build

    tool = cuobjdump()
    if tool is None:
        return {"measured": False, "why": "no cuobjdump on this machine"}
    out = subprocess.run([tool, "-sass", str(cuda_build.library_path(lib_name))],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        return {"measured": False, "why": out.stderr.strip()[-300:]}
    insns, inside = [], False
    for ln in out.stdout.splitlines():
        if "Function :" in ln:
            inside = kernel in ln
        elif inside and (m := SASS_LINE.search(ln)):
            insns.append((int(m[1], 16), m[2], m[3]))
    if not insns:
        return {"measured": False, "why": f"no function {kernel} in the SASS"}
    loops = []
    for addr, op, args in insns:
        t = re.search(r"0x([0-9a-f]+)", args)
        if op.startswith("BRA") and t and int(t[1], 16) < addr:
            loops.append((int(t[1], 16), addr))
    loops.sort()
    res = {"measured": True, "static": len(insns)}
    if outer and loops:
        a0, b0 = max(loops, key=lambda lp: lp[1] - lp[0])
        insns = [i for i in insns if a0 <= i[0] <= b0]
        loops = [lp for lp in loops if lp != (a0, b0) and a0 <= lp[0] and lp[1] <= b0]
        res["outer_loop"] = [a0, b0, len(insns)]
    size = {lp: sum(1 for x, *_ in insns if lp[0] <= x <= lp[1]) for lp in loops}
    res["loops"] = [[a, b, size[(a, b)]] for a, b in loops]
    if len(loops) < len(trips):
        res["per_permutation"] = None
        res["why"] = f"{len(loops)} loops, expected {len(trips)}"
        return res
    rounds = sorted(sorted(loops, key=size.get)[len(loops) - len(trips):])
    per_class: dict = {}
    for addr, op, _ in insns:
        w = 1
        for (a, b), n in zip(rounds, trips):
            if a <= addr <= b:
                w *= n
        c = sass_class(op)
        per_class[c] = per_class.get(c, 0) + w
    res["per_permutation"] = sum(per_class.values())
    res["per_permutation_by_class"] = per_class
    return res


# the permutation loops over the first full rounds, the partial rounds
# and the last full rounds
ROUND_TRIPS = [3, 22, 3]


def exact_err(a, b) -> float:
    """max_abs_err, with the equal case decided on the card."""
    import torch

    return 0.0 if torch.equal(a, b) else max_abs_err(a, b)


def tac_programs():
    """{(setup, program): (Program, library name)} of every TAC program the
    two proves run, compiled at the setup's size."""
    from pil2_stark_tpu_torch.ops import tac_codegen, torch_tac
    from pil2_stark_tpu_torch.stark import setup as stark_setup
    from pil2_stark_tpu_torch.utils import cuda_build

    out = {}
    for name in (f"all_{N_BITS}", LARGE_SETUP):
        data = stark_setup.read_setup(name)
        for which, prog in torch_tac.setup_programs(data["starkInfo"],
                                                    data["expressionsInfo"]).items():
            out[(name, which)] = (prog, cuda_build.add_generated(
                tac_codegen.generate(prog).source))
    return out


def phase_build():
    from pil2_stark_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    tac = tac_programs()
    times = cuda_build.build(list(cuda_build.SOURCES) + [lib for _, lib in tac.values()])
    ptxas = {name: ptxas_summary(cuda_build.build_log(name)) for name in cuda_build.SOURCES}
    ptxas.update({f"T1 {s}.{w}": ptxas_summary(cuda_build.build_log(lib))
                  for (s, w), (_, lib) in tac.items()})
    # B4, and the schedule before poseidon_fast.cuh as X1 runs it: one trip
    # of X1's stage loop is one permutation per thread
    sass = {"poseidon": sass_counts("poseidon", "poseidon_kernel", ROUND_TRIPS),
            "poseidon_stream": sass_counts("poseidon_stream", "stream_kernel", ROUND_TRIPS,
                                           outer=True)}
    # B1's radix passes at 4096 rows and T2 at the proves' two openings
    b1_t2 = {e[0]: e[1:] for name in ("ntt", "tac") for e in ptxas[name]
             if e[0].startswith("base_rows_pass<6") or e[0] == "xdiv_kernel<2>"}
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "per_source": times,
          "ptxas": ptxas, "b1_t2_ptxas": b1_t2, "b4_sass": sass})


def phase_kernels(device):
    """Each kernel against its plain version at the shapes of each prove
    path it launches on."""
    import torch

    all_path = f"all_{N_BITS}"
    rows = []
    # all-gadgets: B2/B3 at its widest LDE (15 columns), the base-domain
    # iNTT and the extended-domain NTT; B4 at the leaf batch of its trees
    rows += _ntt_rows(device, N_BITS, N_COLS, True, all_path)
    rows += _ntt_rows(device, N_BITS + 2, N_COLS, False, all_path)
    rows.append(_poseidon_row(device, 1 << (N_BITS + 2), all_path))
    # fibonacci 2^25: B2/B3 at its widest base-domain iNTT (the evals' 3
    # columns; its extended-domain transforms take the row route), B4 at
    # 2^25 leaves, B1 at the folds and the row route's bases
    rows += _ntt_rows(device, LARGE_N_BITS, LARGE_COLS, True, LARGE_SETUP)
    rows.append(_poseidon_row(device, 1 << LARGE_BITS, LARGE_SETUP))
    rows += _b1_rows(device)
    # T1 on every TAC program each prove runs, T2 at each prove's extended
    # domain
    rows += _tac_rows(device, all_path, ("imPols", "q", "fri"))
    rows += _tac_rows(device, LARGE_SETUP, ("imPols", "q", "fri"))
    rows.append(_xdiv_row(device, N_BITS + 2, all_path))
    rows.append(_xdiv_row(device, LARGE_BITS, LARGE_SETUP))
    for r in rows:
        emit({"phase": "kernels", **r})
    bad = [(r["name"], r["path"], r["shape"]) for r in rows if r["max_abs_err"] != 0]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")
    torch.cuda.empty_cache()
    return rows


def _ntt_rows(device, bits, n_cols, inverse, path):
    """B2 (level_planar) and B3 (base_grid) at one planar transform of
    n_cols × 2^bits points, as ops/ntt.py::planar_ntt splits it."""
    import torch

    from pil2_stark_tpu_torch.ops import cuda_ntt, ntt

    n = 1 << bits
    bits1 = ntt.split_bits(bits)
    bits2 = bits - bits1
    n1, n2 = 1 << bits1, 1 << bits2
    x = random_field((n_cols, n), 100 + bits + n_cols, device)
    lt = ntt.level_twiddles(bits, bits1, inverse, device)
    y_k = cuda_ntt.level_planar(x, bits1, n2, n_cols, lt, inverse)
    err2 = max_abs_err(y_k, cuda_ntt.level_planar_plain(x, bits1, n2, n_cols, lt, inverse))
    err3 = max_abs_err(cuda_ntt.base_grid(y_k, bits2, n_cols, inverse),
                       cuda_ntt.base_grid_plain(y_k, bits2, n_cols, inverse))
    muls2 = n_cols * n * (bits1 / 2 + 1)
    bytes2 = 2 * n_cols * n * 8 + n1 * n2 * 8
    muls3 = n_cols * n * bits2 / 2
    bytes3 = 2 * n_cols * n * 8
    shape = {"n_cols": n_cols, "n": n, "n1": n1, "n2": n2, "inverse": inverse}
    rows = [
        _kernel_row("level_planar", "pil2_stark_tpu_torch/csrc/ntt.cu",
                    "pil2_stark_tpu/ops/pallas_ntt.py:439", err2,
                    lambda: cuda_ntt.level_planar(x, bits1, n2, n_cols, lt, inverse),
                    lambda: cuda_ntt.level_planar_plain(x, bits1, n2, n_cols, lt, inverse),
                    muls2 * IMAD_PER_GL_MUL, bytes2, shape, path),
        _kernel_row("base_grid", "pil2_stark_tpu_torch/csrc/ntt.cu",
                    "pil2_stark_tpu/ops/pallas_ntt.py:497", err3,
                    lambda: cuda_ntt.base_grid(y_k, bits2, n_cols, inverse),
                    lambda: cuda_ntt.base_grid_plain(y_k, bits2, n_cols, inverse),
                    muls3 * IMAD_PER_GL_MUL, bytes3, shape, path),
    ]
    del x, y_k
    torch.cuda.empty_cache()
    return rows


def _poseidon_row(device, batch, path):
    """B4 at the leaf-sponge batch of an extended-domain tree."""
    import torch

    from pil2_stark_tpu_torch.hash import cuda_poseidon

    def plain(s):
        # in slices of 2^23 states: the plain version's int64 temporaries
        # over all 2^25 states exceed the card's 80 GB
        step = 1 << 23
        return torch.cat([cuda_poseidon.permute_plain(s[:, i:i + step])
                          for i in range(0, s.shape[1], step)], dim=1)

    state = random_field((12, batch), 7, device)
    err = max_abs_err(cuda_poseidon.permute(state), plain(state))
    row = _kernel_row(
        "poseidon", "pil2_stark_tpu_torch/csrc/poseidon.cu",
        "pil2_stark_tpu/hash/pallas_poseidon.py:433", err,
        lambda: cuda_poseidon.permute(state), lambda: plain(state),
        batch * POSEIDON_IMAD, 2 * 12 * batch * 8, {"batch": batch}, path)
    del state
    torch.cuda.empty_cache()
    return row


def _b1_rows(device):
    """B1 at the shapes of the LARGE_SETUP prove: the first FRI fold (8 rows,
    3·2^22 lanes, inverse) and the two bases of the 2^25 transforms of 3, 2
    and 1 columns (2^12 rows × cols·2^13 lanes, 2 rows × cols·2^24 lanes)."""
    import torch

    from pil2_stark_tpu_torch.ops import cuda_ntt

    rows = []
    fold_bits = LARGE_BITS - 22
    shapes = [(fold_bits, 3 << 22, True)]
    for cols in (LARGE_COLS, 2, 1):
        shapes += [(12, cols << (LARGE_BITS - 12), False), (1, cols << (LARGE_BITS - 1), False)]
    for bits, lanes, inverse in shapes:
        n = 1 << bits
        x = random_field((n, lanes), 200 + bits, device)
        err = max_abs_err(cuda_ntt.base_rows(x, bits, inverse),
                          cuda_ntt.base_rows_plain(x, bits, inverse))
        row = _kernel_row("base_rows", "pil2_stark_tpu_torch/csrc/ntt.cu",
                          "pil2_stark_tpu/ops/pallas_ntt.py:519", err,
                          lambda: cuda_ntt.base_rows(x, bits, inverse),
                          lambda: cuda_ntt.base_rows_plain(x, bits, inverse),
                          n * lanes * bits / 2 * IMAD_PER_GL_MUL, 2 * n * lanes * 8,
                          {"n": n, "lanes": lanes, "inverse": inverse}, LARGE_SETUP)
        if bits > 5:  # the radix regime's passes (ops/cuda_ntt.py::radix_split)
            la, lb = cuda_ntt.radix_split(bits)
            inv = int(inverse)
            row["ptxas"] = {f"pass {k}": _ptxas(f"base_rows_pass<{log},inv={inv},tw={tw},canon={cn}>",
                                                "ntt")
                            for k, log, tw, cn in ((1, la, 1, 1), (2, lb, 0, 0)) if log}
        rows.append(row)
        del x
        torch.cuda.empty_cache()
    return rows


def _ptxas(label, lib="tac"):
    """[registers, spill stores, spill loads, stack bytes] of a kernel of
    csrc/tac.cu (or of a generated library), from its build log."""
    from pil2_stark_tpu_torch.utils import cuda_build

    hit = [e[1:] for e in ptxas_summary(cuda_build.build_log(lib)) if e[0] == label]
    return hit[0] if hit else None


def _tac_rows(device, setup_name, programs):
    """T1, the kernel generated for each program, against run_plain on
    random canonical inputs of each program at the prove's size; with its
    ptxas counts and nvcc seconds from its own build, and its SASS per row
    (one trip of the grid-stride loop)."""
    import torch

    from pil2_stark_tpu_torch.ops import tac_codegen, torch_tac
    from pil2_stark_tpu_torch.stark import setup as stark_setup
    from pil2_stark_tpu_torch.utils import cuda_build

    setup = stark_setup.read_setup(setup_name)
    info = setup["starkInfo"]
    ss = info["starkStruct"]
    rows = []
    for k, which in enumerate(programs):
        code, dom = torch_tac.device_program(info, setup["expressionsInfo"], which)
        prog = torch_tac.compile_program(code, dom, info, ss["nBits"], ss["nBitsExt"])
        gen = tac_codegen.generate(prog)
        lib = cuda_build.add_generated(gen.source)
        n = prog.n
        sections = {"const": random_field((info["nConstants"], n), 300 + k, device)}
        for i in range(info["nStages"] + (1 if dom == "ext" else 0)):
            sections[f"cm{i + 1}"] = random_field(
                (info["mapSectionsN"][f"cm{i + 1}"], n), 310 + 10 * k + i, device)
        inputs = {"sections": sections, "x": random_field((n,), 320 + k, device),
                  "Zi": random_field((len(info["boundaries"]), n), 330 + k, device),
                  "xDivXSubXi": random_field((len(info["openingPoints"]), 3, n), 340 + k,
                                             device),
                  "publics": random_field((max(info["nPublics"], 1),), 350 + k, device),
                  "challenges": random_field((len(info["challengesMap"]), 3), 360 + k, device),
                  "evals": random_field((max(len(info["evMap"]), 1), 3), 370 + k, device)}
        got = torch_tac.run_kernel(prog, inputs)
        want = torch_tac.run_plain(prog, inputs)
        outs = [(key, got[key], want[key]) for key in ("q", "f") if key in want]
        outs += [(key, got["cm"][key], v) for key, v in want["cm"].items()]
        same = (sorted(got["cm"]) == sorted(want["cm"])
                and all(key in got for key in ("q", "f") if key in want))
        err = max([exact_err(a, b) for _, a, b in outs] + [0.0 if same else float("inf")])
        del got, want
        cost = prog.cost()
        _, launch = torch_tac.prepare_kernel(prog, inputs)
        row = _kernel_row(
            "tac_program", T1_SRC, "pil2_stark_tpu/ops/jax_tac.py:53", err,
            launch, lambda: torch_tac.run_plain(prog, inputs),
            cost["gl_muls"] * n * IMAD_PER_GL_MUL,
            (cost["read_words"] + cost["write_words"]) * n * 8,
            {"program": which, "dom": dom, "n": n, "instructions": len(code["code"]),
             "live_values": prog.n_slots, "segments": len(prog.segments),
             "columns": gen.n_cols, "scalars": gen.n_scalars, **cost},
            setup_name, reps=20 if n <= 1 << 22 else 5)
        sass = sass_counts(lib, "tac_seg0", [], outer=True)
        row.update(note=XLA_FUSION, ratio=row["ms"] / row["bound_ms"], library=lib,
                   ptxas={f"tac_seg{s}": _ptxas(f"tac_seg{s}", lib)
                          for s in range(len(prog.segments))},
                   nvcc_s=cuda_build.build_seconds.get(lib),
                   sass_per_row=sass.get("per_permutation"),
                   sass_per_row_by_class=sass.get("per_permutation_by_class"),
                   sass_static=sass.get("static"))
        rows.append(row)
        del inputs, sections, launch
        torch.cuda.empty_cache()
    return rows


def _xdiv_row(device, bits, path):
    """T2 against its plain version with two random opening points."""
    import numpy as np
    import torch

    from pil2_stark_tpu_torch.ops import cuda_tac
    from pil2_stark_tpu_torch.stark import device as stark_device

    n = 1 << bits
    x = random_field((n,), 400 + bits, device)
    xis = [tuple(int(v) for v in np.random.default_rng(410 + o).integers(0, P, 3, dtype=np.uint64))
           for o in range(2)]
    err = exact_err(cuda_tac.gl_xdiv(x, xis), stark_device.compute_xdiv_plain(x, xis))
    row = _kernel_row(
        "gl_xdiv", TAC_SRC, "pil2_stark_tpu/stark/device.py:349", err,
        lambda: cuda_tac.gl_xdiv(x, xis), lambda: stark_device.compute_xdiv_plain(x, xis),
        n * (XDIV_GL_MULS_PER_POINT + len(xis) * XDIV_GL_MULS_PER_OPENING) * IMAD_PER_GL_MUL,
        (1 + 3 * len(xis)) * n * 8,
        {"n": n, "openings": len(xis)}, path, reps=20 if n <= 1 << 22 else 5)
    row.update(note=XLA_FUSION, ptxas=_ptxas(f"xdiv_kernel<{len(xis)}>"))
    del x
    torch.cuda.empty_cache()
    return row


def _kernel_row(name, src, repl, err, k_fn, p_fn, imads, nbytes, shape, path,
                plain_ms=None, reps=20):
    ms = cuda_ms(k_fn, reps)
    if plain_ms is None:
        plain_ms = cuda_ms(p_fn, 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = imads / IMAD_PER_S * 1e3
    return {"name": name, "route": "cuda", "source": src, "replaces": repl,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "shape": shape, "path": path}


def variant_imads(variant: str) -> int:
    """32-bit multiply-adds of one permutation under an X2 variant: the
    work it keeps.  A probe drops the multiplies it skips (nofs keeps the
    S-box before the last matrix); a dedicated squaring needs three of a
    product's four 32x32 partial products."""
    from pil2_stark_tpu_torch.tools import exp_poseidon

    v = exp_poseidon.parse(variant)
    sboxes = (12 if v.probe == "nofs" else 8 * 12) + (0 if v.probe == "nops" else 22)
    mat_muls = 0 if v.probe == "nomxu" else 144 + 22 * 23
    mds = 0 if v.probe == "nomxu" else 7 * 144 * 2
    squares = 2 * sboxes if v.sq else 0
    return (4 * sboxes + mat_muls) * IMAD_PER_GL_MUL - squares + mds


def phase_tools(device, kernel_rows):
    """X2 and X1 against their plain versions at the tools' shapes and
    against B4 at the prove's leaf batches; then the tools' entry points,
    whose launches are counted."""
    import torch

    from pil2_stark_tpu_torch.hash import cuda_poseidon
    from pil2_stark_tpu_torch.tools import exp_poseidon, exp_stream

    t_phase = time.perf_counter()
    x2 = ("poseidon_variant", X2_SRC, "tools/exp_poseidon.py:431", "tools/exp_poseidon")
    x1 = ("poseidon_stream", X1_SRC, "tools/exp_stream.py:108", "tools/exp_stream")
    rows = []

    def row(kernel, err, k_fn, p_fn, imads, n, shape, **kw):
        name, src, repl, path = kernel
        rows.append(_kernel_row(name, src, repl, err, k_fn, p_fn, n * imads, 2 * 12 * n * 8,
                                shape, path, **kw))
        return rows[-1]

    x = random_field((12, TOOL_BATCH), 11, device)
    for variant in X2_VARIANTS:
        want = exp_poseidon.permute_variant_plain(x, variant)
        plain_ms = cuda_ms(lambda: exp_poseidon.permute_variant_plain(x, variant), 1)
        for block in TOOL_BLOCKS:
            fn = exp_poseidon.build(variant, TOOL_BATCH // block, block)
            row(x2, exact_err(fn(x), want), lambda: fn(x), None, variant_imads(variant),
                TOOL_BATCH, {"variant": variant, "batch": TOOL_BATCH, "block": block},
                plain_ms=plain_ms)
    for bits in X1_BITS:
        n = 1 << bits
        x = random_field((12, n), 20 + bits, device)
        fn = exp_stream.build_stream(n // exp_stream.BLK)
        row(x1, exact_err(fn(x), cuda_poseidon.permute_plain(x)), lambda: fn(x),
            lambda: cuda_poseidon.permute_plain(x), POSEIDON_IMAD, n, {"batch": n})
    del x
    torch.cuda.empty_cache()

    # the prove's leaf batches, on B4's row inputs: X1 and every variant that
    # computes Poseidon against B4's output.  Their plain version is the
    # permutation itself, timed on these inputs by B4's row.
    for b4 in [r for r in kernel_rows if r["name"] == "poseidon"]:
        n = b4["shape"]["batch"]
        x = random_field((12, n), 7, device)
        want = cuda_poseidon.permute(x)
        reps = 20 if n <= 1 << 22 else 5
        extra = {"plain_ms": b4["plain_ms"], "reps": reps}
        fn = exp_stream.build_stream(n // exp_stream.BLK)
        r = row(x1, exact_err(fn(x), want), lambda: fn(x), None, POSEIDON_IMAD, n,
                {"batch": n}, **extra)
        r.update(b4_ms=b4["ms"], against="B4")
        for variant in X2_VARIANTS:
            if exp_poseidon.parse(variant).probe is not None:
                continue
            fn = exp_poseidon.build(variant, n // 2048, 2048)
            r = row(x2, exact_err(fn(x), want), lambda: fn(x), None, variant_imads(variant),
                    n, {"variant": variant, "batch": n, "block": 2048}, **extra)
            r.update(b4_ms=b4["ms"], against="B4")
        del x, want
        torch.cuda.empty_cache()
    for r in rows:
        emit({"phase": "tools", **r})
    bad = [(r["name"], r["shape"]) for r in rows if r["max_abs_err"] != 0]
    if bad:
        raise AssertionError(f"tool kernels disagree with their plain versions or B4: {bad}")

    # the tools' entry points, counted
    exp_poseidon.permute_variant.launches = 0
    exp_stream.permute_stream.launches = 0
    t0 = time.perf_counter()
    runs = exp_poseidon.main(list(X2_VARIANTS), device=device)
    sustained = [exp_poseidon.run_sustained(v, device=device) for v in X2_VARIANTS]
    stream = exp_stream.main(device=device)
    launches = {x2[3]: {"permute_variant": exp_poseidon.permute_variant.launches},
                x1[3]: {"permute_stream": exp_stream.permute_stream.launches}}
    per_variant = {r["variant"]: r["launches"] for r in runs}
    for r in sustained:
        per_variant[r["variant"]] += r["launches"]
    emit({"phase": "tools_main", "seconds": time.perf_counter() - t0,
          "phase_seconds": time.perf_counter() - t_phase,
          "exp_poseidon": runs, "sustained": sustained, "exp_stream": stream,
          "launches": launches, "launches_by_variant": per_variant})
    torch.cuda.empty_cache()
    if not (all(r["ok"] for r in runs) and stream["ok"]):
        raise AssertionError("a tool's own check failed on the card")
    if min(per_variant.values()) == 0 or exp_stream.permute_stream.launches == 0:
        raise AssertionError(f"a tool kernel never launched: {per_variant}, {launches}")
    for r in rows:
        if r["name"] == "poseidon_variant":
            r["launches_variant"] = per_variant[r["shape"]["variant"]]
    return rows, launches


def _prove_all(n_bits, device, setup=None):
    from pil2_stark_tpu_torch.models import gadgets
    from pil2_stark_tpu_torch.stark import prover, setup as stark_setup

    data = stark_setup.read_setup(f"all_{n_bits}")
    const_cols, cm_cols, publics = gadgets.build_all(data["references"], 1 << n_bits)
    if setup is None:
        setup = stark_setup.load_setup(data["starkInfo"], data["expressionsInfo"],
                                       data["verifierInfo"], const_cols.buffer, device=device)
    res = prover.prove(setup["starkInfo"], setup["expressionsInfo"], const_cols.buffer,
                       setup["constTree"], (cm_cols.buffer, publics), device=device)
    return res, setup


def phase_small(device):
    from pil2_stark_tpu_torch.stark import verifier

    t0 = time.perf_counter()
    res_gpu, s_gpu = _prove_all(8, device)
    res_cpu, _ = _prove_all(8, "cpu")
    same = (canon(res_gpu["proof"]) == canon(res_cpu["proof"])
            and res_gpu["challenges"] == res_cpu["challenges"])
    ok = verifier.verify(res_gpu["proof"], res_gpu["publics"], s_gpu["constRoot"],
                         s_gpu["starkInfo"], s_gpu["verifierInfo"])
    emit({"phase": "small", "machine": "all", "n_bits": 8, "identical": same,
          "verified": ok, "seconds": time.perf_counter() - t0})
    if not (same and ok):
        raise AssertionError("all 2^8: card and CPU proofs differ or do not verify")


@contextlib.contextmanager
def plain_b1():
    """ops/ntt.py's row route with kernel B1 replaced by its plain version."""
    from pil2_stark_tpu_torch.ops import cuda_ntt

    kernel = cuda_ntt.base_rows
    cuda_ntt.base_rows = cuda_ntt.base_rows_plain
    try:
        yield
    finally:
        cuda_ntt.base_rows = kernel


def host_eval(x_u64, k: int) -> int:
    """Σ_i x_i·w_N^(i·k) mod p on the host (numpy, field/gl64.py).  w^(i·k)
    repeats with period N / gcd(k, N), so the x_i are first summed per
    residue class of i modulo that period."""
    import numpy as np

    from pil2_stark_tpu_torch.field import gl64

    n = x_u64.shape[0]
    period = n // ((k & -k) if k else n)
    classes = x_u64.reshape(n // period, period)
    lo = (classes & np.uint64(0xFFFFFFFF)).sum(axis=0, dtype=np.uint64)
    hi = (classes >> np.uint64(32)).sum(axis=0, dtype=np.uint64)
    sums = np.array([(int(a) + (int(b) << 32)) % P for a, b in zip(lo, hi)], dtype=np.uint64)
    z = pow(gl64.w(n.bit_length() - 1), k, P)
    terms = gl64.mul(sums, gl64.powers(z, period))
    return sum(int(v) for v in terms) % P


def phase_large_ntt(device, bits, n_cols):
    import torch

    from pil2_stark_tpu_torch.field import torch_gl as gl
    from pil2_stark_tpu_torch.ops import cuda_ntt, ntt

    n = 1 << bits
    x = random_field((n_cols, n), 250, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    before = cuda_ntt.base_rows.launches
    y = ntt.ntt(x, bits)
    torch.cuda.synchronize()
    launches = cuda_ntt.base_rows.launches - before
    peak = torch.cuda.max_memory_allocated(device)
    ms = cuda_ms(lambda: ntt.ntt(x, bits), 3)
    round_trip = torch.equal(ntt.intt(y, bits), x)
    with plain_b1():
        plain_ms = cuda_ms(lambda: ntt.ntt(x, bits), 1)
        same_as_plain = torch.equal(ntt.ntt(x, bits), y)
    idx = [0, n // 2, 3 << 10, (0x5A5A5 << 5) % n]
    x_host = gl.to_u64(x)
    y_host = gl.to_u64(y[:, idx])
    spots = all(host_eval(x_host[c], k) == int(y_host[c, j])
                for c in range(n_cols) for j, k in enumerate(idx))
    emit({"phase": "large_ntt", "n_bits": bits, "n_cols": n_cols, "round_trip": round_trip,
          "equals_plain_route": same_as_plain, "spot_checks": spots, "spot_indices": idx,
          "ms": ms, "plain_route_ms": plain_ms, "b1_launches": launches,
          "peak_device_bytes": peak})
    del x, y
    torch.cuda.empty_cache()
    if not (round_trip and same_as_plain and spots and launches > 0):
        raise AssertionError(f"the 2^{bits} transform is wrong or skipped B1")


def phase_prove(device, setup_name, counters):
    """Prove one committed setup on the card, cold then warm; verify."""
    import torch

    from pil2_stark_tpu_torch.models import fibonacci, gadgets
    from pil2_stark_tpu_torch.ops import cuda_ntt
    from pil2_stark_tpu_torch.stark import prover, setup as stark_setup, verifier

    data = stark_setup.read_setup(setup_name)
    build = {"all": gadgets.build_all, "fibonacci": fibonacci.build}[data["machine"]]
    t0 = time.perf_counter()
    const_cols, cm_cols, publics = build(data["references"], 1 << data["nBits"])
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    setup = stark_setup.load_setup(data["starkInfo"], data["expressionsInfo"],
                                   data["verifierInfo"], const_cols.buffer, device=device)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0

    def run():
        t = time.perf_counter()
        res = prover.prove(setup["starkInfo"], setup["expressionsInfo"], const_cols.buffer,
                           setup["constTree"], (cm_cols.buffer, publics), device=device)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t

    for c in counters:
        c.launches = 0
    cuda_ntt.base_rows.shapes.clear()  # B1's launches by (rows, lanes)
    res, cold = run()
    launches = {c.__name__: c.launches for c in counters}
    b1 = {f"{n}x{lanes}": k for (n, lanes), k in sorted(cuda_ntt.base_rows.shapes.items())}
    miscounted = {k: (launches[k], v) for k, v in PROVE_LAUNCHES.items()
                  if k in launches and launches[k] != v}
    res_warm, warm = run()
    peak = max(res_warm["peakBytes"].values())  # every allocation happens inside a phase
    same = canon(res["proof"]) == canon(res_warm["proof"])
    t0 = time.perf_counter()
    ok = verifier.verify(res_warm["proof"], res_warm["publics"], setup["constRoot"],
                         setup["starkInfo"], setup["verifierInfo"])
    t_verify = time.perf_counter() - t0
    ss = data["starkInfo"]["starkStruct"]
    emit({"phase": "prove" if data["machine"] == "all" else "prove_large",
          "setup": setup_name, "machine": data["machine"], "n_bits": ss["nBits"],
          "n_bits_ext": ss["nBitsExt"], "n_queries": ss["nQueries"],
          "verified": ok, "repeatable": same, "cold_s": cold, "warm_s": warm,
          "witness_build_s": t_build, "load_setup_s": t_setup, "verify_s": t_verify,
          "peak_device_bytes": peak, "phases_warm_s": res_warm["timings"],
          "phases_cold_s": res["timings"], "phases_peak_bytes": res_warm["peakBytes"],
          "launches": launches, "b1_launches_by_shape": b1})
    del setup, res, res_warm
    torch.cuda.empty_cache()
    if not (ok and same):
        raise AssertionError(f"the {setup_name} proof does not verify or is not repeatable")
    zero = [k for k, v in launches.items() if v == 0]
    if zero:
        raise AssertionError(f"kernels never launched on the {setup_name} prove: {zero}")
    if miscounted:
        raise AssertionError(f"launches (counted, expected) on the {setup_name} prove: "
                             f"{miscounted}")
    return launches


def prove_counters():
    """The wrappers of every kernel the prove path launches (B1–B4, T1, T2)."""
    from pil2_stark_tpu_torch.hash import cuda_poseidon
    from pil2_stark_tpu_torch.ops import cuda_ntt, cuda_tac

    return [cuda_ntt.base_rows, cuda_ntt.level_planar, cuda_ntt.base_grid,
            cuda_poseidon.permute, cuda_tac.tac_program, cuda_tac.gl_xdiv]


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        counters = prove_counters()
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 2

    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    phase_build()
    rows = phase_kernels(device)
    tool_rows, launches = phase_tools(device, rows)
    phase_small(device)
    phase_large_ntt(device, LARGE_BITS, LARGE_COLS)
    launches.update({name: phase_prove(device, name, counters)
                     for name in (f"all_{N_BITS}", LARGE_SETUP)})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(card_line(), flush=True)
    names = {"base_rows": "base_rows", "level_planar": "level_planar",
             "base_grid": "base_grid", "poseidon": "permute",
             "poseidon_variant": "permute_variant", "poseidon_stream": "permute_stream",
             "tac_program": "tac_program", "gl_xdiv": "gl_xdiv"}
    kernels = []
    for r in rows + tool_rows:
        counter = names[r["name"]]
        kernels.append(dict(r, launches=launches[r["path"]][counter],
                            launches_by_path={p: c[counter] for p, c in launches.items()
                                              if counter in c}))
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
