#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (pil2_stark_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. build       — compile every CUDA source of the port and the T1 kernel
                   generated for each TAC program of the proves and of the
                   recursion machines (recursion_programs; one nvcc per
                   source, all in parallel); registers and spills from
                   ptxas (B1's 64-point passes and T2 at two openings in
                   their own entry, B2's and B3's passes at the planar
                   transforms of both proves in another), and SASS
                   instructions per permutation by class (cuobjdump) of
                   B4, of X1 and of each of X2's 20 instantiations, all on
                   B4's schedule;
  1b. compile    — compile every committed setup (setups/*.json: 10
                   STARK setups, 2 debug setups, the 5 fibv files) with the
                   port's PIL compiler (stark/catalog.py; no JAX here) and
                   require each to equal its JSON; seconds per file;
  2. kernels     — run each kernel at the shapes each prove path gives it
                   (B2 level_planar and B3 base_grid at the widest planar
                   transforms, with each pass's ptxas counts, B4 Poseidon
                   at the leaf batch of each tree, B1 base_rows at the FRI
                   fold and the two bases of each
                   2^25 transform of the prove, T1 tac_program on each TAC
                   program of both proves at its size, with its ptxas
                   counts, nvcc seconds and SASS per row, T2 gl_xdiv with
                   2 openings at 2^22 and 2^25) on random values plus
                   near-p corners, and
                   require output equal bit for bit to its plain PyTorch
                   version; time both;
  3. tools       — the Poseidon experiment tools: kernel X2 (every variant
                   of tools/exp_poseidon, the control packed-nosq-lazy
                   included, at its own 2^16 states with blocks 512 and
                   2048, and at 2^14 corner states) and X1 (tools/exp_stream,
                   at 2^14 and 2^20 states, at 2^14 corner states and at
                   2^14 non-canonical u64 states) equal bit for bit to
                   their plain versions; every variant that computes
                   Poseidon, and X1, equal to B4 at the prove's leaf
                   batches of 2^22 and 2^25 states and timed beside it
                   (vs_b4); then the two tools'
                   entry points on the card, with X1/X2 launches counted;
  4. small       — prove on the card and on the CPU, and require the two
                   proofs to be identical: the all-gadgets machine at 2^8,
                   the boundary machine (everyFrame, firstRow, lastRow),
                   fibonacci with hashCommits, the Poseidon VM at 2^6 and
                   both fibv airs under one set of external challenges;
                   verify_global_constraints must accept the fibv proofs'
                   subproof values and reject a changed one, and
                   prove(debug=True) on the card must find no error in the
                   VM's witness and the CPU's errors in one with a flipped
                   state element; fibonacci 2^6 with BN128 trees (arity
                   16, merkleTreeCustom false and true: trees on the host,
                   transforms and T1/T2 on the card) must equal the CPU's
                   proof, verify and upload the fixed columns zero times,
                   with the host seconds of each BN128 tree; then the
                   smallest chain of the recursion tier: fibonacci 2^4 /
                   ext 2^7 with 2 queries (card = CPU), its verifier
                   circuit (pil2circom) through the port's circom
                   front-end, its C12 and C18 machines, and the C12 of the
                   vadcop Aggregate2 circuit of two such proofs, each
                   proved on the card and on the CPU (identical, verified);
  5. large_ntt   — a 2^25-point transform of 3 columns (the row route on
                   B1): intt(ntt(x)) == x, ntt equal to the same route with
                   the plain B1, and 4 outputs equal to a host evaluation of
                   the polynomials; its time and peak memory;
  6. prove       — prove the all-gadgets machine at 2^20 rows (nBitsExt 22,
                   32 queries) on the card through prove(), once (its host
                   hints take about 100 s a prove); verify the proof;
                   report the wall time, the phase breakdown and peak
                   memory;
  7. prove_large — the same for fibonacci at 2^22 rows, nBitsExt 25 (the
                   row route, setups/fibonacci_22.json), cold and warm;
  8. prove_vm    — the same for the Poseidon VM at 2^20 rows (2^15
                   permutations of random states, nBitsExt 23, 32
                   queries), the widest machine: 39 fixed, 12 witness and
                   21 Q columns; its setup is made here by the port:
                   compile_pil_source(poseidon_vm.pil_source(20)), then
                   stark_setup and prove on the default device (None:
                   the card), and the setup must equal
                   setups/poseidon_vm_20.json; the trace's last states must
                   equal the host permutation; its verify runs on the host
                   C++ runtime (runtime/native.py), then once more on the
                   python-int hashing it replaced (verify_plain_s);
  8b. cli        — the port's CLI (python -m pil2_stark_tpu_torch) on the
                   VM with prove_vm's inputs, its files under the
                   gitignored pil2_stark_tpu_torch/_build/cli/ (removed
                   after): `prove` from pil.json, const.npy, commit.npy
                   and publics.json in this process, launches counted as
                   in a prove phase, the fixed columns uploaded once (by
                   the setup) and never by the prove, proof.json equal to
                   prove_vm's proof; `verify` in a fresh process (exit 0;
                   exit 1 with one evaluation changed); `buildconsttree`
                   from a PSTC container of the fixed columns (about 3.15
                   GB of tree and 2.94 GB of consts written: its verkey
                   the prove's, read_tree's root that root, four random
                   rows equal to the card's LDE); `genstarkinfo` from the
                   VM's PIL source equal to the committed starkInfo; then
                   `prove --model fibonacci --nbits 6` and `verify` (exit
                   0; exit 1 with a public changed) in fresh processes on
                   the default device; seconds per subcommand and bytes;
                   then the smallest recursion chain through the CLI:
                   `prove --model fibonacci --nbits 4`, `pil2circom`,
                   `compressor-setup --cols 12`, `compressor-exec`, `prove
                   --pil-json ...` of the C12 (its proof.json equal to the
                   small phase's library proof, launches counted) and
                   `verify` in a fresh process; `buildchelpers` on the VM
                   2^20, read back;
  8c. mesh       — the multi-device prover (parallel/) on the VM 2^20 /
                   ext 2^23 with prove_vm's setup and columns, the extended
                   domain row-sharded through the whole prove: B2 and B3 at
                   one rank's shapes of a mesh of MESH_RANKS (21 × 2^23
                   and 12 × 2^20 split four ways), T1 on the Q and FRI
                   programs at a shard's rows with their halo (a row base,
                   signed shifts) and T2 at 2^21 points, against their
                   plain versions, timed; prove(mesh=) on MESH_RANKS
                   virtual ranks of this card, cold and warm (phases, each
                   card's peak, bytes exchanged, fixed-column uploads,
                   launches: T1 once for the im-pols and once per rank for
                   Q and FRI, T2 once per rank; each rank's bytes of
                   extended rows, printed, which must be 1/d of one
                   device's); with two or more cards the same over every
                   card in this process, and one process per card over NCCL
                   (this script with --mesh-worker); every proof must equal
                   prove_vm's byte for byte and verify; a line names the
                   paths that ran and why the others did not;
  9. profile     — one warm prove each of the VM and fibonacci 2^22 under
                   prove(profile_dir=): the card's idle share over the prove
                   (utils/timing.py::idle_share) and the device's top
                   operations by time;
 10. recursion   — fibonacci 2^22 / ext 2^25 with 32 queries (the
                   fibonacci_22 struct, its FRI ending at 4 bits: ROADMAP
                   hazard 8) compiled, set up and proved on the default
                   device and verified right after the kernels phase; the
                   host half of the chain runs meanwhile in a process of its
                   own (this script with --recursion-worker): pil2circom,
                   the circom front-end on the proof's zkin and check()
                   (signals, constraints, custom-gate uses, seconds, peak
                   RSS), then the C12 and C18 machines (compressor setup,
                   exec).  At the end, the C12 and C18 are compiled by the
                   port (blowup 2, 64 queries, FRI steps of 4 bits), their
                   six T1 programs built in one round, set up on the card;
                   B2/B3 at each machine's stage-1 iNTT and widest blowup-2
                   NTT, B4 at its leaf batch, B1 at its first FRI fold, T1
                   on its three programs and T2 at its extended domain are
                   held against their plain versions (paths "recursion"
                   and "recursion_c18"); the C12 is proved cold and warm
                   (phases, peak, launches, no fixed-column upload) and
                   once more under the profiler (idle share); the C18 is
                   proved once; every proof must verify.  The worker, once
                   its machines are written, runs a debug prove on the card
                   of the C12's witness with one corrupted wire (minutes of
                   host constraint checks), which must find errors.  The
                   recursion machines' T1 programs build in a thread from
                   the start of the build phase (RecursionBuild).
 11. snark       — the BN128 half of the recursion tier.  Right after the
                   recursion path's inner proof, fibonacci 2^6 / ext 2^9
                   with BN128 trees and 4 queries (plain at arity 16,
                   merkleTreeCustom at arity 4) is compiled by the port,
                   set up and proved on the default device (launches
                   counted over both proves, not their setups: B1, B3,
                   T1 and T2 must run; its transforms are single B3
                   passes and its trees host Poseidon-BN254) and
                   verified, with no fixed-column upload; each kernel is
                   held against its plain version at the path's shapes.
                   Three worker
                   processes (this script with --snark-worker, at nice 10)
                   then run beside the other phases: for each proof, the same STARK
                   proved on the CPU must equal the card's bit for bit;
                   pil2circom_bn128 emits its verifier circuit (the same
                   text from the CPU's setup); the BN254 front-end builds
                   the witness on the card's zkin and check() holds; a
                   corrupted zkin is refused; the final machine
                   (finalfflonk for the plain circuit, final9 for the
                   custom-gate one) is set up and executed at size, with
                   signals, constraints, rows, seconds and peak RSS; its
                   fflonk setup (40 · N powers of tau on the host) is
                   stated as a cut with its reckoning.  The third worker
                   proves a chain of multiplications laid out as
                   finalfflonk at 2^SNARK_FFLONK_BITS rows with fflonk
                   (dev_ptau, setup, prove, verify; a changed public and
                   evaluation refused; debug mode), then runs Mul3 through
                   the CLI (final-setup, final-exec, fflonkinfo,
                   fflonk-setup, fflonk-prove, fflonk-verify) and requires
                   its proof to equal the library's.  The export leg on
                   the chain's proof: its zkey written and read back
                   (fflonk/zkey_binfile.py) and proved from again, equal
                   to the library's proof; the verification key, the
                   Solidity verifier and the calldata exported, also
                   through exportverificationkey, exportsolidityverifier
                   and exportcalldata on Mul3's files (each equal to the
                   library's); the contract compiled to EVM bytecode and
                   run (fflonk/evm.py): it must accept the proof and refuse
                   a corrupted word and a word at the field's modulus, with
                   its gas; the search optimizer's cost table at the
                   chain's shape with the MSM/FFT ratio measured on its
                   powers of tau.  At the end the phase
                   waits for the workers; launches in `["snark"]`.
Every prove must upload the fixed columns zero times (the const tree keeps
them on the card; fixed_uploads_per_prove, cold and warm).
In each prove phase the kernels' launch counters are zeroed just before the
cold prove and read just after it, and every kernel must have launched (B1,
B2, B3, B4; T1 three times, once per program, and T2 once); B1's kernel
launches are also reported by shape (two per base of more than 64 rows).  B2 and B3 count
two launches per call above 2^6 points (their two passes).  The cli
phase's launches are the kernels line's `launches_by_path["cli"]` (the
VM) and `["cli_recursion"]` (the C12); the recursion phase's
`["recursion"]` (the C12's cold prove) and `["recursion_c18"]`.
Then the card's name and power limit, the kernels line, and as the last line
{"ok": true, "device": {...}}.  Any failure exits non-zero.  Needs one CUDA
card; imports nothing of JAX.  `python3 chip_smoke.py --only mesh` runs the
build, prove_vm and mesh phases alone (for a machine with four cards);
`--only recursion` the build, the small and cli recursion chains and the
recursion phase; `--only snark` the build and the snark phase.  Every process the script starts is ended before it
exits.
"""
from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
import threading
import time

P = 0xFFFFFFFF00000001
N_BITS = 20  # the all-gadgets machine at 2^20 rows, blowup 4 (setups/all_20.json)
N_COLS = 15  # the widest committed section of that machine (stage 1)
LARGE_SETUP = "fibonacci_22"  # fibonacci at 2^22 rows, blowup 8
LARGE_N_BITS = 22
LARGE_BITS = 25  # its extended domain: past the planar ceiling, the row route
LARGE_COLS = 3  # the widest transform of that prove (Q, and the evals' iNTT)
VM_SETUP = "poseidon_vm_20"  # the Poseidon VM at 2^20 rows, blowup 8
VM_N_BITS = 20
VM_BITS = 23  # its extended domain: the planar route (B2/B3)
VM_SEED = 3  # its input states, as tests/test_poseidon_vm.py makes them
# (bits, columns, inverse) of its widest planar transforms in a prove: the
# Q split's 21-column NTT and the stage-1 12-column iNTT
VM_PLANAR = ((VM_BITS, 21, False), (VM_N_BITS, 12, True))
# the mesh phase's virtual ranks on one card: they divide both factors of the
# VM's transforms (2^8 x 2^12 at 2^20 points, 2^11 x 2^12 at 2^23)
MESH_RANKS = 4
SMALL_SETUPS = ("all_8", "boundaries_6", "fibonacci_6_hash", "poseidon_vm_6")
FIBV_AIRS = ("fibv_module", "fibv_fibonacci")
PROFILE_DIR = "pil2_stark_tpu_torch/_build/profile"  # under the checkout, gitignored
MESH_DIR = "pil2_stark_tpu_torch/_build/mesh"  # the NCCL workers' output, gitignored
# the recursion path: fibonacci 2^22 / ext 2^25 (LARGE_SETUP's struct, its FRI
# ending at 4 bits: inner_struct) verified inside a C12 and a C18 machine of
# blowup 2 and RECURSION_QUERIES queries (no count is set for a C12 in the
# JAX package but its tests' 8); the front-end's worker writes under
# RECURSION_DIR (gitignored)
RECURSION_DIR = "pil2_stark_tpu_torch/_build/recursion"
RECURSION_QUERIES = 64
RECURSION_PATHS = {12: "recursion", 18: "recursion_c18"}
RECURSION_WAIT_S = 1000  # the longest the recursion phase waits on the worker
# the smallest chain (small and cli phases): fibonacci 2^4 / ext 2^7 with 2
# queries, its C12 / C18 at 2^11 / 2^10 rows with the JAX tests' 8 queries
SMALL_CHAIN = {"nBits": 4, "nBitsExt": 7, "nQueries": 2, "verificationHashType": "GL",
               "steps": [{"nBits": 7}, {"nBits": 3}]}
SMALL_QUERIES = 8
# the snark path (the BN128 half of the recursion tier): fibonacci 2^6 / ext
# 2^9 with BN128 trees and 4 queries (the struct of tests/test_circom_bn128.py),
# merkleTreeCustom false at arity 16 and true at arity 4 (t = 5, the widest
# PoseidonT the final9 machine lays out), proved on the card; its verifier
# circuits, their final machines (finalfflonk for the plain circuit, final9
# for the custom-gate one) and the fflonk leg run in worker processes that
# write under SNARK_DIR (gitignored)
SNARK_DIR = "pil2_stark_tpu_torch/_build/snark"
SNARK_QUERIES = 4
SNARK_CASES = {"plain": {"merkleTreeArity": 16},
               "custom": {"merkleTreeArity": 4, "merkleTreeCustom": True}}
SNARK_FINAL_COLS = {"plain": 0, "custom": 9}
# the kernels the snark path's proves launch: its transforms (up to 2^9
# points) are single B3 passes (ops/ntt.py::planar_ntt, n1 = 1), so B2 has
# no launch there, and its trees are host Poseidon-BN254, so B4 has none
SNARK_KERNELS = ("base_rows", "base_grid", "tac_program", "gl_xdiv")
# the fflonk leg's rows: 40 · 2^9 powers of tau, the most that fit about
# 120 s of the card machine's host (PERF.md §6)
SNARK_FFLONK_BITS = 9
SNARK_SEED = 7  # the fflonk proofs' blinding, random.Random(SNARK_SEED)
SNARK_TAU = 4242  # dev_ptau's toxic scalar (the CLI's --tau)
SNARK_PTAU_SAMPLE = 16  # powers timed to reckon the cut fflonk setup
SNARK_WAIT_S = 1000  # the longest the snark phase waits on its workers, from their start
MUL3 = """pragma circom 2.1.0;
template Mul3() {
    signal input x;
    signal input y;
    signal output out;
    signal t1 <== x * y;
    signal t2 <== t1 * t1 + x + 5;
    out <== t2 * y;
}
component main {public [x]} = Mul3();
"""
WORKERS: list = []  # every process this script starts and has not yet ended
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
X2_VARIANTS = ("packed", "packed-nosq", "packed-lazy", "packed-nosq-lazy", "packed-dual",
               "packed-lazy-dual", "packed-p4x", "packed-psl", "nomxu", "packed-nops",
               "packed-nofs")
# the block of X2's rows beside B4: one state a thread, B4's geometry; the
# control also at the tool's 2048 (eight states a thread: warps drift apart)
X2_B4_BLOCK = 256
CORNER_BITS = 14  # the corner-state rows' batch
TOOL_BATCH = 1 << 16  # run_variant's and run_sustained's batch
TOOL_BLOCKS = (512, 2048)  # run_variant's and run_sustained's block
X1_BITS = (14, 20)  # exp_stream.main's check size and its largest timed size
X2_SRC = "pil2_stark_tpu_torch/csrc/poseidon_variants.cu"
X1_SRC = "pil2_stark_tpu_torch/csrc/poseidon_stream.cu"
# (bits, inverse) of the planar transforms whose passes the build line
# reports: the all-gadgets 2^22 LDE and 2^20 iNTT, fibonacci's 2^22 iNTT,
# the VM's 2^23 LDE
PLANAR_SHAPES = ((N_BITS + 2, False), (N_BITS, True), (LARGE_N_BITS, True), (VM_BITS, False))
CORNERS = [0, 1, 2, P - 1, P - 2, (1 << 32) - 1, 1 << 32, (1 << 32) + 1,
           (1 << 63) - 1, 1 << 63, P - (1 << 32), P - (1 << 32) - 1]
# u64 words in [p, 2^64): representatives that are not canonical
NON_CANONICAL = [P + k for k in (0, 1, 2, 3, 7, 1 << 16, 1 << 20, 1 << 31, (1 << 31) + 1,
                                 (1 << 32) - 4, (1 << 32) - 3, (1 << 32) - 2)]


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
            lv = re.search(r"level_pass_kernelILi(\d)ELi(\d+)ELb(\d)ELb(\d)E", name)
            label = (f"variant_kernel<sq={t[1]},lazy={t[2]},probe={t[3]},ns={t[4]}>" if t
                     else f"tac_seg{u[1]}" if u
                     else f"xdiv_kernel<{x[1]}>" if x
                     else f"base_rows_pass<{b[1]},inv={b[2]},tw={b[3]},canon={b[4]}>" if b
                     else f"level_pass<{lv[1]},ta={lv[2]},inv={lv[3]},canon={lv[4]}>" if lv
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
    for name in (f"all_{N_BITS}", LARGE_SETUP, VM_SETUP, "boundaries_6", "fibonacci_6") + FIBV_AIRS:
        data = stark_setup.read_setup(name)
        for which, prog in torch_tac.setup_programs(data["starkInfo"],
                                                    data["expressionsInfo"]).items():
            out[(name, which)] = (prog, cuda_build.add_generated(
                tac_codegen.generate(prog).source))
    return out


def recursion_programs():
    """{(machine, publics, program): library} of T1 for the recursion
    machines: the generated source of a C12 or C18 program depends on its
    PIL's publics but not on its rows (the sources at 2^10 and 2^18 rows
    are equal), so those of compressor*._pil_source at 2^10 rows serve the
    small chain (3 publics), its Aggregate2 (6) and the recursion path (3).
    Their Q programs take nvcc minutes, so they build with the rest."""
    from pil2_stark_tpu_torch.compiler import compressor12, compressor18, pil1_parser
    from pil2_stark_tpu_torch.ops import tac_codegen, torch_tac
    from pil2_stark_tpu_torch.stark import setup as stark_setup
    from pil2_stark_tpu_torch.utils import cuda_build

    out = {}
    for name, mod, publics in (("C12", compressor12, 3), ("C12", compressor12, 6),
                               ("C18", compressor18, 3)):
        pil = pil1_parser.compile_pil_source(mod._pil_source(10, publics))
        s = stark_setup.stark_setup(None, pil, recursion_struct(10, SMALL_QUERIES),
                                    options={"skipConstTree": True})
        for which, prog in torch_tac.setup_programs(s["starkInfo"],
                                                    s["expressionsInfo"]).items():
            out[(name, publics, which)] = cuda_build.add_generated(
                tac_codegen.generate(prog).source)
    return out


class RecursionBuild(threading.Thread):
    """recursion_programs and their nvcc round in a thread of their own:
    the Q programs take about three minutes of nvcc, more than every other
    source, and the phases before the small one need none of them."""

    def __init__(self):
        super().__init__(daemon=True)
        self.libs, self.error, self.seconds, self.joined = {}, None, None, False

    def run(self):
        from pil2_stark_tpu_torch.utils import cuda_build

        t0 = time.perf_counter()
        try:
            self.libs = recursion_programs()
            cuda_build.build(list(self.libs.values()))
        except Exception as e:  # re-raised by wait() in the main thread
            self.error = e
        self.seconds = time.perf_counter() - t0

    def wait(self):
        """Join the build once, emit its line, raise what it raised."""
        from pil2_stark_tpu_torch.utils import cuda_build

        if not self.joined:
            t0 = time.perf_counter()
            self.join()
            self.joined = True
            emit({"phase": "build_recursion", "seconds": self.seconds,
                  "waited_s": time.perf_counter() - t0,
                  "per_program_s": {f"{m}/{k}.{w}": cuda_build.build_seconds.get(lib)
                                    for (m, k, w), lib in self.libs.items()},
                  "ptxas": {f"T1 {m}/{k}.{w}": ptxas_summary(cuda_build.build_log(lib))
                            for (m, k, w), lib in self.libs.items()}})
        if self.error is not None:
            raise self.error


REC_BUILD = RecursionBuild()


def phase_build(recursion=True):
    from pil2_stark_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    if recursion:
        REC_BUILD.start()
    tac = tac_programs()
    times = cuda_build.build(list(cuda_build.SOURCES) + [lib for _, lib in tac.values()])
    ptxas = {name: ptxas_summary(cuda_build.build_log(name)) for name in cuda_build.SOURCES}
    ptxas.update({f"T1 {s}.{w}": ptxas_summary(cuda_build.build_log(lib))
                  for (s, w), (_, lib) in tac.items()})
    # B4, X1 (one trip of its stage loop is one permutation per thread) and
    # each X2 instantiation, all on poseidon_fast.cuh's schedule
    sass = {"poseidon": sass_counts("poseidon", "poseidon_kernel", ROUND_TRIPS),
            "poseidon_stream": sass_counts("poseidon_stream", "stream_kernel", ROUND_TRIPS,
                                           outer=True),
            **x2_sass()}
    # B1's radix passes at 4096 rows and T2 at the proves' two openings
    b1_t2 = {e[0]: e[1:] for name in ("ntt", "tac") for e in ptxas[name]
             if e[0].startswith("base_rows_pass<6") or e[0] == "xdiv_kernel<2>"}
    # B2's and B3's passes at the planar transforms of both proves
    b2_b3 = {f"{k} {bits}{' inverse' if inverse else ''} {p}": _ptxas(label, "ntt")
             for bits, inverse in PLANAR_SHAPES
             for k, passes in planar_passes(bits, inverse).items()
             for p, label in passes.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "per_source": times,
          "ptxas": ptxas, "b1_t2_ptxas": b1_t2, "b2_b3_ptxas": b2_b3, "b4_sass": sass})


def x2_sass() -> dict:
    """SASS per permutation of each X2 instantiation (csrc/poseidon_variants.cu
    variant_kernel<SQ, LAZY, PROBE, NS>), from its part of the split build:
    one trip of the kernel's state loop permutes NS states."""
    from pil2_stark_tpu_torch.utils import cuda_build

    out = {}
    for part in cuda_build.SPLITS["poseidon_variants"]:
        sq, ns, group = re.fullmatch(r"sq(\d)_ns(\d)_(\w+)", part).groups()
        ns = int(ns)
        # (lazy, probe): the permutation canonical and lazy, or the three probes
        modes = ((0, 1), (0, 2), (0, 3)) if group == "probes" else ((0, 0), (1, 0))
        for lazy, probe in modes:
            res = sass_counts(f"poseidon_variants.{part}",
                              f"variant_kernelILb{sq}ELb{lazy}ELi{probe}ELi{ns}E",
                              ROUND_TRIPS, outer=True)
            if res.get("per_permutation"):
                res["per_permutation"] /= ns
                res["per_permutation_by_class"] = {
                    k: v / ns for k, v in res["per_permutation_by_class"].items()}
            out[f"variant_kernel<sq={sq},lazy={lazy},probe={probe},ns={ns}>"] = res
    return out


def phase_compile():
    """Compile every committed setup with the port's PIL compiler (no JAX
    here) and require each to equal its JSON."""
    from pil2_stark_tpu_torch.stark import catalog, setup as stark_setup

    t_all = time.perf_counter()
    cases, differ = {}, []
    for name in catalog.FILES:
        t0 = time.perf_counter()
        fresh = catalog.compile_file(name)
        secs = time.perf_counter() - t0
        equal = fresh == stark_setup.read_setup(name)
        cases[name] = {"s": secs, "equal": equal}
        if not equal:
            differ.append(name)
    emit({"phase": "compile", "seconds": time.perf_counter() - t_all, "n_files": len(cases),
          "cases": cases})
    if differ:
        raise AssertionError(f"the port's compile differs from the committed setups: {differ}")


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
    # the Poseidon VM at 2^20 / ext 2^23: B2/B3 at its widest transforms,
    # B4 at its trees' leaf batch, T1 on its three programs (the Q program
    # of 870 instructions), T2 at 2^23
    for bits, cols, inverse in VM_PLANAR:
        rows += _ntt_rows(device, bits, cols, inverse, VM_SETUP)
    rows.append(_poseidon_row(device, 1 << VM_BITS, VM_SETUP))
    rows += _tac_rows(device, VM_SETUP, ("imPols", "q", "fri"))
    rows.append(_xdiv_row(device, VM_BITS, VM_SETUP))
    for r in rows:
        emit({"phase": "kernels", **r})
    bad = [(r["name"], r["path"], r["shape"]) for r in rows if r["max_abs_err"] != 0]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")
    torch.cuda.empty_cache()
    return rows


def radix_passes(bits, inverse) -> dict:
    """ptxas labels of B1's passes for a 2^bits-row transform (bits > 5),
    as csrc/ntt.cu launch_radix runs them; B3 runs the same passes."""
    from pil2_stark_tpu_torch.ops import cuda_ntt

    la, lb = cuda_ntt.radix_split(bits)
    inv = int(inverse)
    out = {"pass 1": f"base_rows_pass<{la},inv={inv},tw=1,canon=1>"} if la else {}
    out["pass 2"] = f"base_rows_pass<{lb},inv={inv},tw=0,canon={0 if la else 1}>"
    return out


def planar_passes(bits, inverse) -> dict:
    """{"B2": labels, "B3": labels} of a planar transform of 2^bits points
    (12 < bits <= 24), as ops/ntt.py::planar_ntt splits it."""
    from pil2_stark_tpu_torch.ops import cuda_ntt, ntt

    bits1 = ntt.split_bits(bits)
    la, lb = cuda_ntt.radix_split(bits1)
    inv = int(inverse)
    b2 = {"pass 1": f"base_rows_pass<{la},inv={inv},tw=1,canon=1>"} if la else {}
    b2["pass 2"] = (f"level_pass<{lb},ta={cuda_ntt.LEVEL_OA if la else 1},inv={inv},"
                    f"canon={0 if la else 1}>")
    return {"B2": b2, "B3": radix_passes(bits - bits1, inverse)}


def _ntt_rows(device, bits, n_cols, inverse, path, ranks=1):
    """B2 (level_planar) and B3 (base_grid) at one planar transform of
    n_cols × 2^bits points, as ops/ntt.py::planar_ntt splits it; with
    ranks = d > 1 at the local shapes of one rank of a mesh of d
    (parallel/ntt_sharded.py: B2 over its N2/d columns of the level
    twiddles, B3 over its N1/d columns), the last rank's twiddles."""
    import torch

    from pil2_stark_tpu_torch.ops import cuda_ntt, ntt
    from pil2_stark_tpu_torch.parallel import ntt_sharded

    n = 1 << bits
    bits1 = ntt.split_bits(bits)
    bits2 = bits - bits1
    n1, n2 = 1 << bits1, 1 << bits2
    m1, m2 = n1 // ranks, n2 // ranks
    n_local = n // ranks
    x = random_field((n_cols, n1 * m2), 100 + bits + n_cols, device)
    if ranks == 1:
        lt = ntt.level_twiddles(bits, bits1, inverse, device)
    else:
        lt = ntt_sharded.rank_twiddles(bits, inverse, ranks, ranks - 1, device)
    y_k = cuda_ntt.level_planar(x, bits1, m2, n_cols, lt, inverse)
    err2 = max_abs_err(y_k, cuda_ntt.level_planar_plain(x, bits1, m2, n_cols, lt, inverse))
    # B3's input: B2's output on one device, a rank's o1 block after the
    # exchange on a mesh
    z = y_k if ranks == 1 else random_field((n_cols * n2, m1), 150 + bits + n_cols, device)
    err3 = max_abs_err(cuda_ntt.base_grid(z, bits2, n_cols, inverse),
                       cuda_ntt.base_grid_plain(z, bits2, n_cols, inverse))
    muls2 = n_cols * n_local * (bits1 / 2 + 1)
    bytes2 = 2 * n_cols * n_local * 8 + n1 * m2 * 8
    muls3 = n_cols * n_local * bits2 / 2
    bytes3 = 2 * n_cols * n_local * 8
    shape = {"n_cols": n_cols, "n": n, "n1": n1, "n2": n2, "inverse": inverse}
    if ranks > 1:
        shape.update(ranks=ranks, b2_n2=m2, b3_n1=m1)
    rows = [
        _kernel_row("level_planar", "pil2_stark_tpu_torch/csrc/ntt.cu",
                    "pil2_stark_tpu/ops/pallas_ntt.py:439", err2,
                    lambda: cuda_ntt.level_planar(x, bits1, m2, n_cols, lt, inverse),
                    lambda: cuda_ntt.level_planar_plain(x, bits1, m2, n_cols, lt, inverse),
                    muls2 * IMAD_PER_GL_MUL, bytes2, shape, path),
        _kernel_row("base_grid", "pil2_stark_tpu_torch/csrc/ntt.cu",
                    "pil2_stark_tpu/ops/pallas_ntt.py:497", err3,
                    lambda: cuda_ntt.base_grid(z, bits2, n_cols, inverse),
                    lambda: cuda_ntt.base_grid_plain(z, bits2, n_cols, inverse),
                    muls3 * IMAD_PER_GL_MUL, bytes3, shape, path),
    ]
    for row, passes in zip(rows, planar_passes(bits, inverse).values()):
        row["passes"] = len(passes)
        row["ptxas"] = {p: _ptxas(label, "ntt") for p, label in passes.items()}
    del x, y_k, z
    torch.cuda.empty_cache()
    return rows


def _base_grid_row(device, bits, n_cols, inverse, path):
    """B3 (base_grid) as the whole transform of n_cols × 2^bits points, as
    ops/ntt.py::planar_ntt runs transforms of up to 2^BASE_BITS points (a
    single base pass, n1 = 1)."""
    import torch

    from pil2_stark_tpu_torch.ops import cuda_ntt

    n = 1 << bits
    x = random_field((n_cols * n, 1), 160 + bits + n_cols, device)
    err = max_abs_err(cuda_ntt.base_grid(x, bits, n_cols, inverse),
                      cuda_ntt.base_grid_plain(x, bits, n_cols, inverse))
    row = _kernel_row("base_grid", "pil2_stark_tpu_torch/csrc/ntt.cu",
                      "pil2_stark_tpu/ops/pallas_ntt.py:497", err,
                      lambda: cuda_ntt.base_grid(x, bits, n_cols, inverse),
                      lambda: cuda_ntt.base_grid_plain(x, bits, n_cols, inverse),
                      n_cols * n * bits / 2 * IMAD_PER_GL_MUL, 2 * n_cols * n * 8,
                      {"n_cols": n_cols, "n": n, "n1": 1, "n2": n, "inverse": inverse}, path)
    del x
    torch.cuda.empty_cache()
    return row


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
    fold_bits = LARGE_BITS - 22
    shapes = [(fold_bits, 3 << 22, True)]
    for cols in (LARGE_COLS, 2, 1):
        shapes += [(12, cols << (LARGE_BITS - 12), False), (1, cols << (LARGE_BITS - 1), False)]
    return [_b1_row(device, bits, lanes, inverse, LARGE_SETUP) for bits, lanes, inverse in shapes]


def _b1_row(device, bits, lanes, inverse, path):
    """B1 (base_rows) on a (2^bits, lanes) array against its plain version."""
    import torch

    from pil2_stark_tpu_torch.ops import cuda_ntt

    n = 1 << bits
    x = random_field((n, lanes), 200 + bits, device)
    err = max_abs_err(cuda_ntt.base_rows(x, bits, inverse),
                      cuda_ntt.base_rows_plain(x, bits, inverse))
    row = _kernel_row("base_rows", "pil2_stark_tpu_torch/csrc/ntt.cu",
                      "pil2_stark_tpu/ops/pallas_ntt.py:519", err,
                      lambda: cuda_ntt.base_rows(x, bits, inverse),
                      lambda: cuda_ntt.base_rows_plain(x, bits, inverse),
                      n * lanes * bits / 2 * IMAD_PER_GL_MUL, 2 * n * lanes * 8,
                      {"n": n, "lanes": lanes, "inverse": inverse}, path)
    if bits > 5:  # the radix regime's passes (ops/cuda_ntt.py::radix_split)
        row["ptxas"] = {p: _ptxas(label, "ntt")
                        for p, label in radix_passes(bits, inverse).items()}
    del x
    torch.cuda.empty_cache()
    return row


def _ptxas(label, lib="tac"):
    """[registers, spill stores, spill loads, stack bytes] of a kernel of
    csrc/tac.cu (or of a generated library), from its build log."""
    from pil2_stark_tpu_torch.utils import cuda_build

    hit = [e[1:] for e in ptxas_summary(cuda_build.build_log(lib)) if e[0] == label]
    return hit[0] if hit else None


def _tac_rows(device, setup_name, programs, setup=None, ranks=1):
    """T1, the kernel generated for each program, against run_plain on
    random canonical inputs of each program at the prove's size; with its
    ptxas counts and nvcc seconds from its own build, and its SASS per row
    (one trip of the grid-stride loop).  The programs of the committed
    setup `setup_name`, or of `setup` (a stark_setup result) on the path
    named `setup_name`.  With ranks > 1, at one rank's shape of a mesh: the
    extN/ranks rows of a shard with the halo its shifts read on either
    side, launched with a row base and signed shifts (the window), against
    run_plain's windowed run."""
    import torch

    from pil2_stark_tpu_torch.ops import tac_codegen, torch_tac
    from pil2_stark_tpu_torch.stark import setup as stark_setup
    from pil2_stark_tpu_torch.utils import cuda_build

    setup = setup or stark_setup.read_setup(setup_name)
    info = setup["starkInfo"]
    ss = info["starkStruct"]
    rows = []
    for k, which in enumerate(programs):
        code, dom = torch_tac.device_program(info, setup["expressionsInfo"], which)
        prog = torch_tac.compile_program(code, dom, info, ss["nBits"], ss["nBitsExt"])
        gen = tac_codegen.generate(prog)
        lib = cuda_build.add_generated(gen.source)
        window, n = None, prog.n
        if ranks > 1:
            before, after = torch_tac.halo(prog)
            window = (before, prog.n // ranks)
            n = before + window[1] + after  # the rows of the padded block
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
        got = torch_tac.run_kernel(prog, inputs, window)
        want = torch_tac.run_plain(prog, inputs, window)
        outs = [(key, got[key], want[key]) for key in ("q", "f") if key in want]
        outs += [(key, got["cm"][key], v) for key, v in want["cm"].items()]
        same = (sorted(got["cm"]) == sorted(want["cm"])
                and all(key in got for key in ("q", "f") if key in want))
        err = max([exact_err(a, b) for _, a, b in outs] + [0.0 if same else float("inf")])
        del got, want
        cost = prog.cost()
        _, launch = torch_tac.prepare_kernel(prog, inputs, window)
        rows_run = n if window is None else window[1]  # the rows computed; n are read
        row = _kernel_row(
            "tac_program", T1_SRC, "pil2_stark_tpu/ops/jax_tac.py:53", err,
            launch, lambda: torch_tac.run_plain(prog, inputs, window),
            cost["gl_muls"] * rows_run * IMAD_PER_GL_MUL,
            (cost["read_words"] * n + cost["write_words"] * rows_run) * 8,
            {"program": which, "dom": dom, "n": rows_run, "instructions": len(code["code"]),
             "live_values": prog.n_slots, "segments": len(prog.segments),
             "columns": gen.n_cols, "scalars": gen.n_scalars, **cost,
             **({} if window is None else {"window": {"base": window[0], "rows": window[1],
                                                       "padded_rows": n, "ranks": ranks}})},
            setup_name, reps=20 if n <= 1 << 22 else 5)
        sass = sass_counts(lib, "tac_seg0", [], outer=True)
        byte_ms = ((cost["read_words"] * n + cost["write_words"] * rows_run) * 8
                   / HBM_BYTES_PER_S * 1e3)
        row.update(note=XLA_FUSION, ratio=row["ms"] / row["bound_ms"], library=lib,
                   byte_bound_ms=byte_ms, ratio_to_byte_bound=row["ms"] / byte_ms,
                   # Params: n, the row base and count, the row shifts and one
                   # address per column (tac_codegen.generate refuses above
                   # MAX_PARAM_BYTES, 4 KiB)
                   param_bytes=8 * (3 + max(len(gen.shifts), 1) + gen.n_cols),
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


def _xdiv_row(device, bits, path, openings=2):
    """T2 against its plain version with random opening points (the
    proves' two by default)."""
    import numpy as np
    import torch

    from pil2_stark_tpu_torch.ops import cuda_tac
    from pil2_stark_tpu_torch.stark import device as stark_device

    n = 1 << bits
    x = random_field((n,), 400 + bits, device)
    xis = [tuple(int(v) for v in np.random.default_rng(410 + o).integers(0, P, 3, dtype=np.uint64))
           for o in range(openings)]
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


def tiled_states(words, bits, device, seed):
    """(12, 2^bits) states from 12 words: state b holds the words rotated
    by b (the first 12 states hold one word each in every element), the
    second half of the batch mixed with random u64."""
    import numpy as np

    from pil2_stark_tpu_torch.field import torch_gl as gl

    n = 1 << bits
    w = np.array(words, dtype=np.uint64)
    a = w[(np.arange(12)[:, None] + np.arange(n)[None, :]) % 12]
    a[:, :12] = w[None, :]
    rnd = np.random.default_rng(seed).integers(0, 1 << 64, size=(12, n // 2), dtype=np.uint64)
    mix = np.random.default_rng(seed + 1).random((12, n // 2)) < 0.5
    a[:, n // 2:] = np.where(mix, rnd, a[:, n // 2:])
    return gl.from_u64(a, device)


def phase_tools(device, kernel_rows):
    """X2 and X1 against their plain versions at the tools' shapes and at
    corner states, and against B4 at the prove's leaf batches; then the
    tools' entry points, whose launches are counted."""
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

    # corner states: every variant and X1 at the 12 corner words, X1 also at
    # non-canonical words (it reads any u64, as B4 does)
    n = 1 << CORNER_BITS
    for words, label in ((CORNERS, "corners"), (NON_CANONICAL, "non_canonical")):
        x = tiled_states(words, CORNER_BITS, device, 30 + len(label))
        fn = exp_stream.build_stream(n // exp_stream.BLK)
        row(x1, exact_err(fn(x), cuda_poseidon.permute_plain(x)), lambda: fn(x),
            lambda: cuda_poseidon.permute_plain(x), POSEIDON_IMAD, n,
            {"batch": n, "states": label})
        if label != "corners":
            continue
        for variant in X2_VARIANTS:
            fn = exp_poseidon.build(variant, n // 2048, 2048)
            row(x2, exact_err(fn(x), exp_poseidon.permute_variant_plain(x, variant)),
                lambda: fn(x), lambda: exp_poseidon.permute_variant_plain(x, variant),
                variant_imads(variant), n,
                {"variant": variant, "batch": n, "block": 2048, "states": label})
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
        r.update(b4_ms=b4["ms"], vs_b4=r["ms"] / b4["ms"], against="B4")
        for variant in X2_VARIANTS:
            if exp_poseidon.parse(variant).probe is not None:
                continue
            control = variant == exp_poseidon.CONTROL
            for block in (X2_B4_BLOCK, 2048) if control else (X2_B4_BLOCK,):
                fn = exp_poseidon.build(variant, n // block, block)
                r = row(x2, exact_err(fn(x), want), lambda: fn(x), None, variant_imads(variant),
                        n, {"variant": variant, "batch": n, "block": block}, **extra)
                r.update(b4_ms=b4["ms"], vs_b4=r["ms"] / b4["ms"], against="B4")
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


def vm_inputs(n, seed=VM_SEED):
    """The VM's (n // 32, 12) input states from a seed."""
    import numpy as np

    return np.random.default_rng(seed).integers(0, P, size=(n // 32, 12), dtype=np.uint64)


def machine_columns(data):
    """(fixed columns, witness columns, publics) of a committed setup's
    machine, built by the port's witness generators."""
    from pil2_stark_tpu_torch.models import fibonacci, gadgets, poseidon_vm

    n = 1 << data["nBits"]
    if data["machine"] == "all":
        return gadgets.build_all(data["references"], n)
    if data["machine"] == "poseidon_vm":
        return poseidon_vm.build(data["references"], n, vm_inputs(n))
    return fibonacci.build(data["references"], n)  # fibonacci and boundaries


def _prove_case(name, device):
    """(result, setup) of one committed setup proved on `device`."""
    from pil2_stark_tpu_torch.stark import prover, setup as stark_setup

    data = stark_setup.read_setup(name)
    const_cols, cm_cols, publics = machine_columns(data)
    setup = stark_setup.load_setup(data["starkInfo"], data["expressionsInfo"],
                                   data["verifierInfo"], const_cols.buffer, device=device)
    res = prover.prove(setup["starkInfo"], setup["expressionsInfo"], const_cols.buffer,
                       setup["constTree"], (cm_cols.buffer, publics), device=device)
    return res, setup


def fibv_challenges(seed=7):
    """One set of external challenges for both fibv airs
    (tests/test_vadcop.py::_ext_challenges, from a seed)."""
    import numpy as np

    from pil2_stark_tpu_torch.stark import setup as stark_setup

    info = stark_setup.read_setup("fibv_fibonacci")["starkInfo"]
    rng = np.random.default_rng(seed)

    def draw():
        return tuple(int(rng.integers(0, 1 << 63)) % P for _ in range(3))

    stages = [[draw() for c in info["challengesMap"] if c["stage"] == stage]
              for stage in range(1, info["nStages"] + 4)]
    fri = [draw() for _ in range(len(info["starkStruct"]["steps"]) + 1)]
    return {"stages": stages, "friSteps": fri}


def _prove_fibv(name, device, ext):
    import numpy as np

    from pil2_stark_tpu_torch.models import fibv
    from pil2_stark_tpu_torch.stark import prover, setup as stark_setup

    data = stark_setup.read_setup(name)
    fixed = np.asarray(data["fixedPols"], dtype=np.uint64)
    cm_mod, cm_fib, publics = fibv.execute(101, 1, 2)
    setup = stark_setup.load_setup(data["starkInfo"], data["expressionsInfo"],
                                   data["verifierInfo"], fixed, device=device)
    res = prover.prove(setup["starkInfo"], setup["expressionsInfo"], fixed, setup["constTree"],
                       (cm_mod if name == "fibv_module" else cm_fib, publics), device=device,
                       external_challenges=ext)
    return res, setup


def bn128_struct(**over):
    """fibonacci.STARK_STRUCT (2^6 / ext 2^9) with BN128 trees and `over`."""
    from pil2_stark_tpu_torch.models import fibonacci

    return dict(json.loads(json.dumps(fibonacci.STARK_STRUCT)), verificationHashType="BN128",
                **over)


def _prove_bn128(device, ss, counters=()):
    """fibonacci 2^6 under the BN128 stark struct `ss` compiled by the port,
    set up and proved on `device`: (setup, result, zkin, fixed-column
    uploads of the prove, [(width, height, host seconds)] of each BN128
    tree the prove built, {kernel: launches} of `counters`, zeroed just
    before the prove and read just after it)."""
    from pil2_stark_tpu_torch.hash import mh
    from pil2_stark_tpu_torch.models import fibonacci
    from pil2_stark_tpu_torch.stark import catalog, prover, setup as stark_setup
    from pil2_stark_tpu_torch.utils import proof2zkin

    pil = catalog.machine_pil("fibonacci", 6)
    const_cols, cm_cols, publics = fibonacci.build(pil["references"], 64)
    setup = stark_setup.stark_setup(const_cols.buffer, pil, ss, device=device)
    trees = []
    real_merkelize = mh.MerkleHashBN128.merkelize

    def timed_merkelize(self, cols, width, height):
        t = time.perf_counter()
        tree = real_merkelize(self, cols, width, height)
        trees.append((width, height, time.perf_counter() - t))
        return tree

    mh.MerkleHashBN128.merkelize = timed_merkelize
    for c in counters:
        c.launches = 0
    try:
        with fixed_uploads(const_cols.buffer) as uploads:
            res = prover.prove(setup["starkInfo"], setup["expressionsInfo"], const_cols.buffer,
                               setup["constTree"], (cm_cols.buffer, publics), device=device)
    finally:
        mh.MerkleHashBN128.merkelize = real_merkelize
    launches = {c.__name__: c.launches for c in counters}
    zkin = canon(proof2zkin.proof2zkin(res["proof"], setup["starkInfo"]))
    zkin["publics"] = [int(p) for p in publics]
    return setup, res, zkin, uploads[0], trees, launches


def phase_small(device):
    """Each small case proved on the card and on the CPU: identical proofs
    that verify; the fibv global constraint; debug mode on the card;
    fibonacci 2^6 with BN128 trees (plain and custom), with no upload of
    the fixed columns and the host seconds of its trees."""
    import numpy as np

    from pil2_stark_tpu_torch.models import poseidon_vm
    from pil2_stark_tpu_torch.stark import prover, setup as stark_setup, verifier

    failed = []
    for name in SMALL_SETUPS:
        t0 = time.perf_counter()
        res_gpu, s_gpu = _prove_case(name, device)
        res_cpu, _ = _prove_case(name, "cpu")
        same = (canon(res_gpu["proof"]) == canon(res_cpu["proof"])
                and res_gpu["challenges"] == res_cpu["challenges"])
        ok = verifier.verify(res_gpu["proof"], res_gpu["publics"], s_gpu["constRoot"],
                             s_gpu["starkInfo"], s_gpu["verifierInfo"])
        emit({"phase": "small", "setup": name, "n_bits": s_gpu["starkInfo"]["starkStruct"]["nBits"],
              "identical": same, "verified": ok, "seconds": time.perf_counter() - t0})
        if not (same and ok):
            failed.append(name)

    # vadcop: both fibv airs under one set of external challenges
    t0 = time.perf_counter()
    ext = fibv_challenges()
    sv = []
    for name in FIBV_AIRS:
        res_gpu, s_gpu = _prove_fibv(name, device, ext)
        res_cpu, _ = _prove_fibv(name, "cpu", ext)
        same = (canon(res_gpu["proof"]) == canon(res_cpu["proof"])
                and res_gpu["challenges"] == res_cpu["challenges"])
        ok = verifier.verify(res_gpu["proof"], res_gpu["publics"], s_gpu["constRoot"],
                             s_gpu["starkInfo"], s_gpu["verifierInfo"],
                             challenges=(res_gpu["challenges"], res_gpu["challengesFRISteps"]))
        emit({"phase": "small", "setup": name, "external_challenges": True,
              "identical": same, "verified": ok,
              "subproof_values": canon(res_gpu["proof"]["subproofValues"])})
        if not (same and ok):
            failed.append(name)
        sv.append(res_gpu["proof"]["subproofValues"])
    codes = stark_setup.read_setup("fibv_global")["constraints"]
    accepted = verifier.verify_global_constraints(codes, sv)
    changed = [[tuple((int(x) + 1) % P for x in sv[0][0])], sv[1]]
    rejected = verifier.verify_global_constraints(codes, changed)
    emit({"phase": "small", "check": "verify_global_constraints", "accepted": accepted,
          "changed_value_failures": rejected, "seconds": time.perf_counter() - t0})
    if accepted or not rejected:
        failed.append("fibv_global")

    # debug mode on the card: the VM's witness, then one flipped element
    t0 = time.perf_counter()
    debug = stark_setup.read_setup("poseidon_vm_6_debug")
    const_cols, cm_cols, _ = machine_columns(stark_setup.read_setup("poseidon_vm_6"))
    bad = cm_cols.buffer.copy()
    bad[7, 0] ^= np.uint64(1)
    errors = {}
    for label, cm in (("valid", cm_cols.buffer), ("flipped", bad)):
        errors[label] = [prover.prove(debug["starkInfo"], debug["expressionsInfo"],
                                      const_cols.buffer, None, (cm, []), debug=True, device=dev)
                         for dev in (device, "cpu")]
    final = poseidon_vm.final_states(cm_cols.buffer)
    emit({"phase": "small", "check": "debug", "setup": "poseidon_vm_6_debug",
          "card_errors_valid": errors["valid"][0], "card_errors_flipped": len(errors["flipped"][0]),
          "first_error_flipped": errors["flipped"][0][:1],
          "card_equals_cpu": errors["valid"][0] == errors["valid"][1]
          and errors["flipped"][0] == errors["flipped"][1],
          "seconds": time.perf_counter() - t0})
    if (errors["valid"][0] or not errors["flipped"][0] or errors["valid"] != [[], []]
            or errors["flipped"][0] != errors["flipped"][1] or final.shape != (2, 12)):
        failed.append("debug")

    # BN128 trees (the final recursion tier): host trees, card transforms
    for custom in (False, True):
        t0 = time.perf_counter()
        ss = bn128_struct(merkleTreeArity=16, merkleTreeCustom=custom)
        s_gpu, res_gpu, _, uploads, trees, _ = _prove_bn128(device, ss)
        s_cpu, res_cpu, *_ = _prove_bn128("cpu", ss)
        same = (canon(res_gpu["proof"]) == canon(res_cpu["proof"])
                and res_gpu["challenges"] == res_cpu["challenges"]
                and s_gpu["constRoot"] == s_cpu["constRoot"])
        ok = verifier.verify(res_gpu["proof"], res_gpu["publics"], s_gpu["constRoot"],
                             s_gpu["starkInfo"], s_gpu["verifierInfo"])
        tree_s = sum(t for _, _, t in trees)
        leaves = sum(h for _, h, _ in trees)
        emit({"phase": "small", "setup": "fibonacci_6_bn128", "merkleTreeArity": 16,
              "merkleTreeCustom": custom, "identical": same, "verified": ok,
              "fixed_uploads": uploads, "prove_s": res_gpu["timings"],
              "bn128_trees_width_height_s": trees, "bn128_tree_s": tree_s,
              "bn128_tree_s_per_1000_leaves": 1000 * tree_s / leaves,
              "seconds": time.perf_counter() - t0})
        if not (same and ok) or uploads:
            failed.append(f"fibonacci_6_bn128{'_custom' if custom else ''}")
    if failed:
        raise AssertionError(f"small: card and CPU proofs differ or a check failed: {failed}")
    return small_recursion(device)


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


@contextlib.contextmanager
def fixed_uploads(fixed):
    """Count the uploads of the fixed columns: calls of gl.from_u64 on the
    (nConstants, N) fixed columns (told from a witness section of that
    shape by their first 64 rows, so the count costs a timed prove no full
    compare); the const tree keeps them on the card (fault C3).  Yields a
    one-element list holding the count."""
    import numpy as np

    from pil2_stark_tpu_torch.field import torch_gl

    fixed_t = np.asarray(fixed).T
    count = [0]
    real_from_u64 = torch_gl.from_u64

    def counting_from_u64(a, dev=None):
        arr = np.asarray(a)
        if arr.shape == fixed_t.shape and np.array_equal(arr[:, :64], fixed_t[:, :64]):
            count[0] += 1
        return real_from_u64(a, dev)

    torch_gl.from_u64 = counting_from_u64
    try:
        yield count
    finally:
        torch_gl.from_u64 = real_from_u64


def phase_prove(device, setup_name, counters, warm=True):
    """Prove one committed setup on the card, cold then (with `warm`) warm;
    verify.  The VM's setup is compiled by the port from its PIL source and
    set up by stark_setup on the card, and must equal the committed one.
    Every prove must upload the fixed columns zero times.  Returns the cold
    prove's launches and its {proof, publics}."""
    import torch

    from pil2_stark_tpu_torch.compiler import pil1_parser
    from pil2_stark_tpu_torch.hash import poseidon_gl
    from pil2_stark_tpu_torch.models import gadgets, poseidon_vm
    from pil2_stark_tpu_torch.stark import setup as stark_setup

    data = stark_setup.read_setup(setup_name)
    compiled = {}
    if setup_name == VM_SETUP:
        # the VM's setup comes from the port's compiler, here, from its source
        t0 = time.perf_counter()
        pil = pil1_parser.compile_pil_source(poseidon_vm.pil_source(VM_N_BITS))
        pil["name"] = "PoseidonVM"
        compiled["parse_s"] = time.perf_counter() - t0
        data = dict(data, references=pil["references"])
    t0 = time.perf_counter()
    const_cols, cm_cols, publics = machine_columns(data)
    t_build = time.perf_counter() - t0
    states_ok = None
    if data["machine"] == "poseidon_vm":  # the trace's last states: the permutation
        n = 1 << data["nBits"]
        states_ok = bool((poseidon_vm.final_states(cm_cols.buffer)
                          == poseidon_gl.permute(vm_inputs(n))).all())
    t0 = time.perf_counter()
    # the VM's setup and proves take the default device, as a user's would
    prove_device = None if compiled else device
    if compiled:
        setup = stark_setup.stark_setup(const_cols.buffer, pil,
                                        gadgets.stark_struct(VM_N_BITS, VM_BITS, n_queries=32),
                                        device=prove_device)
        compiled["equals_committed"] = {
            k: json.loads(json.dumps(setup[k])) == data[k]
            for k in ("starkInfo", "expressionsInfo", "verifierInfo")}
    else:
        setup = stark_setup.load_setup(data["starkInfo"], data["expressionsInfo"],
                                       data["verifierInfo"], const_cols.buffer, device=device)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    # one all-gadgets prove: its host hints take about 100 s a prove
    res, out = prove_cold_warm(setup, const_cols.buffer, cm_cols.buffer, publics, prove_device,
                               counters, warm=warm)
    if compiled:  # the same verify on the python-int hashing the runtime replaced
        from pil2_stark_tpu_torch.runtime import native
        from pil2_stark_tpu_torch.stark import verifier

        t0 = time.perf_counter()
        with native.plain_hashing():
            out["verify_plain_ok"] = verifier.verify(
                res["proof"], res["publics"], setup["constRoot"], setup["starkInfo"],
                setup["verifierInfo"])
        out["verify_plain_s"] = time.perf_counter() - t0
        out["verify_host"] = "runtime/native.py (csrc/host/runtime.cpp)"
    library = {"proof": res["proof"], "publics": res["publics"]}
    if compiled:  # the mesh phase proves the VM again from this setup and these columns
        library.update(setup=setup, columns=(const_cols, cm_cols, publics))
    ss = data["starkInfo"]["starkStruct"]
    phase = {"all": "prove", "fibonacci": "prove_large", "poseidon_vm": "prove_vm"}
    emit({"phase": phase[data["machine"]],
          "setup": setup_name, "machine": data["machine"], "n_bits": ss["nBits"],
          "n_bits_ext": ss["nBitsExt"], "n_queries": ss["nQueries"],
          "witness_build_s": t_build, "load_setup_s": t_setup, **out,
          **({"compiled_by_port": compiled} if compiled else {}),
          "n_columns": {k: v for k, v in data["starkInfo"]["mapSectionsN"].items() if v},
          **({"final_states_equal_permute": states_ok} if states_ok is not None else {})})
    del setup, res
    torch.cuda.empty_cache()
    if states_ok is False:
        raise AssertionError(f"the {setup_name} trace is not the permutation")
    if out.get("verify_plain_ok") is False:
        raise AssertionError(f"the {setup_name} proof fails the plain host verify")
    if compiled and not all(compiled["equals_committed"].values()):
        raise AssertionError(f"the port's {setup_name} setup differs from the committed one: "
                             f"{compiled['equals_committed']}")
    check_proves(setup_name, out)
    return out["launches"], library


def prove_cold_warm(setup, fixed, witness, publics, device, counters, warm=True):
    """A cold prove (and with `warm` a warm one) of a set-up machine on
    `device`, the kernels' counters zeroed just before the cold prove and
    read just after it, the fixed-column uploads of each counted; the last
    proof verified.  Returns (the cold result, {verified, repeatable,
    cold_s, warm_s, verify_s, peak_device_bytes, phases_*, launches,
    b1_launches_by_shape, fixed_uploads_per_prove})."""
    import torch

    from pil2_stark_tpu_torch.ops import cuda_ntt
    from pil2_stark_tpu_torch.stark import prover, verifier

    def run():
        t = time.perf_counter()
        with fixed_uploads(fixed) as uploads:
            res = prover.prove(setup["starkInfo"], setup["expressionsInfo"], fixed,
                               setup["constTree"], (witness, publics), device=device)
            torch.cuda.synchronize()
        return res, time.perf_counter() - t, uploads[0]

    for c in counters:
        c.launches = 0
    cuda_ntt.base_rows.shapes.clear()  # B1's launches by (rows, lanes)
    res, cold, uploads_cold = run()
    launches = {c.__name__: c.launches for c in counters}
    b1 = {f"{n}x{lanes}": k for (n, lanes), k in sorted(cuda_ntt.base_rows.shapes.items())}
    res_warm, warm_s, uploads_warm, same = res, None, 0, None
    if warm:
        res_warm, warm_s, uploads_warm = run()
        same = canon(res["proof"]) == canon(res_warm["proof"])
    t0 = time.perf_counter()
    ok = verifier.verify(res_warm["proof"], res_warm["publics"], setup["constRoot"],
                         setup["starkInfo"], setup["verifierInfo"])
    return res, {"verified": ok, "repeatable": same, "cold_s": cold, "warm_s": warm_s,
                 "verify_s": time.perf_counter() - t0,
                 # every allocation happens inside a phase
                 "peak_device_bytes": max(res_warm["peakBytes"].values()),
                 "phases_warm_s": res_warm["timings"], "phases_cold_s": res["timings"],
                 "phases_peak_bytes": res_warm["peakBytes"], "launches": launches,
                 "b1_launches_by_shape": b1,
                 "fixed_uploads_per_prove": [uploads_cold, uploads_warm]}


def check_proves(label, out):
    """prove_cold_warm's proves verify, are repeatable, upload no fixed
    column, and launch every kernel (T1 and T2 as PROVE_LAUNCHES says)."""
    launches = out["launches"]
    zero = [k for k, v in launches.items() if v == 0]
    miscounted = {k: (launches[k], v) for k, v in PROVE_LAUNCHES.items() if launches[k] != v}
    if not out["verified"] or out["repeatable"] is False:
        raise AssertionError(f"the {label} proof does not verify or is not repeatable")
    if any(out["fixed_uploads_per_prove"]):
        raise AssertionError(f"the {label} proves uploaded the fixed columns "
                             f"{out['fixed_uploads_per_prove']} times")
    if zero or miscounted:
        raise AssertionError(f"the {label} prove: kernels never launched {zero}, launches "
                             f"(counted, expected) {miscounted}")


def proof_digest(proof) -> str:
    import hashlib

    return hashlib.sha256(json.dumps(canon(proof)).encode()).hexdigest()


def mesh_prove(mesh, setup, columns, counters, verify=True):
    """A cold and a warm prove(mesh=) of one setup: times, phases, each
    card's peak, the bytes exchanged and the fixed-column uploads of each,
    the cold prove's launches, the proof's digest, whether it verifies."""
    import torch

    from pil2_stark_tpu_torch.stark import prover, verifier

    const_cols, cm_cols, publics = columns

    def run():
        mesh.exchanged_bytes = 0
        t = time.perf_counter()
        with fixed_uploads(const_cols.buffer) as uploads:
            res = prover.prove(setup["starkInfo"], setup["expressionsInfo"], const_cols.buffer,
                               setup["constTree"], (cm_cols.buffer, publics), mesh=mesh)
            for card in mesh.local_devices():
                if card.type == "cuda":
                    torch.cuda.synchronize(card)
        return res, time.perf_counter() - t, uploads[0], mesh.exchanged_bytes

    info = setup["starkInfo"]
    ext_n = 1 << info["starkStruct"]["nBitsExt"]
    widths = [info["nConstants"]] + [info["mapSectionsN"].get(f"cm{i + 1}", 0)
                                     for i in range(info["nStages"] + 1)]
    for c in counters:
        c.launches = 0
    res, cold, uploads_cold, moved_cold = run()
    launches = {c.__name__: c.launches for c in counters}
    res_warm, warm, uploads_warm, moved_warm = run()
    digest = proof_digest(res["proof"])
    ok = None
    if verify:
        ok = bool(verifier.verify(res_warm["proof"], res_warm["publics"], setup["constRoot"],
                                  setup["starkInfo"], setup["verifierInfo"]))
    device_peaks = {}
    for per_card in res_warm["devicePeakBytes"].values():
        for card, peak in per_card.items():
            device_peaks[card] = max(device_peaks.get(card, 0), peak)
    return {"mesh": {"axes": list(mesh.axis_names), "shape": mesh.shape,
                     "ranks": [str(mesh.device(r)) for r in mesh.local_ranks],
                     "process": mesh.process_index, "processes": mesh.n_processes},
            "cold_s": cold, "warm_s": warm, "proof_sha256": digest,
            "repeatable": digest == proof_digest(res_warm["proof"]), "verified": ok,
            "phases_warm_s": res_warm["timings"], "phases_cold_s": res["timings"],
            "phases_peak_bytes_by_card": res_warm["devicePeakBytes"],
            "peak_bytes_by_card": device_peaks,
            "exchanged_bytes_per_prove": [moved_cold, moved_warm],
            "fixed_uploads_per_prove": [uploads_cold, uploads_warm], "launches": launches,
            # the bytes of extended rows each rank of this process held (its
            # rows of every tree; the most a program's halo-padded copy
            # took), beside what one device holds of the same sections
            "rank_bytes": res_warm["rankBytes"], "whole_section_bytes": 8 * ext_n * sum(widths),
            "ranks": mesh.size}


def _check_mesh_prove(label, out, want):
    """A mesh prove's proof is prove_vm's, verifies and is repeatable; it
    uploads no fixed column, exchanges something, launches every kernel
    (T1 once for the im-pols on the lead and once per rank for Q and FRI,
    T2 once per rank), and each rank holds its 1/d of the extended rows:
    no rank holds a whole extended section."""
    local = len(out["mesh"]["ranks"])
    expect = {"tac_program": 1 + 2 * local, "gl_xdiv": local}
    zero = [k for k, v in out["launches"].items() if v == 0]
    miscounted = {k: (out["launches"][k], v) for k, v in expect.items()
                  if out["launches"].get(k, v) != v}
    whole, d = out["whole_section_bytes"], out["ranks"]
    held = out["rank_bytes"]
    if any(b * d != whole for b in held["sections"]) or \
            any(b * d > whole * 1.01 for b in held["padded"]):
        raise AssertionError(f"{label}: a rank holds more than its 1/{d} of the extended rows "
                             f"({held}, {whole} B on one device)")
    if out["proof_sha256"] != want or not out["repeatable"] or out["verified"] is False:
        raise AssertionError(f"{label}: the mesh proof differs from prove_vm's, is not "
                             f"repeatable or does not verify")
    if any(out["fixed_uploads_per_prove"]):
        raise AssertionError(f"{label}: the proves uploaded the fixed columns "
                             f"{out['fixed_uploads_per_prove']} times")
    if zero or miscounted:
        raise AssertionError(f"{label}: kernels never launched {zero}, or launches (counted, "
                             f"expected) {miscounted}")
    if not all(out["exchanged_bytes_per_prove"]):
        raise AssertionError(f"{label}: the mesh prove exchanged nothing")


def phase_mesh(device, counters, vm):
    """The multi-device prover on the VM 2^20 / ext 2^23, from prove_vm's
    setup and columns: B2 and B3, T1 on the Q and FRI programs (a shard's
    rows with its halo, launched with a row base) and T2 at one rank's
    shapes of a mesh of MESH_RANKS, held against their plain versions and
    timed; prove(mesh=) on MESH_RANKS virtual ranks of this card (counters
    zeroed just before its cold prove and read just after); with two or
    more cards the same over every card in this process, and one process
    per card over NCCL (mesh_worker).  Each proof must equal prove_vm's
    byte for byte, verify, launch every kernel of the path and upload the
    fixed columns zero times, and each rank must hold its 1/d of the
    extended rows (printed per rank, with each card's peak).  A path this
    machine cannot run is named as not run.  Returns the kernel rows and
    the virtual mesh's launches."""
    import torch

    from pil2_stark_tpu_torch.parallel import distributed, ntt_sharded

    t0 = time.perf_counter()
    rows = []
    for bits, cols, inverse in VM_PLANAR:
        rows += _ntt_rows(device, bits, cols, inverse, "mesh", ranks=MESH_RANKS)
    # T1 on the VM's Q and FRI programs and T2 at one rank's rows
    rows += _tac_rows(device, "mesh", ("q", "fri"), setup=vm["setup"], ranks=MESH_RANKS)
    rows.append(_xdiv_row(device, VM_BITS - (MESH_RANKS.bit_length() - 1), "mesh"))
    for r in rows:
        emit({"phase": "mesh", **r})
    bad = [(r["name"], r["shape"]) for r in rows if r["max_abs_err"] != 0]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions at mesh shapes: {bad}")
    want = proof_digest(vm["proof"])
    paths = {}
    virtual = distributed.proof_mesh(devices=[device] * MESH_RANKS)
    setup = split_const_tree(vm["setup"], virtual)
    out = mesh_prove(virtual, setup, vm["columns"], counters)
    emit({"phase": "mesh", "path": "virtual", "setup": VM_SETUP, **out})
    _print_rank_bytes("virtual", out)
    _check_mesh_prove("virtual", out, want)
    paths["virtual"] = f"ran: {MESH_RANKS} ranks on {device}"
    launches = out["launches"]
    _profile_mesh(virtual, setup, vm["columns"])
    del setup
    torch.cuda.empty_cache()
    n_cards = torch.cuda.device_count()
    try:
        for bits in (VM_N_BITS, VM_BITS):
            ntt_sharded.check_shape(bits, n_cards)
        why_not = None if n_cards >= 2 else f"{n_cards} card"
    except ValueError as e:
        why_not = str(e)
    if why_not is None:
        cards = distributed.proof_mesh()
        setup = split_const_tree(vm["setup"], cards)
        out = mesh_prove(cards, setup, vm["columns"], counters)
        emit({"phase": "mesh", "path": "cards", "setup": VM_SETUP, **out})
        _print_rank_bytes("cards", out)
        _check_mesh_prove("cards", out, want)
        paths["cards"] = f"ran: {n_cards} cards in one process"
        del setup
        torch.cuda.empty_cache()
        paths["processes_nccl"] = _nccl_processes(n_cards, want)
    else:
        paths["cards"] = paths["processes_nccl"] = f"not run: {why_not}"
    emit({"phase": "mesh", "paths": paths, "seconds": time.perf_counter() - t0})
    return rows, launches


def split_const_tree(setup, mesh):
    """A copy of `setup` whose const tree is split over `mesh`
    (merkle_sharded.shard_tree), the one split that all the proves on that
    mesh take.  The whole tree is taken out of `setup`, so that no card
    holds it beside the split (on a virtual mesh the card would hold the
    const tree twice); once it is gone, a later split builds it again on
    the lead from the setup's fixed columns, outside any prove."""
    import torch

    from pil2_stark_tpu_torch.hash.mh import build_mh
    from pil2_stark_tpu_torch.parallel import merkle_sharded
    from pil2_stark_tpu_torch.stark import setup as stark_setup

    whole = setup.pop("constTree", None)
    if whole is None:
        ss = setup["starkInfo"]["starkStruct"]
        whole = stark_setup.const_tree(setup["fixedPols"], ss["nBits"], ss["nBitsExt"],
                                       build_mh(ss), mesh.lead)
    split = merkle_sharded.shard_tree(whole, mesh)
    del whole
    torch.cuda.empty_cache()
    return dict(setup, constTree=split)


def _print_rank_bytes(label, out):
    """One line per rank: the bytes of extended rows it holds, and each
    card's peak."""
    held = out["rank_bytes"]
    for i, (rows_b, pad_b) in enumerate(zip(held["sections"], held["padded"])):
        print(f"mesh {label} rank {out['mesh']['ranks'][i]} #{i}: {rows_b} B of extended "
              f"rows, {pad_b} B most in a halo-padded copy (one device: "
              f"{out['whole_section_bytes']} B)", flush=True)
    for card, peak in sorted(out["peak_bytes_by_card"].items()):
        print(f"mesh {label} {card}: peak {peak} B", flush=True)


def _profile_mesh(mesh, setup, columns):
    """One more warm prove(mesh=) under the profiler: the card's idle share
    over the prove and its phases, and the device's top operations."""
    import os

    import torch

    from pil2_stark_tpu_torch.stark import prover
    from pil2_stark_tpu_torch.utils import timing

    const_cols, cm_cols, publics = columns
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), PROFILE_DIR, "mesh")
    res = prover.prove(setup["starkInfo"], setup["expressionsInfo"], const_cols.buffer,
                       setup["constTree"], (cm_cols.buffer, publics), mesh=mesh,
                       profile_dir=out_dir)
    with open(res["trace"]) as f:
        trace = json.load(f)
    by_phase = {name: {"s": secs, "idle_share": timing.idle_share(trace, window=name)}
                for name, secs in res["timings"].items()
                if secs > 0.02 and not name.endswith(".upload")}
    emit({"phase": "mesh", "path": "virtual_profiled", "idle_share": timing.idle_share(trace),
          "phases_s": res["timings"], "idle_share_by_phase": by_phase,
          "device": device_ops(trace)})
    del res, trace
    torch.cuda.empty_cache()


def _nccl_processes(n_cards, want):
    """One process per card (mesh_worker), wired by NCCL: each must end
    with prove_vm's proof."""
    import os
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    # each worker's output into a file of its own (under the checkout,
    # gitignored): a full pipe would stall a worker inside a collective
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), MESH_DIR)
    os.makedirs(out_dir, exist_ok=True)
    logs = [(open(os.path.join(out_dir, f"worker{r}.out"), "w+"),
             open(os.path.join(out_dir, f"worker{r}.err"), "w+")) for r in range(n_cards)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mesh-worker", str(r),
                               str(n_cards), str(port)], stdout=out, stderr=err)
             for r, (out, err) in enumerate(logs)]
    outs = []
    try:
        for p in procs:
            p.wait(timeout=600)
        for out, err in logs:
            out.seek(0)
            err.seek(0)
            outs.append((out.read(), err.read()))
    finally:
        for p in procs:
            p.kill()
            p.wait()
        for out, err in logs:
            out.close()
            err.close()
    for rank, ((stdout, stderr), p) in enumerate(zip(outs, procs)):
        lines = [json.loads(ln) for ln in stdout.splitlines() if ln.startswith("{")]
        if p.returncode != 0 or not lines:
            raise AssertionError(f"mesh worker {rank} failed (exit {p.returncode}): "
                                 f"{stderr[-3000:]}")
        emit({"phase": "mesh", "path": "processes_nccl", **lines[-1]})
        _print_rank_bytes(f"NCCL process {rank}", lines[-1])
        _check_mesh_prove(f"NCCL process {rank}", lines[-1], want)
    return f"ran: {n_cards} processes, one card each, NCCL"


def mesh_worker(rank, world, port):
    """One process of the NCCL mesh: the VM's setup compiled on its card,
    its const tree split to this process's rank (the whole one dropped),
    prove(mesh=) over every process's card, one JSON line."""
    import torch

    from pil2_stark_tpu_torch.compiler import pil1_parser
    from pil2_stark_tpu_torch.models import gadgets, poseidon_vm
    from pil2_stark_tpu_torch.parallel import distributed
    from pil2_stark_tpu_torch.stark import setup as stark_setup

    rank, world = int(rank), int(world)
    distributed.init_distributed(f"localhost:{port}", world, rank, backend="nccl")
    try:
        data = stark_setup.read_setup(VM_SETUP)
        pil = pil1_parser.compile_pil_source(poseidon_vm.pil_source(VM_N_BITS))
        pil["name"] = "PoseidonVM"
        columns = machine_columns(dict(data, references=pil["references"]))
        setup = stark_setup.stark_setup(
            columns[0].buffer, pil, gadgets.stark_struct(VM_N_BITS, VM_BITS, n_queries=32))
        mesh = distributed.proof_mesh()
        # this process keeps its rank's rows of the const tree, not the whole
        setup = split_const_tree(setup, mesh)
        out = mesh_prove(mesh, setup, columns, prove_counters(), verify=rank == 0)
        emit({"rank": rank, "card": str(torch.cuda.current_device()), **out})
    finally:
        torch.distributed.destroy_process_group()
    return 0


CLI_DIR = "pil2_stark_tpu_torch/_build/cli"  # under the checkout, gitignored; removed after


def _cli_runs(jobs, cwd):
    """python -m pil2_stark_tpu_torch <args> for each {name: args} of jobs,
    each in a fresh process, all at once: {name: (exit code, seconds, last
    line of its output)}.  Every process is ended before this returns."""
    started = {}
    try:
        for name, args in jobs.items():
            started[name] = (time.perf_counter(), subprocess.Popen(
                [sys.executable, "-m", "pil2_stark_tpu_torch", *args], cwd=cwd,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        out = {}
        for name, (t0, proc) in started.items():
            text, _ = proc.communicate(timeout=300)
            lines = text.strip().splitlines()
            out[name] = (proc.returncode, time.perf_counter() - t0, lines[-1] if lines else "")
        return out
    finally:
        for _, proc in started.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _verify_args(d, proof=None, publics=None):
    """`verify` of the files `prove` wrote to d."""
    return ["verify", "--proof", proof or f"{d}/proof.json",
            "--publics", publics or f"{d}/publics.json", "--verkey", f"{d}/verkey.json",
            "--starkinfo", f"{d}/starkinfo.json", "--verifierinfo", f"{d}/verifierinfo.json"]


def phase_cli(device, counters, library):
    """The port's CLI on the VM 2^20 / ext 2^23, with prove_vm's inputs:
    `prove` from files in this process (every kernel of the path launched,
    T1 three times and T2 once; the fixed columns uploaded once, by the
    setup, and never by the prove; proof.json equal to prove_vm's library
    proof), `verify` in a fresh process (exit 0, and 1 with one evaluation
    of the proof changed: the VM has no publics), `buildconsttree` from a
    PSTC container of the fixed columns (its verkey the prove's; read_tree's
    root that root; four random rows equal to the card's LDE),
    `genstarkinfo` from the VM's PIL source (equal to the committed
    starkInfo); then, in fresh processes on the default device, `prove
    --model fibonacci --nbits 6` and `verify` (exit 0, and 1 with one
    public changed)."""
    import os
    import shutil

    import numpy as np
    import torch

    from pil2_stark_tpu_torch import __main__ as cli
    from pil2_stark_tpu_torch.compiler import pil1_parser
    from pil2_stark_tpu_torch.field import torch_gl
    from pil2_stark_tpu_torch.hash import merkle
    from pil2_stark_tpu_torch.models import gadgets, poseidon_vm
    from pil2_stark_tpu_torch.ops import ntt
    from pil2_stark_tpu_torch.stark import prover, setup as stark_setup
    from pil2_stark_tpu_torch.utils import serialization

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    d = os.path.join(root, CLI_DIR)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    free_before = shutil.disk_usage(d).free
    emit({"phase": "cli", "free_disk_bytes": free_before})
    secs, checks, lines = {}, {}, {}
    try:
        data = stark_setup.read_setup(VM_SETUP)
        pil = pil1_parser.compile_pil_source(poseidon_vm.pil_source(VM_N_BITS))
        pil["name"] = "PoseidonVM"
        const_cols, cm_cols, publics = machine_columns(dict(data, references=pil["references"]))
        f = {k: os.path.join(d, v) for k, v in (
            ("pil", "pil.json"), ("ss", "ss.json"), ("const", "const.npy"),
            ("commit", "commit.npy"), ("publics", "publics.json"), ("out", "out"),
            ("pstc", "consts_in.bin"), ("tree", "tree"), ("source", "PoseidonVM.pil"),
            ("si", "starkinfo.json"), ("library", "library_proof.json"),
            ("bad_proof", "bad_proof.json"), ("bad_publics", "bad_publics.json"),
            ("fib", "fib"))}
        serialization.dump_json(pil, f["pil"])
        serialization.dump_json(gadgets.stark_struct(VM_N_BITS, VM_BITS, n_queries=32), f["ss"])
        np.save(f["const"], const_cols.buffer)
        np.save(f["commit"], cm_cols.buffer)
        serialization.dump_json([str(int(x)) for x in publics], f["publics"])

        # prove, in this process, its launches and uploads counted
        real_prove, prove_uploads, prove_s = prover.prove, [], []

        def counted_prove(*args, **kwargs):
            with fixed_uploads(const_cols.buffer) as n:
                t = time.perf_counter()
                res = real_prove(*args, **kwargs)
                torch.cuda.synchronize()
                prove_s.append(time.perf_counter() - t)
            prove_uploads.append(n[0])
            return res

        for c in counters:
            c.launches = 0
        prover.prove = counted_prove
        try:
            with fixed_uploads(const_cols.buffer) as all_uploads:
                t0 = time.perf_counter()
                cli.main(["prove", "--pil-json", f["pil"], "--const", f["const"],
                          "--commit", f["commit"], "--publics", f["publics"],
                          "--starkstruct", f["ss"], "--tmp", f["out"]])
                secs["prove"] = time.perf_counter() - t0
        finally:
            prover.prove = real_prove
        launches = {c.__name__: c.launches for c in counters}
        serialization.dump_proof(library["proof"], f["library"])
        with open(os.path.join(f["out"], "proof.json"), "rb") as a, open(f["library"], "rb") as b:
            checks["proof_equals_library"] = a.read() == b.read()
        uploads = [all_uploads[0] - sum(prove_uploads)] + prove_uploads
        checks["fixed_uploads_once_by_the_setup"] = uploads == [1, 0]

        out = f["out"]
        # buildconsttree from a PSTC container of the fixed columns
        serialization.write_const_file(f["pstc"], const_cols.buffer)
        os.makedirs(f["tree"])
        tree_files = {k: os.path.join(f["tree"], k) for k in
                      ("consttree.bin", "verkey.json", "consts.bin")}
        t0 = time.perf_counter()
        cli.main(["buildconsttree", "--const-file", f["pstc"], "--starkstruct", f["ss"],
                  "--consttree", tree_files["consttree.bin"],
                  "--verkey", tree_files["verkey.json"],
                  "--constsfile", tree_files["consts.bin"]])
        secs["buildconsttree"] = time.perf_counter() - t0
        written = {k: os.path.getsize(v) for k, v in tree_files.items()}
        with open(tree_files["verkey.json"], "rb") as a, \
                open(f"{out}/verkey.json", "rb") as b:
            checks["verkey_equals_prove"] = a.read() == b.read()
        t0 = time.perf_counter()
        tree = merkle.read_tree(tree_files["consttree.bin"])
        secs["read_tree"] = time.perf_counter() - t0
        prove_root = serialization.load_verkey(f"{out}/verkey.json")
        checks["read_tree_root_equals_prove"] = [int(x) for x in tree.root] == prove_root
        rows = np.random.default_rng(VM_SEED).integers(0, 1 << VM_BITS, size=4)
        card_ext = ntt.lde_planar(torch_gl.from_u64(np.ascontiguousarray(const_cols.buffer.T),
                                                    device), VM_N_BITS, VM_BITS)
        card_rows = torch_gl.to_u64(card_ext[:, torch.as_tensor(rows, device=device)].T)
        consts_ext = np.memmap(tree_files["consts.bin"], dtype="<u8", mode="r",
                               offset=written["consts.bin"] - card_ext.numel() * 8,
                               shape=(1 << VM_BITS, card_ext.shape[0]))
        checks["rows_equal_card_lde"] = bool(np.array_equal(tree.elements[rows], card_rows)
                                             and np.array_equal(consts_ext[rows], card_rows))
        del tree, card_ext, consts_ext

        # genstarkinfo from the VM's PIL source
        with open(f["source"], "w") as src:
            src.write(poseidon_vm.pil_source(VM_N_BITS))
        t0 = time.perf_counter()
        cli.main(["genstarkinfo", "--pil", f["source"], "--starkstruct", f["ss"],
                  "--starkinfo", f["si"], "--expressionsinfo", os.path.join(d, "ei.json"),
                  "--verifierinfo", os.path.join(d, "vi.json")])
        secs["genstarkinfo"] = time.perf_counter() - t0
        checks["genstarkinfo_equals_committed"] = (serialization.load_json(f["si"])
                                                   == data["starkInfo"])

        # fresh processes, run side by side (their seconds overlap): the VM's
        # verify, accepted and refused with one evaluation changed (the VM
        # has no publics to change), and the module's own entry point on the
        # default device, fibonacci 2^6, then its verify, accepted and
        # refused with one public changed
        bad = serialization.load_json(f"{out}/proof.json")
        bad["evals"][0][0] = str((int(bad["evals"][0][0]) + 1) % P)
        serialization.dump_json(bad, f["bad_proof"])
        fib = f["fib"]
        runs = _cli_runs({
            "verify": _verify_args(out),
            "verify_changed_eval": _verify_args(out, proof=f["bad_proof"]),
            "fresh_prove_fibonacci_6": ["prove", "--model", "fibonacci", "--nbits", "6",
                                        "--tmp", fib]}, root)
        if runs["fresh_prove_fibonacci_6"][0] == 0:
            pubs = serialization.load_json(f"{fib}/publics.json")
            serialization.dump_json([str((int(pubs[0]) + 1) % P)] + pubs[1:], f["bad_publics"])
            runs.update(_cli_runs({
                "fresh_verify_fibonacci_6": _verify_args(fib),
                "fresh_verify_changed_public": _verify_args(fib, publics=f["bad_publics"])},
                root))
        for name, (code, sec, line) in runs.items():
            secs[name], lines[name] = sec, line
            want = 1 if "changed" in name else 0
            checks[f"{name}_exits_{want}"] = code == want
        checks["fresh_verify_fibonacci_6_ran"] = "fresh_verify_fibonacci_6" in runs
    finally:
        shutil.rmtree(d, ignore_errors=True)
    emit({"phase": "cli", "seconds": time.perf_counter() - t_phase, "subcommand_s": secs,
          "prove_call_s": prove_s, "bytes_written": written, "launches": launches,
          "fixed_uploads_setup_prove": uploads, "checks": checks, "last_lines": lines})
    failed = [k for k, v in checks.items() if not v]
    zero = [k for k, v in launches.items() if v == 0]
    miscounted = {k: launches[k] for k, v in PROVE_LAUNCHES.items() if launches.get(k) != v}
    if failed or zero or miscounted:
        raise AssertionError(f"cli: checks failed {failed}, kernels never launched {zero}, "
                             f"launches off {miscounted}")
    return launches


def cli_recursion(device, counters, library):
    """The smallest chain through the port's CLI (python -m
    pil2_stark_tpu_torch, in this process, on the default device), its
    files under the gitignored CLI_DIR (removed after): `prove --model
    fibonacci --nbits 4` under SMALL_CHAIN, `pil2circom`, `compressor-setup
    --cols 12`, `compressor-exec`, then `prove --pil-json/--const/--commit/
    --publics` of the C12 (launches counted; the proof must equal
    small_recursion's library proof) and `verify` in a fresh process (exit
    0); then `buildchelpers` on the VM 2^20 / ext 2^23, read back.  Returns
    the C12 prove's launches."""
    import os
    import shutil

    from pil2_stark_tpu_torch import __main__ as cli
    from pil2_stark_tpu_torch.compiler import chelpers_bin
    from pil2_stark_tpu_torch.models import gadgets, poseidon_vm
    from pil2_stark_tpu_torch.ops import ntt
    from pil2_stark_tpu_torch.utils import serialization

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    d = os.path.join(root, CLI_DIR, "recursion")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    f = {k: os.path.join(d, v) for k, v in (
        ("inner_ss", "inner_ss.json"), ("fib", "fib"), ("circuit", "circuit"), ("c12", "c12"),
        ("c12_ss", "c12_ss.json"), ("out", "c12_out"), ("library", "library_proof.json"),
        ("vm_source", "PoseidonVM.pil"), ("vm_ss", "vm_ss.json"),
        ("chelpers", "vm.chelpers.bin"))}
    secs, checks = {}, {}
    try:
        serialization.dump_json(SMALL_CHAIN, f["inner_ss"])
        serialization.dump_json(library["ss"], f["c12_ss"])
        c12 = f["c12"]
        steps = [
            ("prove_inner", ["prove", "--model", "fibonacci", "--nbits", "4", "--starkstruct",
                             f["inner_ss"], "--tmp", f["fib"]]),
            ("pil2circom", ["pil2circom", "--starkinfo", f"{f['fib']}/starkinfo.json",
                            "--verifierinfo", f"{f['fib']}/verifierinfo.json",
                            "--verkey", f"{f['fib']}/verkey.json", "-o", f["circuit"]]),
            ("compressor-setup", ["compressor-setup", "--circom-dir", f["circuit"], "--inputs",
                                  f"{f['fib']}/zkin.json", "--out-prefix", c12, "--cols", "12"]),
            ("compressor-exec", ["compressor-exec", "--exec", f"{c12}.exec", "--wtns",
                                 f"{c12}.wtns.json", "--meta", f"{c12}.meta.json",
                                 "--commit", f"{c12}.commit.npy", "--publics",
                                 f"{c12}.publics.json"]),
            ("prove_c12", ["prove", "--pil-json", f"{c12}.pil.json", "--const",
                           f"{c12}.const.npy", "--commit", f"{c12}.commit.npy", "--publics",
                           f"{c12}.publics.json", "--starkstruct", f["c12_ss"],
                           "--tmp", f["out"]]),
        ]
        for name, argv in steps:
            if name == "prove_c12":
                for c in counters:
                    c.launches = 0
            t0 = time.perf_counter()
            cli.main(argv)
            secs[name] = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
        # transforms of up to 2^12 points are one B3 pass (ops/ntt.py::planar_ntt)
        off_path = {"level_planar"} if ntt.split_bits(library["ss"]["nBitsExt"]) == 0 else set()
        serialization.dump_proof(library["proof"], f["library"])
        with open(os.path.join(f["out"], "proof.json"), "rb") as a, \
                open(f["library"], "rb") as b:
            checks["c12_proof_equals_library"] = a.read() == b.read()
        runs = _cli_runs({"verify_c12": _verify_args(f["out"])}, root)
        code, secs["verify_c12"], last = runs["verify_c12"]
        checks["verify_c12_exits_0"] = code == 0

        # buildchelpers on the VM 2^20
        with open(f["vm_source"], "w") as src:
            src.write(poseidon_vm.pil_source(VM_N_BITS))
        serialization.dump_json(gadgets.stark_struct(VM_N_BITS, VM_BITS, n_queries=32), f["vm_ss"])
        t0 = time.perf_counter()
        cli.main(["buildchelpers", "--pil", f["vm_source"], "--starkstruct", f["vm_ss"],
                  "--chelpers", f["chelpers"]])
        secs["buildchelpers"] = time.perf_counter() - t0
        back = chelpers_bin.read_chelpers_file(f["chelpers"])
        chelpers = {"bytes": os.path.getsize(f["chelpers"]),
                    "expressions": len(back["expsInfo"]), "im_pols": len(back["imPolsInfo"])}
        checks["chelpers_read_back"] = chelpers["expressions"] > 0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    emit({"phase": "cli", "chain": "recursion", "seconds": time.perf_counter() - t_phase,
          "subcommand_s": secs, "launches": launches, "not_on_path": sorted(off_path),
          "checks": checks, "chelpers": chelpers, "verify_last_line": last})
    failed = [k for k, v in checks.items() if not v]
    zero = [k for k, v in launches.items() if v == 0 and k not in off_path]
    miscounted = {k: launches[k] for k, v in PROVE_LAUNCHES.items() if launches.get(k) != v}
    if failed or zero or miscounted:
        raise AssertionError(f"cli recursion: checks failed {failed}, kernels never launched "
                             f"{zero}, launches off {miscounted}")
    return launches


def device_ops(trace, top=12) -> dict:
    """Device time by operation in a torch.profiler Chrome trace: the
    `top` kernels by total time, and the memcpy/memset totals (us)."""
    from pil2_stark_tpu_torch.utils import timing

    by_name, other = {}, {}
    for e in trace["traceEvents"]:
        cat = e.get("cat")
        if e.get("ph") != "X" or cat not in timing.DEVICE_CATEGORIES:
            continue
        if cat == "kernel":
            t = by_name.setdefault(e["name"][:120], [0.0, 0])
            t[0] += float(e["dur"])
            t[1] += 1
        else:
            other[cat] = other.get(cat, 0.0) + float(e["dur"])
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {"kernels_us": [[name, us, count] for name, (us, count) in ranked[:top]],
            "kernel_total_us": sum(v[0] for v in by_name.values()),
            "kernel_launches": sum(v[1] for v in by_name.values()), "other_us": other}


def phase_profile(device, names):
    """One warm prove of each setup under prove(profile_dir=): the card's
    idle share over the prove and over its phases, and the device's top
    operations by time."""
    import os

    import torch

    from pil2_stark_tpu_torch.stark import prover, setup as stark_setup
    from pil2_stark_tpu_torch.utils import timing

    for name in names:
        data = stark_setup.read_setup(name)
        const_cols, cm_cols, publics = machine_columns(data)
        setup = stark_setup.load_setup(data["starkInfo"], data["expressionsInfo"],
                                       data["verifierInfo"], const_cols.buffer, device=device)
        args = (setup["starkInfo"], setup["expressionsInfo"], const_cols.buffer,
                setup["constTree"], (cm_cols.buffer, publics))
        t0 = time.perf_counter()
        prover.prove(*args, device=device)  # warm, and its time without the profiler
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
        t0 = time.perf_counter()
        out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), PROFILE_DIR, name)
        res = prover.prove(*args, device=device, profile_dir=out_dir)
        t_prove = time.perf_counter() - t0
        with open(res["trace"]) as f:
            trace = json.load(f)
        idle = timing.idle_share(trace)
        # the profiler slows the host, not the card: the device's busy time
        # over the same prove without the profiler bounds its idle share below
        span = next(e for e in trace["traceEvents"] if e.get("name") == "prove"
                    and e.get("cat") in ("user_annotation", "cpu_op"))
        busy_s = (1.0 - idle) * float(span["dur"]) * 1e-6
        by_phase = {}
        for phase_name, secs in res["timings"].items():
            if secs > 0.02 and not phase_name.endswith(".upload"):
                by_phase[phase_name] = {"s": secs, "idle_share": timing.idle_share(
                    trace, window=phase_name)}
        emit({"phase": "profile", "setup": name, "idle_share": idle,
              "device_busy_s": busy_s, "prove_window_s": float(span["dur"]) * 1e-6,
              "warm_prove_s": t_plain, "idle_share_unprofiled": 1.0 - busy_s / t_plain,
              "profiled_prove_s": t_prove, "phases_s": res["timings"],
              "idle_share_by_phase": by_phase, "device": device_ops(trace),
              "trace_bytes": os.path.getsize(res["trace"])})
        del setup, res, trace
        torch.cuda.empty_cache()
        if not 0.0 <= idle < 1.0:
            raise AssertionError(f"{name}: no device activity in the profiled prove")


# ---------------------------------------------------------------------------
# the Goldilocks recursion tier: a proof verified inside a C12 / C18 machine


def recursion_struct(n_bits, n_queries):
    """A recursive machine's starkStruct: blowup 2, FRI steps of 4 bits
    down to 2^4 or less."""
    return {"nBits": n_bits, "nBitsExt": n_bits + 1, "nQueries": n_queries,
            "verificationHashType": "GL",
            "steps": [{"nBits": b} for b in range(n_bits + 1, 0, -4)]}


def inner_struct():
    """LARGE_SETUP's starkStruct without its FRI steps of fewer bits than
    the blowup: the circuit of either package demands a zero final
    polynomial there, where the verifier lets a constant through
    (pil2circom.py gen_verify_final_pol; ROADMAP hazard 8)."""
    from pil2_stark_tpu_torch.stark import setup as stark_setup

    ss = json.loads(json.dumps(stark_setup.read_setup(LARGE_SETUP)["starkInfo"]["starkStruct"]))
    ss["steps"] = [s for s in ss["steps"] if s["nBits"] >= ss["nBitsExt"] - ss["nBits"]]
    return ss


def fibonacci_proof(n_bits, ss, device, inputs=(1, 2)):
    """(setup, result, zkin) of the fibonacci machine at 2^n_bits rows under
    ss, compiled by the port, set up and proved on `device`; the zkin
    carries the publics."""
    from pil2_stark_tpu_torch.compiler import pil1_parser
    from pil2_stark_tpu_torch.models import fibonacci
    from pil2_stark_tpu_torch.stark import prover, setup as stark_setup
    from pil2_stark_tpu_torch.utils import proof2zkin

    pil = pil1_parser.compile_pil_source(fibonacci.pil_source(n_bits))
    pil["name"] = "Fibonacci"
    const_cols, cm_cols, publics = fibonacci.build(pil["references"], 1 << n_bits, list(inputs))
    s = stark_setup.stark_setup(const_cols.buffer, pil, json.loads(json.dumps(ss)), device=device)
    res = prover.prove(s["starkInfo"], s["expressionsInfo"], const_cols.buffer, s["constTree"],
                       (cm_cols.buffer, publics), device=device)
    zkin = canon(proof2zkin.proof2zkin(res["proof"], s["starkInfo"]))
    zkin["publics"] = [int(p) for p in publics]
    return s, res, zkin


def compress(files, entry, zkin, cols=(12, 18)):
    """The port's circom front-end on a circuit and its inputs, check(),
    then a compressor machine of it for each of `cols`: (stats, {cols:
    {pil, const, cm, publics, n_bits, bad_row, setup_s, exec_s}}).
    bad_row is a row whose wire 3 a custom gate uses (the corrupted wire
    of tests/test_compressor12.py:63)."""
    import collections

    import numpy as np

    from pil2_stark_tpu_torch.compiler import circom_front, compressor12, compressor18

    t0 = time.perf_counter()
    cc = circom_front.compile_and_witness(files, entry, zkin)
    front_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if not cc.check():
        raise AssertionError(f"{entry}: the circuit's constraints fail on its inputs")
    check_s = time.perf_counter() - t0
    template = {i: g["template"] for i, g in enumerate(cc.custom_gates)}
    stats = {"entry": entry, "signals": cc.n_vars, "constraints": len(cc.constraints),
             "custom_gate_uses": dict(collections.Counter(template[u["id"]]
                                                          for u in cc.custom_uses)),
             "n_publics": cc.n_outputs + cc.n_pub_inputs, "front_end_s": front_s,
             "check_s": check_s}
    machines = {}
    for c in cols:
        mod = compressor12 if c == 12 else compressor18
        t0 = time.perf_counter()
        s = mod.setup(cc)
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cm = mod.exec_witness(cc.witness, s["plonkAdditions"], s["sMap"], s["nBits"])
        exec_s = time.perf_counter() - t0
        machines[c] = {"pil": s["pil"], "const": s["constBuffer"], "cm": cm,
                       "publics": [int(x) for x in cc.witness[1:1 + s["nPublics"]]],
                       "n_bits": s["nBits"], "setup_s": setup_s, "exec_s": exec_s,
                       "bad_row": int(np.argmax(s["sMap"][3][s["nPublics"] // 12 + 1:])) + 1}
    return stats, machines


@contextlib.contextmanager
def one_thread():
    """torch's multi-threaded int64 ops on small CPU tensors are slow: the
    CPU proves of the recursion machines run on one thread."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _prove_small_machine(m, ss, device):
    """(setup, result) of a small recursion machine set up and proved on
    `device`."""
    from pil2_stark_tpu_torch.stark import prover, setup as stark_setup

    s = stark_setup.stark_setup(m["const"], m["pil"], json.loads(json.dumps(ss)), device=device)
    res = prover.prove(s["starkInfo"], s["expressionsInfo"], m["const"], s["constTree"],
                       (m["cm"], m["publics"]), device=device)
    return s, res


def small_recursion(device):
    """The smallest chain of the recursion tier, on the card and on the CPU:
    fibonacci 2^4 / ext 2^7 with 2 queries (equal proofs), its verifier
    circuit through the port's front-end, the C12 and C18 machines of it
    (blowup 2, SMALL_QUERIES queries), and the C12 of the vadcop Aggregate2
    circuit of two such proofs; each machine's card proof must equal the
    CPU's byte for byte and verify.  Returns the library C12 proof and its
    struct for the cli phase."""
    from pil2_stark_tpu_torch.compiler import pil2circom, vadcop
    from pil2_stark_tpu_torch.stark import verifier

    REC_BUILD.wait()
    failed = []
    t0 = time.perf_counter()
    inner = {}
    for dev in (device, "cpu"):
        with one_thread():
            inner[dev] = fibonacci_proof(4, SMALL_CHAIN, dev)
    s, res, zkin = inner[device]
    same = canon(res["proof"]) == canon(inner["cpu"][1]["proof"])
    root = [int(v) for v in s["constRoot"]]
    _, _, zkin_b = fibonacci_proof(4, SMALL_CHAIN, device, inputs=(3, 5))
    emit({"phase": "small", "recursion": "inner", "setup": "fibonacci 2^4 / ext 2^7",
          "identical": same, "seconds": time.perf_counter() - t0})
    if not same:
        failed.append("inner")
    jobs = [("verifier", pil2circom.emit_circuit_files(root, s["starkInfo"], s["verifierInfo"]),
             "verifier.circom", zkin, (12, 18)),
            ("aggregate2", vadcop.emit_aggregation_files(root, s["starkInfo"], s["verifierInfo"]),
             "aggregate2.circom", vadcop.aggregate2_zkin(zkin, zkin_b, [0, 0, 0, 0], [root]),
             (12,))]
    library = None
    for label, files, entry, inputs, cols in jobs:
        stats, machines = compress(files, entry, inputs, cols)
        if label == "aggregate2" and machines[12]["publics"] != zkin["publics"] + zkin_b["publics"]:
            failed.append("aggregate2 publics")
        for c, m in machines.items():
            t0 = time.perf_counter()
            ss = recursion_struct(m["n_bits"], SMALL_QUERIES)
            s_gpu, r_gpu = _prove_small_machine(m, ss, device)
            with one_thread():
                s_cpu, r_cpu = _prove_small_machine(m, ss, "cpu")
            same = (canon(r_gpu["proof"]) == canon(r_cpu["proof"])
                    and canon(s_gpu["constRoot"]) == canon(s_cpu["constRoot"]))
            ok = verifier.verify(r_gpu["proof"], r_gpu["publics"], s_gpu["constRoot"],
                                 s_gpu["starkInfo"], s_gpu["verifierInfo"])
            emit({"phase": "small", "recursion": f"{label} C{c}", **stats, "n_bits": m["n_bits"],
                  "n_columns": {k: v for k, v in s_gpu["starkInfo"]["mapSectionsN"].items() if v},
                  "q_deg": s_gpu["starkInfo"]["qDeg"], "stark_struct": ss,
                  "identical": same, "verified": ok, "seconds": time.perf_counter() - t0})
            if not (same and ok):
                failed.append(f"{label} C{c}")
            if label == "verifier" and c == 12:
                library = {"ss": ss, "proof": r_gpu["proof"], "publics": r_gpu["publics"]}
    if failed:
        raise AssertionError(f"small recursion: card and CPU differ or a check failed: {failed}")
    return library


def recursion_worker(d):
    """The host half of the recursion path, in a process of its own while
    the card's other phases go on: pil2circom on the inner proof's setup,
    the circom front-end on its zkin and check(), then the C12 and C18
    machines, pickled to d/chain.pkl, with one JSON line of stats (the
    peak RSS up to here among them); then a debug prove on the default
    device of the C12's witness with one corrupted wire, which must find
    errors (its constraint check runs on the host for minutes), and a
    second JSON line with them."""
    import os
    import pickle
    import resource

    from pil2_stark_tpu_torch.compiler import pil2circom

    with open(os.path.join(d, "inner.json")) as f:
        inner = json.load(f)
    t0 = time.perf_counter()
    files = pil2circom.emit_circuit_files(inner["constRoot"], inner["starkInfo"],
                                          inner["verifierInfo"])
    p2c_s = time.perf_counter() - t0
    stats, machines = compress(files, "verifier.circom", inner["zkin"])
    stats.update(pil2circom_s=p2c_s, circuit_bytes=sum(len(t) for t in files.values()),
                 compressor={c: {k: m[k] for k in ("n_bits", "setup_s", "exec_s", "bad_row")}
                             for c, m in machines.items()},
                 peak_rss_bytes=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024)
    with open(os.path.join(d, "chain.pkl"), "wb") as f:
        pickle.dump({"stats": stats, "machines": machines}, f, protocol=4)
    emit(stats)

    from pil2_stark_tpu_torch.compiler import pilinfo
    from pil2_stark_tpu_torch.stark import prover

    m = machines[12]
    t0 = time.perf_counter()
    dbg = pilinfo.pil_info(m["pil"], True, {}, {"debug": True})
    bad = m["cm"].copy()
    bad[m["bad_row"], 3] = (int(bad[m["bad_row"], 3]) + 1) % P
    errors = prover.prove(dbg["pilInfo"], dbg["expressionsInfo"], m["const"], None,
                          (bad, m["publics"]), debug=True, device=None)
    emit({"debug": {"machine": "C12", "row": m["bad_row"], "column": 3,
                    "corrupted_wire_errors": len(errors), "first_error": errors[:1],
                    "debug_s": time.perf_counter() - t0}})
    return 0


def start_recursion(device):
    """The recursion path's inner proof on the card: fibonacci 2^22 / ext
    2^25 with 32 queries (inner_struct), compiled by the port and set up
    and proved on the default device, verified; then the host half of the
    chain (recursion_worker) starts in a process of its own.  Returns the
    running worker."""
    import os
    import shutil

    import torch

    from pil2_stark_tpu_torch.stark import verifier

    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), RECURSION_DIR)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    t0 = time.perf_counter()
    s, res, zkin = fibonacci_proof(LARGE_N_BITS, inner_struct(), None)
    torch.cuda.synchronize()
    setup_prove_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ok = verifier.verify(res["proof"], res["publics"], s["constRoot"], s["starkInfo"],
                         s["verifierInfo"])
    verify_s = time.perf_counter() - t0
    with open(os.path.join(d, "inner.json"), "w") as f:
        json.dump({"constRoot": [int(v) for v in s["constRoot"]], "starkInfo": s["starkInfo"],
                   "verifierInfo": s["verifierInfo"], "zkin": zkin}, f)
    ss = s["starkInfo"]["starkStruct"]
    emit({"phase": "recursion", "step": "inner", "machine": "fibonacci", "n_bits": ss["nBits"],
          "n_bits_ext": ss["nBitsExt"], "n_queries": ss["nQueries"],
          "fri_steps": [st["nBits"] for st in ss["steps"]], "publics": zkin["publics"],
          "verified": ok, "setup_and_prove_s": setup_prove_s, "prove_phases_s": res["timings"],
          "verify_s": verify_s})
    del s, res
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("the recursion path's inner proof does not verify")
    logs = (open(os.path.join(d, "worker.out"), "w+"), open(os.path.join(d, "worker.err"), "w+"))
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--recursion-worker", d],
                            stdout=logs[0], stderr=logs[1])
    WORKERS.append(proc)
    return {"proc": proc, "dir": d, "logs": logs, "started": time.perf_counter()}


def phase_recursion(device, counters, started):
    """The recursion path at size: the C12 and C18 machines whose circuit
    verifies the inner proof (recursion_worker's output), compiled by the
    port's pil_info under recursion_struct(n, RECURSION_QUERIES), their six
    T1 programs already built (RecursionBuild), set up on the default device
    (stark_setup = this compile + load_setup); each kernel of the path held
    against its plain version at the machines' shapes; the C12 proved cold
    and warm, then once more under the profiler (idle share); the C18
    proved once; every proof verified, no fixed-column upload.  The
    worker's debug prove of the C12's corrupted witness must have found
    errors.  Returns the kernel rows and {path: launches}."""
    import os
    import pickle
    import resource

    import torch

    from pil2_stark_tpu_torch.ops import tac_codegen, torch_tac
    from pil2_stark_tpu_torch.stark import prover, setup as stark_setup
    from pil2_stark_tpu_torch.utils import cuda_build, timing

    t_phase = time.perf_counter()
    REC_BUILD.wait()
    proc, d = started["proc"], started["dir"]
    try:
        proc.wait(timeout=RECURSION_WAIT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        for f in started["logs"]:
            f.seek(0)
    out, err = (f.read() for f in started["logs"])
    for f in started["logs"]:
        f.close()
    waited = time.perf_counter() - t_phase
    lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or len(lines) != 2:
        raise AssertionError(f"the recursion worker failed (exit {proc.returncode}): {err[-3000:]}")
    emit({"phase": "recursion", "step": "front_end", "worker_s": time.perf_counter()
          - started["started"], "waited_s": waited, **lines[0]})
    debug = lines[1]["debug"]
    emit({"phase": "recursion", "step": "debug", **debug})
    if not debug["corrupted_wire_errors"]:
        raise AssertionError("the C12's debug prove found no error in a corrupted wire")
    with open(os.path.join(d, "chain.pkl"), "rb") as f:
        machines = pickle.load(f)["machines"]

    setups, steps = {}, {}
    for c, m in machines.items():
        t0 = time.perf_counter()
        setups[c] = stark_setup.stark_setup(m["const"], m["pil"],
                                            recursion_struct(m["n_bits"], RECURSION_QUERIES),
                                            options={"skipConstTree": True})
        steps[c] = {"compile_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    libs = [cuda_build.add_generated(tac_codegen.generate(prog).source)
            for s in setups.values()
            for prog in torch_tac.setup_programs(s["starkInfo"], s["expressionsInfo"]).values()]
    cuda_build.build(libs)
    t1_build_s = time.perf_counter() - t0
    for c, m in machines.items():
        t0 = time.perf_counter()
        s = setups[c]
        setups[c] = stark_setup.load_setup(s["starkInfo"], s["expressionsInfo"],
                                           s["verifierInfo"], m["const"], device=None)
        torch.cuda.synchronize()
        steps[c]["load_setup_s"] = time.perf_counter() - t0
    emit({"phase": "recursion", "step": "stark_setup", "t1_build_s": t1_build_s,
          "t1_nvcc_s": {lib: cuda_build.build_seconds.get(lib) for lib in libs},
          "seconds": steps})

    rows, launches = [], {}
    for c, m in machines.items():
        path = RECURSION_PATHS[c]
        info = setups[c]["starkInfo"]
        ss = info["starkStruct"]
        n = ss["nBits"]
        widest = max(v for k, v in info["mapSectionsN"].items() if k.startswith("cm"))
        # B2/B3 at the stage-1 iNTT and at the widest LDE's NTT on the
        # blowup-2 domain, B4 at the trees' leaf batch, B1 at the first FRI
        # fold, T1 on the machine's three programs, T2 at 2^(n+1)
        rows += _ntt_rows(device, n, c, True, path)
        rows += _ntt_rows(device, n + 1, widest, False, path)
        rows.append(_poseidon_row(device, 1 << (n + 1), path))
        fold = ss["steps"][0]["nBits"] - ss["steps"][1]["nBits"]
        rows.append(_b1_row(device, fold, 3 << ss["steps"][1]["nBits"], True, path))
        rows += _tac_rows(device, path, ("imPols", "q", "fri"), setup=setups[c])
        rows.append(_xdiv_row(device, n + 1, path, openings=len(info["openingPoints"])))
    for r in rows:
        emit({"phase": "recursion", **r})
    bad = [(r["name"], r["path"], r["shape"]) for r in rows if r["max_abs_err"] != 0]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions at the recursion "
                             f"shapes: {bad}")

    for c, m in machines.items():
        path = RECURSION_PATHS[c]
        setup = setups[c]
        info = setup["starkInfo"]
        _, out = prove_cold_warm(setup, m["const"], m["cm"], m["publics"], None, counters,
                                 warm=c == 12)
        check_proves(f"C{c}", out)
        launches[path] = out["launches"]
        extra = {}
        if c == 12:
            # the card's idle share over one more warm prove
            prof_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), PROFILE_DIR, path)
            res = prover.prove(info, setup["expressionsInfo"], m["const"], setup["constTree"],
                               (m["cm"], m["publics"]), device=None, profile_dir=prof_dir)
            with open(res["trace"]) as f:
                trace = json.load(f)
            extra["idle_share"] = timing.idle_share(trace)
            extra["idle_share_by_phase"] = {
                name: {"s": secs, "idle_share": timing.idle_share(trace, window=name)}
                for name, secs in res["timings"].items()
                if secs > 0.02 and not name.endswith(".upload")}
            extra["profiled_phases_s"] = res["timings"]
            extra["device"] = device_ops(trace)
            del res, trace
        emit({"phase": "recursion", "step": "prove", "path": path, "machine": f"C{c}",
              "n_bits": info["starkStruct"]["nBits"], "stark_struct": info["starkStruct"],
              "n_columns": {k: v for k, v in info["mapSectionsN"].items() if v},
              "q_deg": info["qDeg"], "n_publics": info["nPublics"], **steps[c], **out, **extra})
        torch.cuda.empty_cache()
    emit({"phase": "recursion", "seconds": time.perf_counter() - t_phase,
          "host_peak_rss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024})
    return rows, launches


# ---------------------------------------------------------------------------
# the snark path: the BN128 half of the recursion tier


def snark_struct(case):
    """The snark path's struct for case plain or custom: fibonacci 2^6 /
    ext 2^9 with BN128 trees and SNARK_QUERIES queries (the struct of
    tests/test_circom_bn128.py)."""
    return bn128_struct(nQueries=SNARK_QUERIES, **SNARK_CASES[case])


def mul_chain(k):
    """A circuit of k + 2 multiplications (Mul3 of tests/test_final.py
    widened): out = t_k * y with t_0 = x * y, t_i = t_(i-1)^2 + x + 5."""
    return f"""pragma circom 2.1.0;
template MulChain(k) {{
    signal input x;
    signal input y;
    signal output out;
    signal t[k + 1];
    t[0] <== x * y;
    for (var i = 1; i <= k; i++) {{
        t[i] <== t[i - 1] * t[i - 1] + x + 5;
    }}
    out <== t[k] * y;
}}
component main {{public [x]}} = MulChain({k});
"""


def start_snark(device, counters):
    """The snark path's STARK on the card: fibonacci 2^6 / ext 2^9 with
    BN128 trees (plain at arity 16, custom at arity 4), compiled by the
    port, set up and proved on the default device with the kernels'
    counters zeroed just before each prove and read just after it (the
    setups' launches are not counted), the path's launches the sum over
    both proves; both proofs verified, no fixed-column upload; B1, B3, T1
    and T2 must have launched (SNARK_KERNELS).  Then the host half starts in
    processes of their own (snark_worker): one per circuit, and the fflonk
    leg.  Returns the kernel rows at the path's shapes and {procs,
    launches, started}."""
    import os
    import shutil

    import torch

    from pil2_stark_tpu_torch.stark import verifier

    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), SNARK_DIR)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    cards, steps = {}, {}
    launches = {c.__name__: 0 for c in counters}
    for case in SNARK_CASES:
        t0 = time.perf_counter()
        cards[case] = _prove_bn128(None, snark_struct(case), counters)
        torch.cuda.synchronize()
        steps[case] = {"setup_and_prove_s": time.perf_counter() - t0}
        for k, n in cards[case][5].items():
            launches[k] += n
    for case, (s, res, zkin, uploads, _, _) in cards.items():
        t0 = time.perf_counter()
        steps[case].update(verified=verifier.verify(res["proof"], res["publics"], s["constRoot"],
                                                    s["starkInfo"], s["verifierInfo"]),
                           verify_s=time.perf_counter() - t0, fixed_uploads=uploads,
                           prove_phases_s=res["timings"], stark_struct=s["starkInfo"]["starkStruct"])
        with open(os.path.join(d, f"{case}.json"), "w") as f:
            json.dump({"constRoot": s["constRoot"], "starkInfo": s["starkInfo"],
                       "verifierInfo": s["verifierInfo"], "proof": canon(res["proof"]),
                       "challenges": canon(res["challenges"]), "zkin": zkin}, f)
    emit({"phase": "snark", "step": "card", "cases": steps, "launches": launches})
    zero = [k for k in SNARK_KERNELS if not launches[k]]
    bad = [c for c, st in steps.items() if not st["verified"] or st["fixed_uploads"]]
    if zero or bad:
        raise AssertionError(f"the snark path's card proves: kernels never launched {zero}, "
                             f"unverified or uploading {bad}")
    # each kernel of the path against its plain version at the path's
    # shapes: B3 at the stage-1 iNTT and the widest LDE's NTT, B1 at the
    # first FRI fold, T1 on the three programs, T2 at the extended domain
    s = cards["plain"][0]
    info = s["starkInfo"]
    ss = info["starkStruct"]
    widest = max(v for k, v in info["mapSectionsN"].items() if k.startswith("cm"))
    rows = [_base_grid_row(device, ss["nBits"], info["mapSectionsN"]["cm1"], True, "snark"),
            _base_grid_row(device, ss["nBitsExt"], widest, False, "snark")]
    fold = ss["steps"][0]["nBits"] - ss["steps"][1]["nBits"]
    rows.append(_b1_row(device, fold, 3 << ss["steps"][1]["nBits"], True, "snark"))
    rows += _tac_rows(device, "snark", ("imPols", "q", "fri"), setup=s)
    rows.append(_xdiv_row(device, ss["nBitsExt"], "snark", openings=len(info["openingPoints"])))
    for r in rows:
        emit({"phase": "snark", **r})
    bad = [(r["name"], r["shape"]) for r in rows if r["max_abs_err"] != 0]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions at the snark path's "
                             f"shapes: {bad}")
    del cards, s
    torch.cuda.empty_cache()
    procs = {}
    for job in (*SNARK_CASES, "fflonk"):
        logs = (open(os.path.join(d, f"{job}.out"), "w+"), open(os.path.join(d, f"{job}.err"), "w+"))
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--snark-worker", d,
                                 job], stdout=logs[0], stderr=logs[1])
        WORKERS.append(proc)
        procs[job] = (proc, logs)
    return rows, {"procs": procs, "launches": launches, "started": time.perf_counter()}


def snark_worker(d, job):
    """The host half of the snark path, in a process of its own.

    plain / custom: the STARK proved again on the CPU must equal the
    card's proof bit for bit and verify; pil2circom of the card's and of
    the CPU's setup must give the same text; the BN254 front-end on the
    card's zkin, check(); a corrupted zkin must be refused; then the final
    machine of the circuit (final9 for the custom-gate circuit, finalfflonk
    for the plain one: final.plonksetup.setup, exec_witness, its
    fflonkinfo).  Its fflonk setup is out of reach on the host (40 · N
    powers of tau, dev_ptau's seconds per power measured here): stated as a
    cut with that reckoning.

    fflonk: a chain of multiplications laid out as finalfflonk at
    2^SNARK_FFLONK_BITS rows through fflonkinfo, dev_ptau(40 · N),
    fflonk_setup, fflonk_prove(rng=Random(SNARK_SEED)) and fflonk_verify
    (true; a changed public and a changed evaluation false), debug mode
    ([] on the witness, errors on a changed one); then Mul3 through the CLI
    (final-setup, final-exec, fflonkinfo, fflonk-setup, fflonk-prove,
    fflonk-verify), whose proof must equal the library's.  One JSON line
    each, with the worker's peak RSS."""
    import os

    # the host half is read only at the end of the run: it yields the CPU
    # to the card phases and to the recursion machines' nvcc beside it
    os.nice(10)
    peak = PeakRss()
    peak.start()
    t_job = time.perf_counter()
    out = snark_fflonk(d) if job == "fflonk" else snark_circuit(d, job)
    out.update(job=job, seconds=time.perf_counter() - t_job, peak_rss_bytes=peak.bytes())
    emit(out)
    return 0 if out["ok"] else 1


class PeakRss(threading.Thread):
    """This process's own peak resident set: VmHWM where /proc/self/status
    has it, else the largest resident set sampled from /proc/self/statm
    every 0.2 s.  (getrusage's ru_maxrss in a process this script spawned
    also counts the parent's resident set at the fork.)"""

    def __init__(self):
        super().__init__(daemon=True)
        self.peak = 0

    def run(self):
        import os

        page = os.sysconf("SC_PAGE_SIZE")
        while True:
            with open("/proc/self/statm") as f:
                self.peak = max(self.peak, int(f.read().split()[1]) * page)
            time.sleep(0.2)

    def bytes(self):
        with open("/proc/self/status") as f:
            hwm = [int(ln.split()[1]) * 1024 for ln in f if ln.startswith("VmHWM:")]
        return hwm[0] if hwm else self.peak


def snark_circuit(d, case):
    import os
    import random

    from pil2_stark_tpu_torch.compiler import circom_front, pil2circom, pilinfo
    from pil2_stark_tpu_torch.final import exec as fexec, plonksetup
    from pil2_stark_tpu_torch.protocol.shplonk import dev_ptau
    from pil2_stark_tpu_torch.stark import verifier

    with open(os.path.join(d, f"{case}.json")) as f:
        card = json.load(f)
    out, t0 = {}, time.perf_counter()
    with one_thread():
        s, res, _, uploads, _, _ = _prove_bn128("cpu", snark_struct(case))
    out["cpu_prove_s"] = time.perf_counter() - t0
    out["card_equals_cpu"] = (canon(res["proof"]) == card["proof"]
                              and canon(res["challenges"]) == card["challenges"]
                              and s["constRoot"] == card["constRoot"])
    out["cpu_verified"] = verifier.verify(res["proof"], res["publics"], s["constRoot"],
                                          s["starkInfo"], s["verifierInfo"])
    t0 = time.perf_counter()
    text = pil2circom.pil2circom(card["constRoot"], card["starkInfo"], card["verifierInfo"])
    out["pil2circom_s"] = time.perf_counter() - t0
    out["circuit_bytes"] = len(text)
    out["text_equals_cpu"] = text == pil2circom.pil2circom(s["constRoot"], s["starkInfo"],
                                                           s["verifierInfo"])
    del s, res
    files = {"verifier.circom": text}
    t0 = time.perf_counter()
    cc = circom_front.compile_and_witness(files, "verifier.circom", card["zkin"],
                                          prime=circom_front.BN254_FR)
    out["front_end_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["check"] = cc.check()
    out["check_s"] = time.perf_counter() - t0
    out.update(signals=cc.n_vars, constraints=len(cc.constraints),
               custom_gate_uses=len(cc.custom_uses), n_publics=cc.n_outputs + cc.n_pub_inputs)
    bad = dict(card["zkin"], evals=[list(e) for e in card["zkin"]["evals"]])
    bad["evals"][0][0] = (bad["evals"][0][0] + 1) % P
    t0 = time.perf_counter()
    try:
        circom_front.compile_and_witness(files, "verifier.circom", bad,
                                         prime=circom_front.BN254_FR)
        out["corrupted_refused"] = False
    except AssertionError as e:
        out["corrupted_refused"], out["corrupted_error"] = True, str(e)[:200]
    out["corrupted_s"] = time.perf_counter() - t0

    cols = SNARK_FINAL_COLS[case]
    t0 = time.perf_counter()
    fs = plonksetup.setup(cc, cols=cols)
    out["final_setup_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cm = fexec.exec_witness(cc.witness, fs["plonkAdditions"], fs["sMap"])
    out["final_exec_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    info = pilinfo.pil_info(fs["pil"], stark=False, options={"field": "fr"})
    out["fflonkinfo_s"] = time.perf_counter() - t0
    width = len(fs["sMap"])
    publics = [int(cc.witness[i]) for i in range(1, 1 + fs["nPublics"])]
    out["final"] = {"machine": {0: "finalfflonk", 9: "final9"}[cols], "n_bits": fs["nBits"],
                    "rows_used": fs["NUsed"], "committed": width,
                    "constants": len(info["pilInfo"]["constPolsMap"]),
                    "plonk_additions": len(fs["plonkAdditions"]), "n_publics": fs["nPublics"]}
    out["final_ok"] = (cm.shape == (1 << fs["nBits"], width)
                       and publics == [int(p) for p in card["zkin"]["publics"]]
                       and [int(cm[i // width, i % width]) for i in range(len(publics))] == publics)
    # the cut: the 40 · N powers of tau the CLI's fflonk-setup takes, at
    # dev_ptau's seconds per power measured here for the fflonk leg's small
    # tau and for a full-width one (a power is one scalar multiplication,
    # whose cost grows with tau's bits)
    powers = 40 << fs["nBits"]
    cut = {"ptau_powers": powers}
    for label, tau in (("small_tau", SNARK_TAU),
                       ("full_width_tau", random.Random(SNARK_SEED).randrange(1, plonksetup.FR))):
        t0 = time.perf_counter()
        dev_ptau(SNARK_PTAU_SAMPLE, tau=tau)
        per_power = (time.perf_counter() - t0) / SNARK_PTAU_SAMPLE
        cut[label] = {"s_per_power": per_power, "ptau_s_reckoned": powers * per_power}
    out["fflonk_setup_cut"] = cut
    out["ok"] = all(out[k] for k in ("card_equals_cpu", "cpu_verified", "text_equals_cpu",
                                     "check", "corrupted_refused", "final_ok")) and not uploads
    return out


def snark_fflonk(d):
    import os
    import random

    import numpy as np

    from pil2_stark_tpu_torch.__main__ import main as cli
    from pil2_stark_tpu_torch.compiler import circom_front, pilinfo
    from pil2_stark_tpu_torch.fflonk import solidity
    from pil2_stark_tpu_torch.fflonk.prover import fflonk_prove
    from pil2_stark_tpu_torch.fflonk.shkey import fflonk_setup, verification_key
    from pil2_stark_tpu_torch.fflonk.verifier import fflonk_verify
    from pil2_stark_tpu_torch.final import exec as fexec, plonksetup
    from pil2_stark_tpu_torch.protocol.shplonk import dev_ptau

    fr = plonksetup.FR
    n_bits = SNARK_FFLONK_BITS
    out, steps = {"n_bits": n_bits}, {}

    def step(name, fn):
        t0 = time.perf_counter()
        r = fn()
        steps[name] = time.perf_counter() - t0
        return r

    def machine(src, cols, options):
        cc = circom_front.compile_and_witness({"m.circom": src}, "m.circom", {"x": 3, "y": 4},
                                              prime=fr)
        s = plonksetup.setup(cc, cols=cols, options=options)
        cm = fexec.exec_witness(cc.witness, s["plonkAdditions"], s["sMap"])
        info = pilinfo.pil_info(s["pil"], stark=False, options={"field": "fr"})
        return cc, s, cm, [int(cc.witness[i]) for i in range(1, 1 + s["nPublics"])], info

    k = (1 << n_bits) - 8  # the rows of k + 2 products, the publics' row and the padding
    cc, s, cm, publics, info = step("circuit_and_final_setup", lambda: machine(
        mul_chain(k), 0, {"nCommitted": 6, "forceNBits": n_bits}))
    out.update(multiplications=k + 2, rows_used=s["NUsed"], constraints=len(cc.constraints),
               ptau_powers=40 << n_bits, check=cc.check() and s["nBits"] == n_bits)
    ptau = step("dev_ptau", lambda: dev_ptau(40 << n_bits, tau=SNARK_TAU))
    zkey = step("fflonk_setup", lambda: fflonk_setup(s["constPols"], info["pilInfo"], ptau))
    args = (zkey, ptau, info["pilInfo"], info["expressionsInfo"])
    res = step("fflonk_prove", lambda: fflonk_prove(*args, cm, publics,
                                                    rng=random.Random(SNARK_SEED)))
    vk = verification_key(zkey, info["pilInfo"])
    vargs = (vk, info["pilInfo"], info["verifierInfo"])
    out["verified"] = step("fflonk_verify", lambda: fflonk_verify(*vargs, res["proof"],
                                                                  res["publics"]))
    wrong = [(res["publics"][0] + 1) % fr] + list(res["publics"][1:])
    out["changed_public_refused"] = fflonk_verify(*vargs, res["proof"], wrong) is False
    proof = {"polynomials": dict(res["proof"]["polynomials"]),
             "evaluations": dict(res["proof"]["evaluations"])}
    name = next(e for e in proof["evaluations"] if e not in ("inv", "invZh"))
    proof["evaluations"][name] = (proof["evaluations"][name] + 1) % fr
    out["changed_evaluation_refused"] = fflonk_verify(*vargs, proof, res["publics"]) is False
    out["debug_errors"] = len(step("fflonk_debug", lambda: fflonk_prove(*args, cm, publics,
                                                                        debug=True)))
    bad = cm.copy()
    bad[5, 2] = (int(bad[5, 2]) + 1) % fr
    out["debug_errors_changed"] = len(fflonk_prove(*args, bad, publics, debug=True))
    out["export"] = snark_export(d, step, zkey, ptau, info, cm, publics, res, vk)
    out["seconds_by_step"] = steps

    # Mul3 through the CLI, in this process; its proof against the library's
    cli_dir = os.path.join(d, f"cli_{n_bits}")
    os.makedirs(cli_dir, exist_ok=True)
    p = lambda name: os.path.join(cli_dir, name)  # noqa: E731
    with open(p("main.circom"), "w") as f:
        f.write(MUL3)
    with open(p("inputs.json"), "w") as f:
        json.dump({"x": 3, "y": 4}, f)
    t0 = time.perf_counter()
    for argv in (
            ["final-setup", "--circom-dir", cli_dir, "--entry", "main.circom", "--inputs",
             p("inputs.json"), "--out-prefix", p("m"), "--cols", "0", "--ncommitted", "6"],
            ["final-exec", "--exec", p("m.exec"), "--wtns", p("m.wtns.json"), "--meta",
             p("m.meta.json"), "--commit", p("m.commit.json"), "--publics", p("m.publics.json")],
            ["fflonkinfo", "--pil-json", p("m.pil.json"), "--fflonkinfo", p("ffi.json"),
             "--expressionsinfo", p("ei.json"), "--verifierinfo", p("vi.json")],
            ["fflonk-setup", "--fflonkinfo", p("ffi.json"), "--const", p("m.const.json"),
             "--tau", str(SNARK_TAU), "--zkey", p("zkey.json"), "--ptau", p("ptau.json"),
             "--verificationkey", p("vk.json")],
            ["fflonk-prove", "--zkey", p("zkey.json"), "--ptau", p("ptau.json"), "--fflonkinfo",
             p("ffi.json"), "--expressionsinfo", p("ei.json"), "--commit", p("m.commit.json"),
             "--publics", p("m.publics.json"), "--seed", str(SNARK_SEED), "--proof",
             p("proof.json"), "--out-publics", p("proof.publics.json")]):
        cli(argv)
    with open(p("proof.publics.json")) as f:
        pubs = json.load(f)
    with open(p("bad.publics.json"), "w") as f:
        json.dump([str((int(pubs[0]) + 1) % fr)] + pubs[1:], f)
    codes = []
    for publics_file in (p("proof.publics.json"), p("bad.publics.json")):
        try:
            cli(["fflonk-verify", "--verificationkey", p("vk.json"), "--fflonkinfo",
                 p("ffi.json"), "--verifierinfo", p("vi.json"), "--proof", p("proof.json"),
                 "--publics", publics_file])
        except SystemExit as e:
            codes.append(e.code)
    # the three export subcommands on Mul3's files
    cli(["exportverificationkey", "--zkey", p("zkey.json"), "--fflonkinfo", p("ffi.json"),
         "--verificationkey", p("vk2.json")])
    cli(["exportsolidityverifier", "--verificationkey", p("vk.json"), "--fflonkinfo",
         p("ffi.json"), "--verifierinfo", p("vi.json"), "-o", p("verifier.sol")])
    cli(["exportcalldata", "--verificationkey", p("vk.json"), "--proof", p("proof.json"),
         "--publics", p("proof.publics.json"), "-o", p("calldata.txt")])
    out["cli_s"] = time.perf_counter() - t0
    _, s3, cm3, pub3, info3 = machine(MUL3, 0, {"nCommitted": 6})
    ptau3 = dev_ptau(40 << s3["nBits"], tau=SNARK_TAU)
    zkey3 = fflonk_setup(s3["constPols"], info3["pilInfo"], ptau3)
    lib = fflonk_prove(zkey3, ptau3, info3["pilInfo"], info3["expressionsInfo"], cm3, pub3,
                       rng=random.Random(SNARK_SEED))
    with open(p("proof.json")) as f:
        out["cli_proof_equals_library"] = json.load(f) == json.loads(
            json.dumps(lib["proof"], default=str))
    vk3 = verification_key(zkey3, info3["pilInfo"])
    with open(p("vk.json"), "rb") as a, open(p("vk2.json"), "rb") as b:
        same_vk = a.read() == b.read()
    with open(p("verifier.sol")) as a, open(p("calldata.txt")) as b:
        cli_export = {"verificationkey": same_vk,
                      "solidity": a.read() == solidity.export_pilfflonk_verifier(
                          vk3, info3["pilInfo"], info3["verifierInfo"]),
                      "calldata": b.read() == solidity.export_calldata(
                          vk3, lib["proof"], lib["publics"])}
    out["cli_export_equals_library"] = cli_export
    out["cli_verify_exit_codes"] = codes
    ex = out["export"]
    out["ok"] = (out["check"] and out["verified"] is True and out["changed_public_refused"]
                 and out["changed_evaluation_refused"] and out["debug_errors"] == 0
                 and out["debug_errors_changed"] > 0 and out["cli_proof_equals_library"]
                 and codes == [0, 1] and np.asarray(cm).shape[0] == 1 << n_bits
                 and all(cli_export.values()) and ex["zkey_proof_equals_library"]
                 and ex["evm_accepts"] is True and ex["evm_refuses_corrupted"]
                 and ex["evm_refuses_oversized"] and ex["search"]["ratio_msm_to_fft"] > 0)
    return out


def snark_export(d, step, zkey, ptau, info, cm, publics, res, vk):
    """The export leg on the fflonk chain's proof: the zkey file written,
    read back and proved from (the proof must equal the library's), the
    Solidity verifier and its calldata, the contract compiled to EVM
    bytecode and run on the proof (accepted), on a corrupted word and on a
    word at the field's modulus (refused), with the gas of each; and the
    search optimizer's cost table at the chain's shape with the MSM/FFT
    ratio measured on its powers of tau (stage-1 columns as nP, the later
    stages' as the intermediate polynomials)."""
    import os
    import random

    from pil2_stark_tpu_torch.fflonk import evm, search_optimizer, solidity, zkey_binfile
    from pil2_stark_tpu_torch.fflonk.prover import fflonk_prove
    from pil2_stark_tpu_torch.fflonk.shkey import verification_key
    from pil2_stark_tpu_torch.ops.fft_bn128 import FR

    ex = {}
    path = os.path.join(d, "chain.zkey")
    step("zkey_write", lambda: zkey_binfile.write_zkey(path, zkey, ptau))
    zk2, ptau2 = step("zkey_read", lambda: zkey_binfile.read_zkey(path))
    res2 = step("prove_from_zkey", lambda: fflonk_prove(
        zk2, ptau2, info["pilInfo"], info["expressionsInfo"], cm, publics,
        rng=random.Random(SNARK_SEED)))
    ex["zkey_bytes"] = os.path.getsize(path)
    ex["zkey_proof_equals_library"] = (
        json.dumps(res2["proof"], default=str) == json.dumps(res["proof"], default=str)
        and verification_key(zk2, info["pilInfo"]) == vk)
    vargs = (vk, info["pilInfo"], info["verifierInfo"])
    contract = step("export_solidity", lambda: solidity.export_pilfflonk_verifier(*vargs))
    calldata = step("export_calldata", lambda: solidity.export_calldata(vk, res["proof"],
                                                                         res["publics"]))
    words = [int(w, 16) for w in json.loads(f"[{calldata}]")[0]]
    pubs = [int(x) % FR for x in res["publics"]]
    ex.update(contract_bytes=len(contract), calldata_words=len(words))
    ok, gas = step("evm_run", lambda: evm.run_verifier(*vargs, words, pubs))
    bad = list(words)
    bad[-3] = (bad[-3] + 1) % FR
    ok_bad, gas_bad = evm.run_verifier(*vargs, bad, pubs)
    big = list(words)
    big[-1] = FR
    ok_big, gas_big = evm.run_verifier(*vargs, big, pubs)
    ex.update(evm_accepts=ok, evm_gas=gas, evm_refuses_corrupted=ok_bad is False,
              evm_gas_corrupted=gas_bad, evm_refuses_oversized=ok_big is False,
              evm_gas_oversized=gas_big)
    power = zkey["power"]
    ratio = step("msm_fft_ratio", lambda: search_optimizer.ratio_msm_to_fft(ptau, power,
                                                                            iterations=2))
    cm_map = info["pilInfo"]["cmPolsMap"]
    n_p = sum(1 for c in cm_map if c["stage"] == 1)
    table = search_optimizer.fflonk_cost_table(3, 10, power, len(cm_map) - n_p, n_p, ratio)
    ex["search"] = {"power": power, "n_p": n_p, "n_intermediate": len(cm_map) - n_p,
                    "ratio_msm_to_fft": ratio, "table": table,
                    "best": min(table, key=lambda row: row["cost"])}
    return ex


def phase_snark(started):
    """Wait for the snark workers and check what each found: the card's
    proofs equal the CPU's, the circuits accept them and refuse a
    corrupted zkin, the final machines are set up and executed, the fflonk
    leg proves, verifies and refuses tampering, the CLI's proof equals the
    library's.  Returns the snark path's launches."""
    t_phase = time.perf_counter()
    results, failed = {}, []
    for job, (proc, logs) in started["procs"].items():
        try:
            proc.wait(timeout=max(1.0, SNARK_WAIT_S - (time.perf_counter() - started["started"])))
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            for f in logs:
                f.seek(0)
        out, err = (f.read() for f in logs)
        for f in logs:
            f.close()
        lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
        if proc.returncode != 0 or not lines:
            failed.append(job)
            emit({"phase": "snark", "job": job, "exit": proc.returncode, "stderr": err[-3000:],
                  **(lines[-1] if lines else {})})
            continue
        results[job] = lines[-1]
        emit({"phase": "snark", "step": job, **lines[-1]})
        if job == "fflonk":
            ex = lines[-1]["export"]
            print(f"fflonk export at 2^{lines[-1]['n_bits']}: zkey {ex['zkey_bytes']} B, "
                  f"contract {ex['contract_bytes']} B, EVM gas {ex['evm_gas']} accepted; "
                  f"{ex['evm_gas_corrupted']} (corrupted word) and {ex['evm_gas_oversized']} "
                  f"(word at the modulus) refused; MSM/FFT ratio "
                  f"{ex['search']['ratio_msm_to_fft']}, best degP "
                  f"{ex['search']['best']['degP']}", flush=True)
    emit({"phase": "snark", "waited_s": time.perf_counter() - t_phase,
          "workers_s": time.perf_counter() - started["started"]})
    if failed:
        raise AssertionError(f"the snark path failed in {failed}")
    return started["launches"]


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


def main(argv):
    if argv[:1] == ["--recursion-worker"]:  # no torch: the host half of the chain
        return recursion_worker(argv[1])
    if argv[:1] == ["--snark-worker"]:  # the host half of the snark path
        return snark_worker(*argv[1:])
    import torch

    if argv[:1] == ["--mesh-worker"]:
        return mesh_worker(*argv[1:])
    only = argv[1] if len(argv) == 2 and argv[0] == "--only" else None
    if argv and only not in ("mesh", "recursion", "snark"):
        print("usage: chip_smoke.py [--only mesh|recursion|snark]", file=sys.stderr)
        return 2
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
    try:
        rows, tool_rows, launches = run_phases(device, counters, only)
    finally:
        for proc in WORKERS:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if REC_BUILD.is_alive():  # its nvcc processes end on their own
            REC_BUILD.join()
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


def run_phases(device, counters, only):
    """Every phase in order (or those of `--only mesh|recursion|snark`):
    (kernel rows, tool rows, {path: launches})."""
    import torch

    phase_build(recursion=only not in ("mesh", "snark"))
    rows, tool_rows, launches = [], [], {}
    if only == "snark":
        rows, snark = start_snark(device, counters)
        launches["snark"] = phase_snark(snark)
        return rows, tool_rows, launches
    if only == "recursion":
        started = start_recursion(device)
        launches["cli_recursion"] = cli_recursion(device, counters, small_recursion(device))
        rows, more = phase_recursion(device, counters, started)
        launches.update(more)
        return rows, tool_rows, launches
    if only is None:
        phase_compile()
        rows = phase_kernels(device)
        # the recursion path's inner proof, then its host half runs beside
        # the phases below until phase_recursion
        started = start_recursion(device)
        # the snark path's card proves, then its host half beside the phases
        # below until phase_snark
        snark_rows, snark = start_snark(device, counters)
        rows += snark_rows
        tool_rows, launches = phase_tools(device, rows)
        small_library = phase_small(device)
        phase_large_ntt(device, LARGE_BITS, LARGE_COLS)
    library = {}
    for name in (VM_SETUP,) if only else (f"all_{N_BITS}", LARGE_SETUP, VM_SETUP):
        launches[name], library[name] = phase_prove(device, name, counters,
                                                    warm=name != f"all_{N_BITS}")
    mesh_rows, launches["mesh"] = phase_mesh(device, counters, library[VM_SETUP])
    rows += mesh_rows
    del library[VM_SETUP]["setup"], library[VM_SETUP]["columns"]
    torch.cuda.empty_cache()
    if only is None:
        launches["cli"] = phase_cli(device, counters, library[VM_SETUP])
        launches["cli_recursion"] = cli_recursion(device, counters, small_library)
        phase_profile(device, (VM_SETUP, LARGE_SETUP))
        more_rows, more = phase_recursion(device, counters, started)
        rows += more_rows
        launches.update(more)
        launches["snark"] = phase_snark(snark)
    return rows, tool_rows, launches


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
