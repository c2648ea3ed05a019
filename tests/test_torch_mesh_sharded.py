"""PyTorch port, the row-sharded prove on the CPU: with ``mesh=`` the
extended domain stays split over the ranks through the Q program, the
evals, xDivXSubXi, the FRI program and the queries, and every proof still
equals one device's and the JAX package's.  Virtual meshes of 2 and 4 CPU
ranks; fibonacci 2^6 and the Poseidon VM 2^6; the fibv airs, whose
openings [-1, 0, 1] and [-1, 0] need halos on both sides of each rank's
rows; each rank holds its extN/d rows of every tree and, for a program's
run, a copy padded by the halo alone; the sharded evals equal the
unsharded ones; and T1's windowed run (a row base, signed shifts, no
wrap) equals the whole run, in its plain version and in the generated rows
compiled with the host's C++ compiler (tests/tac_host_shim.h)."""
import ctypes
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from pil2_stark_tpu_torch.field import f3, torch_gl
from pil2_stark_tpu_torch.models import fibv as tfibv
from pil2_stark_tpu_torch.ops import tac_codegen, torch_tac
from pil2_stark_tpu_torch.parallel import distributed, merkle_sharded
from pil2_stark_tpu_torch.stark import device as tdevice, prover as tprover
from pil2_stark_tpu_torch.stark import setup as tsetup, verifier as tverifier
from pil2_stark_tpu_torch.utils import cuda_build, host_build

from test_torch_cases import canon, case_inputs, prove_both
from test_torch_vadcop import ext_challenges

P = 0xFFFFFFFF00000001
CPU = torch.device("cpu")
TESTS = Path(__file__).resolve().parent


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch's multi-threaded int64 ops are slow on small CPU tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(d):
    return distributed.proof_mesh(devices=[CPU] * d)


def _mesh_prove(name, ts, d):
    _, const_cols, cm_cols, publics = case_inputs(name)
    mesh = _mesh(d)
    res = tprover.prove(ts["starkInfo"], ts["expressionsInfo"], const_cols.buffer,
                        merkle_sharded.shard_tree(ts["constTree"], mesh),
                        (cm_cols.buffer, publics), mesh=mesh)
    assert mesh.exchanged_bytes > 0 or d == 1
    return res


@pytest.mark.parametrize("name,meshes", [("fibonacci_6", (2, 4)), ("poseidon_vm_6", (2,))])
def test_mesh_proofs_equal_single_and_jax(name, meshes):
    _, jres, ts, tres = prove_both(name)
    for d in meshes:
        res = _mesh_prove(name, ts, d)
        assert canon(res["proof"]) == canon(tres["proof"]) == canon(jres["proof"]), d
        assert res["challenges"] == tres["challenges"]
        assert tverifier.verify(res["proof"], res["publics"], ts["constRoot"], ts["starkInfo"],
                                ts["verifierInfo"])


def _section_widths(info):
    """{section: columns} of every extended section a prove keeps."""
    widths = {"const": info["nConstants"]}
    for i in range(info["nStages"] + 1):
        widths[f"cm{i + 1}"] = info["mapSectionsN"].get(f"cm{i + 1}", 0)
    return widths


def test_negative_openings_halos_and_rank_rows():
    """fibv's airs on 2 and 4 ranks under shared external challenges equal
    one device's proof (tests/test_torch_vadcop.py holds that one against
    the JAX package's); each rank holds extN/d rows of every section and
    pads only by the halo its Q program reads; one split of the const tree
    serves every prove on its mesh."""
    cm_mod, cm_fib, publics = tfibv.execute(101, 1, 2)
    for name, cm in (("fibv_fibonacci", cm_fib), ("fibv_module", cm_mod)):
        data = tsetup.read_setup(name)
        info = data["starkInfo"]
        ss = info["starkStruct"]
        ext = ext_challenges(np.random.default_rng(7), info, ss)
        fixed = np.asarray(data["fixedPols"], dtype=np.uint64)
        ts = tsetup.load_setup(info, data["expressionsInfo"], data["verifierInfo"], fixed,
                               device="cpu")
        one = tprover.prove(ts["starkInfo"], ts["expressionsInfo"], fixed, ts["constTree"],
                            (cm, publics), device="cpu", external_challenges=ext)
        code, dom = torch_tac.device_program(info, data["expressionsInfo"], "q")
        prog = torch_tac.compile_program(code, dom, info, ss["nBits"], ss["nBitsExt"])
        before, after = torch_tac.halo(prog)
        blowup = 1 << (ss["nBitsExt"] - ss["nBits"])
        assert before == blowup and after == (blowup if 1 in info["openingPoints"] else 0)
        widths = _section_widths(info)
        read = {ref[1] for ref in prog.columns if ref[0] == "section"}
        ext_n = 1 << ss["nBitsExt"]
        for d in (2, 4):
            mesh = _mesh(d)
            split = merkle_sharded.shard_tree(ts["constTree"], mesh)
            assert [s.shape for s in split.shards] == [(widths["const"], ext_n // d)] * d
            proofs = [tprover.prove(ts["starkInfo"], ts["expressionsInfo"], fixed, split,
                                    (cm, publics), mesh=mesh, external_challenges=ext)
                      for _ in range(2 if d == 2 else 1)]
            res = proofs[-1]
            assert all(canon(r["proof"]) == canon(one["proof"]) for r in proofs), (name, d)
            b = ext_n // d
            held = res["rankBytes"]
            assert held["sections"] == [8 * b * sum(widths.values())] * d
            assert held["padded"] == [8 * (before + b + after) * sum(widths[s] for s in read)] * d
            assert all(h < 8 * ext_n * w for h, w in zip(held["sections"],
                                                         [sum(widths.values())] * d))


def test_sharded_evals_equal_unsharded():
    data = tsetup.read_setup("poseidon_vm_6")
    info = data["starkInfo"]
    ss = info["starkStruct"]
    ext_n, stride = 1 << ss["nBitsExt"], 1 << (ss["nBitsExt"] - ss["nBits"])
    rng = np.random.default_rng(5)
    sections = {s: torch_gl.from_u64(rng.integers(0, P, size=(w, ext_n), dtype=np.uint64), CPU)
                for s, w in _section_widths(info).items()}
    xis = [tuple(int(v) for v in rng.integers(0, P, size=3, dtype=np.uint64))
           for _ in info["openingPoints"]]
    want = tdevice.compute_evals(info, sections, xis, ss["nBits"], stride, CPU)
    for d in (2, 4):
        mesh = _mesh(d)
        shards = {s: mesh.scatter(v) for s, v in sections.items()}
        assert tdevice.compute_evals_sharded(info, shards, xis, ss["nBits"], stride, mesh) == want
    assert all(0 <= c < P for e in want for c in e) and len(want) == len(info["evMap"])
    assert f3.as3(want[0]) == want[0]


WRAPPER = """\
#include "tac_host_shim.h"
#include "{source}"
#include <cstring>

extern "C" int run_window(const long long* cols, const long long* shifts, uint64_t* scalars,
                          long long n, long long base, long long rows) {{
  Params p;
  fill(p, cols, shifts, n);
  p.base = base;
  p.rows = rows;
  derive(scalars);
  if (kNumScalars > 0) std::memcpy(kS, scalars, sizeof(uint64_t) * kNumScalars);
#define RUN(k) for (long long i = 0; i < p.rows; ++i) row_seg##k(p, p.base + i);
  TAC_SEGMENTS(RUN)
  return 0;
}}
"""


def test_t1_window_equals_whole_run(tmp_path):
    """fibv_fibonacci's Q program (shifts of -2 and +2 rows at blowup 2) at
    64 rows: each of 4 windows of 16 rows, given its rows with the halo,
    equals the whole run's rows, in run_plain and in the generated rows."""
    data = tsetup.read_setup("fibv_fibonacci")
    info = data["starkInfo"]
    code, dom = torch_tac.device_program(info, data["expressionsInfo"], "q")
    prog = torch_tac.compile_program(code, dom, info, 5, 6)
    n = prog.n
    before, after = torch_tac.halo(prog)
    assert (before, after) == (2, 2)
    rng = np.random.default_rng(9)

    def rand(*shape):
        return torch_gl.from_u64(rng.integers(0, P, size=shape, dtype=np.uint64), CPU)

    whole = {"sections": {s: rand(w, n) for s, w in _section_widths(info).items() if w},
             "x": rand(n), "Zi": rand(len(info["boundaries"]), n),
             "xDivXSubXi": rand(len(info["openingPoints"]), 3, n),
             "publics": rand(max(info["nPublics"], 1)),
             "challenges": rand(len(info["challengesMap"]), 3),
             "evals": rand(max(len(info["evMap"]), 1), 3),
             "subproofValues": rand(max(info.get("nSubproofValues", 0), 1), 3)}
    want = torch_tac.run_plain(prog, whole)
    src = tmp_path / "q.cu"
    src.write_text(tac_codegen.generate(prog).source)
    (tmp_path / "q_host.cpp").write_text(WRAPPER.format(source=src))
    out = subprocess.run([host_build.cxx(), "-std=c++17", "-O0", "-shared", "-fPIC", "-I",
                          str(cuda_build.CSRC), "-I", str(TESTS), "-o", str(tmp_path / "q.so"),
                          str(tmp_path / "q_host.cpp")], capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-4000:]
    lib = ctypes.CDLL(str(tmp_path / "q.so"))
    lib.run_window.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3
    b = n // 4
    for r in range(4):
        rows = (torch.arange(before + b + after) + r * b - before) % n
        win = dict(whole, sections={s: v[:, rows].contiguous() for s, v in whole["sections"].items()},
                   x=whole["x"][rows].contiguous(), Zi=whole["Zi"][:, rows].contiguous(),
                   xDivXSubXi=whole["xDivXSubXi"][:, :, rows].contiguous())
        got = torch_tac.run_plain(prog, win, window=(before, b))
        assert torch.equal(got["q"], want["q"][:, r * b:(r + 1) * b]), r
        gen, bufs, ptrs, table = torch_tac.kernel_args(prog, win, (before, b))
        shifts = [torch_tac.signed_shift(s, n) for s in gen.shifts]
        assert min(shifts) < 0 < max(shifts)
        cols = (ctypes.c_longlong * len(ptrs))(*ptrs)
        sh = (ctypes.c_longlong * len(shifts))(*shifts)
        assert lib.run_window(cols, sh, table.data_ptr(), before + b + after, before, b) == 0
        host = torch_tac._outputs(prog, bufs, (before, b))
        assert torch.equal(host["q"], want["q"][:, r * b:(r + 1) * b]), r
    with pytest.raises(ValueError, match="halo"):
        torch_tac.run_plain(prog, win, window=(before - 1, b))
