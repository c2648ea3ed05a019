"""Kernel T1's generated code (ops/tac_codegen.py) on the CPU.

The generator's source for every program of all_8 and fibonacci_6, for the
segmented synthetic program and for a program of 40 live extension values
(tests/test_torch_tac_program.py) is compiled with the host's g++ through
tests/tac_host_shim.h, one g++ call per setup (a module fixture), and run
through ctypes on the column addresses, row shifts and scalar table that
the card's launch gets (torch_tac.kernel_args).  Its output must equal
run_plain and, for the committed programs, the JAX package's
make_executor.  Tolerance: none, bit for bit.

The JAX executor runs its own body (make_executor's trace of the program)
eagerly, each GL op jitted on its own (tests/test_torch_tac.py's
``jax_executor`` fixture).  Every committed program runs at N = 64 rows,
so the jitted ops compile once for all of them.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from pil2_stark_tpu.field import jax_gl
from pil2_stark_tpu_torch.field import torch_gl
from pil2_stark_tpu_torch.ops import tac_codegen, torch_tac
from pil2_stark_tpu_torch.stark import setup as tsetup
from pil2_stark_tpu_torch.utils import cuda_build
import test_torch_tac_program as tac_cases
from test_torch_tac import jax_executor  # noqa: F401  (a fixture)

P = 0xFFFFFFFF00000001
N_BITS = 6  # every committed program runs at 64 rows
TESTS = Path(__file__).resolve().parent

WRAPPER = """\
#include "tac_host_shim.h"
#include "{source}"
#include <cstring>

extern "C" int {entry}(const long long* cols, const long long* shifts, uint64_t* scalars,
                       long long n) {{
  Params p;
  fill(p, cols, shifts, n);
  derive(scalars);
  if (kNumScalars > 0) std::memcpy(kS, scalars, sizeof(uint64_t) * kNumScalars);
#define RUN(k) for (long long i = 0; i < n; ++i) row_seg##k(p, i);
  TAC_SEGMENTS(RUN)
  return 0;
}}
"""


def compile_host(progs: dict, out_dir: Path) -> ctypes.CDLL:
    """One g++ call over the generated sources of `progs` ({entry: Program});
    each program's rows run through the C function named by its key."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    out_dir.mkdir(parents=True, exist_ok=True)
    units = []
    for entry, prog in progs.items():
        src = out_dir / f"{entry}.cu"
        src.write_text(tac_codegen.generate(prog).source)
        unit = out_dir / f"{entry}_host.cpp"
        unit.write_text(WRAPPER.format(source=src, entry=entry))
        units.append(str(unit))
    lib = out_dir / "host.so"
    cmd = [gxx, "-std=c++17", "-O0", "-shared", "-fPIC", "-I", str(cuda_build.CSRC),
           "-I", str(TESTS), "-o", str(lib), *units]
    out = subprocess.run(cmd, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-4000:]
    return ctypes.CDLL(str(lib))


def run_host(lib, entry, prog, inputs) -> dict:
    """The generated rows of `prog` over every row, on the CPU inputs."""
    gen, bufs, ptrs, table = torch_tac.kernel_args(prog, inputs)
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong]
    cols = (ctypes.c_longlong * max(len(ptrs), 1))(*ptrs)
    shifts = (ctypes.c_longlong * max(len(gen.shifts), 1))(*gen.shifts)
    assert fn(cols, shifts, table.data_ptr(), prog.n) == 0
    return torch_tac._outputs(prog, bufs)


def _assert_equal(got, want):
    assert sorted(got) == sorted(want) and sorted(got["cm"]) == sorted(want["cm"])
    for key in ("q", "f"):
        if key in want:
            assert torch.equal(got[key], torch.as_tensor(want[key])), key
    for key, v in want["cm"].items():
        assert torch.equal(got["cm"][key], torch.as_tensor(v)), key


def _programs(name):
    """{which: (code object, dom, Program at N = 64 rows)} of a setup."""
    setup = tsetup.read_setup(name)
    info = setup["starkInfo"]
    extend = info["starkStruct"]["nBitsExt"] - info["starkStruct"]["nBits"]
    out = {}
    for which in torch_tac.PROGRAMS:
        code, dom = torch_tac.device_program(info, setup["expressionsInfo"], which)
        n_bits = N_BITS if dom == "n" else N_BITS - extend
        out[which] = (code, dom, torch_tac.compile_program(code, dom, info, n_bits,
                                                           n_bits + extend))
    return info, extend, out


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """Per setup: (starkInfo, extend bits, programs, host library), built on
    first use, one g++ call each."""
    root = tmp_path_factory.mktemp("tac_host")
    built = {}

    def get(name):
        if name not in built:
            info, extend, progs = _programs(name)
            lib = compile_host({w: p for w, (_, _, p) in progs.items()}, root / name)
            built[name] = (info, extend, progs, lib)
        return built[name]

    return get


def _inputs(info, dom, extend, seed):
    """The same random sections, domain tables and scalars for both
    packages (JAX: limb pairs, xDivXSubXi point-major)."""
    n = 1 << N_BITS
    rng = np.random.default_rng(seed)

    def rand(*shape):
        return rng.integers(0, P, size=shape, dtype=np.uint64)

    sections = {"const": rand(info["nConstants"], n)}
    for i in range(info["nStages"] + (1 if dom == "ext" else 0)):
        sections[f"cm{i + 1}"] = rand(info["mapSectionsN"][f"cm{i + 1}"], n)
    x, zi = rand(n), rand(len(info["boundaries"]), n)
    xdiv = rand(len(info["openingPoints"]), 3, n)
    publics = rand(max(info["nPublics"], 1))
    challenges = rand(len(info["challengesMap"]), 3)
    evals = rand(max(len(info["evMap"]), 1), 3)
    t_inputs = {"sections": {k: torch_gl.from_u64(v) for k, v in sections.items()},
                "x": torch_gl.from_u64(x), "publics": torch_gl.from_u64(publics),
                "challenges": torch_gl.from_u64(challenges), "evals": torch_gl.from_u64(evals),
                "Zi": torch_gl.from_u64(zi), "xDivXSubXi": torch_gl.from_u64(xdiv)}
    j_inputs = {"sections": {k: jax_gl.from_u64(v) for k, v in sections.items()},
                "x": jax_gl.from_u64(x),
                "smalls": jax_gl.from_u64(np.concatenate(
                    [publics[:info["nPublics"]], challenges.reshape(-1), evals.reshape(-1)])),
                "sizes": (info["nPublics"], len(challenges)),
                "Zi": jax_gl.from_u64(zi),
                "xDivXSubXi": jax_gl.from_u64(np.ascontiguousarray(xdiv.transpose(2, 0, 1)))}
    return t_inputs, j_inputs


@pytest.mark.parametrize("which", torch_tac.PROGRAMS)
@pytest.mark.parametrize("name", ["all_8", "fibonacci_6"])
def test_generated_program_matches_plain_and_jax(host, jax_executor, name, which):
    info, extend, progs, lib = host(name)
    code, dom, prog = progs[which]
    assert code["code"], which
    t_inputs, j_inputs = _inputs(info, dom, extend, 10 * len(name) + len(which))
    got = run_host(lib, which, prog, t_inputs)
    _assert_equal(got, torch_tac.run_plain(prog, t_inputs))
    n_bits = N_BITS if dom == "n" else N_BITS - extend
    want = jax_executor(code, dom, info, n_bits, n_bits + extend, planar=True)(j_inputs)
    want = {"cm": {k: jax_gl.to_u64(v).view(np.int64) for k, v in want["cm"].items()},
            **{k: jax_gl.to_u64(v).view(np.int64) for k, v in want.items() if k != "cm"}}
    _assert_equal(got, want)


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    """The segmented and the wide synthetic programs, built in one g++ call."""
    cases = {"segmented": tac_cases.segmented_case(), "wide": tac_cases.wide_case()}
    lib = compile_host({k: prog for k, (_, _, prog) in cases.items()},
                       tmp_path_factory.mktemp("tac_synthetic"))
    return cases, lib


@pytest.mark.parametrize("case", ["segmented", "wide"])
def test_generated_synthetic_program_matches_plain(synthetic, case):
    """Three segments with carries (one kernel each), and 40 values live
    at once; against run_plain and the op-by-op reference."""
    cases, lib = synthetic
    code_obj, info, prog = cases[case]
    assert len(prog.segments) == {"segmented": 3, "wide": 1}[case]
    assert tac_codegen.generate(prog).n_segments == len(prog.segments)
    n, extend_bits = 1 << 6, 2
    inputs = tac_cases.inputs_for(info, n, 9)
    got = run_host(lib, case, prog, inputs)
    _assert_equal(got, torch_tac.run_plain(prog, inputs))
    want_out, want_cm = tac_cases.reference(code_obj["code"], info, inputs, n,
                                            lambda p: ((p or 0) << extend_bits) % n)
    assert torch.equal(got["q"], want_out["q"])
    for i, v in want_cm.items():
        key = ("cm1", 3 * i, tac_cases.SEG_DIMS[i])
        assert torch.equal(got["cm"][key], v), key


def _setup_programs(name, edit=None):
    setup = tsetup.read_setup(name)
    if edit is not None:
        edit(setup)
    return torch_tac.setup_programs(setup["starkInfo"], setup["expressionsInfo"])


def test_digest_shared_across_sizes_and_moved_by_an_instruction():
    """all_8 and all_20 differ in n and the shifts, which are launch
    parameters: one source, one digest per program.  Turning one add of
    the Q program into a sub changes the source and its digest."""
    small, large = _setup_programs("all_8"), _setup_programs("all_20")
    assert sorted(small) == sorted(large) == sorted(torch_tac.PROGRAMS)
    for which in small:
        a, b = tac_codegen.generate(small[which]), tac_codegen.generate(large[which])
        assert small[which].n != large[which].n
        assert a.source == b.source and a.digest == b.digest, which

    def edit(setup):
        code, _ = torch_tac.device_program(setup["starkInfo"], setup["expressionsInfo"], "q")
        inst = next(i for i in code["code"] if i["op"] == "add")
        inst["op"] = "sub"

    edited = _setup_programs("all_8", edit)
    assert tac_codegen.generate(edited["q"]).digest != tac_codegen.generate(small["q"]).digest
    for which in ("imPols", "fri"):
        assert tac_codegen.generate(edited[which]).digest == tac_codegen.generate(
            small[which]).digest


def test_generated_source_has_no_dim_or_kind_branch():
    """Every instruction became a typed const local: no slot array, no
    instruction decode, and each column read once per row and shift."""
    prog = _setup_programs("all_8")["q"]
    src = tac_codegen.generate(prog).source
    body = src[src.index("row_seg0"):src.index("}  // namespace")]
    assert "slots" not in body and "switch" not in body and "if (" not in body.replace(
        "if (r", "")
    loads = [ln.split("=")[1] for ln in body.splitlines() if "= ld(" in ln]
    assert len(loads) == len(set(loads))


@pytest.mark.parametrize("name,which", [("fibv_module", "q"), ("poseidon_vm_6", "q"),
                                        ("poseidon_vm_6", "imPols"), ("boundaries_6", "q")])
def test_generated_program_matches_plain_new_setups(host, name, which):
    """The Q program of a vadcop air (it reads a subproof value from the
    scalar table), the Poseidon VM's 870-instruction Q program and its
    im-pols, and the boundary machine's Q program (its Zi rows): the
    generated rows against run_plain on random inputs."""
    info, extend, progs, lib = host(name)
    code, dom, prog = progs[which]
    t_inputs, _ = _inputs(info, dom, extend, 7 * len(name) + len(which))
    reads_sv = any(r["type"] == "subproofValue" for i in code["code"] for r in i["src"])
    assert reads_sv == (name == "fibv_module")
    rng = np.random.default_rng(len(name))
    t_inputs["subproofValues"] = torch_gl.from_u64(
        rng.integers(0, P, size=(max(info.get("nSubproofValues", 0), 1), 3), dtype=np.uint64))
    got = run_host(lib, which, prog, t_inputs)
    _assert_equal(got, torch_tac.run_plain(prog, t_inputs))
