"""The PyTorch port stands alone: with `jax` and `pil2_stark_tpu` blocked
from import, every module of pil2_stark_tpu_torch imports (its CLI,
__main__, and the BN128 hash modules among them), the port
compiles fibonacci 2^6 to its committed setup, sets it up, proves and
verifies it on the CPU, the Poseidon VM's
builders, debug mode, fibv and the global constraints run, the CLI
proves and verifies fibonacci 2^6 on the CPU, and the multi-device prover
(parallel/) runs a sharded transform and tree on 4 CPU ranks, and the
recursion tier's modules are all there and emit their circuits and PIL,
and so are the BN128 half's (a BN128 verifier circuit emitted; Mul3 set up
as finalfflonk, proved and verified with fflonk) and the export leg's (its
zkey written and read back, its contract's calldata accepted on the EVM,
the search optimizer, sqrt, the host C++ runtime), and fibonacci 2^6 proves
row-sharded on 2 CPU ranks to the one-device proof.  Its sources
name neither package in an import statement, and its entry points refuse
to fall back to the CPU when no card is there."""
import pathlib
import re
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent

GUARDED = r'''
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["pil2_stark_tpu"] = None
import pil2_stark_tpu_torch
names = [m.name for m in pkgutil.walk_packages(pil2_stark_tpu_torch.__path__, "pil2_stark_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import copy
from pil2_stark_tpu_torch.models import fibonacci
from pil2_stark_tpu_torch.stark import catalog, prover, setup, verifier
P = 0xFFFFFFFF00000001
data = setup.read_setup("fibonacci_6")
# the port's compiler, alone, gives the committed setup
assert catalog.compile_file("fibonacci_6") == data
pil = catalog.machine_pil("fibonacci", 6)
const_cols, cm_cols, publics = fibonacci.build(pil["references"], 64)
s = setup.stark_setup(const_cols.buffer, pil, copy.deepcopy(fibonacci.STARK_STRUCT),
                      device="cpu")
res = prover.prove(s["starkInfo"], s["expressionsInfo"], const_cols.buffer, s["constTree"],
                   (cm_cols.buffer, publics), device="cpu")
assert verifier.verify(res["proof"], res["publics"], s["constRoot"], s["starkInfo"],
                       s["verifierInfo"])
# the VM's builders, debug mode, fibv, the global constraints and the
# trace reader
import numpy as np
from pil2_stark_tpu_torch.hash import poseidon_gl
from pil2_stark_tpu_torch.models import fibv, poseidon_vm
from pil2_stark_tpu_torch.utils import timing
vm = setup.read_setup("poseidon_vm_6_debug")
inputs = np.random.default_rng(3).integers(0, poseidon_gl.gl64.P_INT, size=(2, 12), dtype=np.uint64)
const_cols, cm_cols, _ = poseidon_vm.build(setup.read_setup("poseidon_vm_6")["references"], 64, inputs)
assert (poseidon_vm.final_states(cm_cols.buffer) == poseidon_gl.permute(inputs)).all()
assert prover.prove(vm["starkInfo"], vm["expressionsInfo"], const_cols.buffer, None,
                    (cm_cols.buffer, []), debug=True, device="cpu") == []
assert fibv.execute(101, 1, 2)[2][:3] == [101, 1, 2]
codes = setup.read_setup("fibv_global")["constraints"]
assert verifier.verify_global_constraints(codes, [[(1, 2, 3)], [(P - 1, P - 2, P - 3)]]) == []
assert callable(timing.idle_share)
# the CLI: prove, then verify, the files through the module's entry point
import tempfile
import pil2_stark_tpu_torch.__main__ as cli
assert "pil2_stark_tpu_torch.__main__" in names
with tempfile.TemporaryDirectory() as d:
    cli.main(["prove", "--model", "fibonacci", "--nbits", "6", "--device", "cpu", "--tmp", d])
    try:
        cli.main(["verify", "--proof", f"{d}/proof.json", "--publics", f"{d}/publics.json",
                  "--verkey", f"{d}/verkey.json", "--starkinfo", f"{d}/starkinfo.json",
                  "--verifierinfo", f"{d}/verifierinfo.json"])
    except SystemExit as e:
        assert e.code == 0, e.code
# a BN128 tree and transcript
from pil2_stark_tpu_torch.hash import merkle_bn128, transcript_bn128
assert merkle_bn128.merkelize(np.arange(12, dtype=np.uint64), 4, 3).root > 0
assert len(transcript_bn128.TranscriptBN128().get_field()) == 3
# the multi-device prover: a sharded transform and tree on 4 CPU ranks
from pil2_stark_tpu_torch.field import torch_gl
from pil2_stark_tpu_torch.ops import ntt
from pil2_stark_tpu_torch.parallel import distributed, merkle_sharded, ntt_sharded
assert {"pil2_stark_tpu_torch.parallel.distributed", "pil2_stark_tpu_torch.parallel.ntt_sharded",
        "pil2_stark_tpu_torch.parallel.merkle_sharded"} <= set(names)
distributed.init_distributed()
mesh = distributed.proof_mesh(devices=["cpu"] * 4)
x = torch_gl.from_u64(np.arange(3 * 256, dtype=np.uint64).reshape(3, 256), "cpu")
ext = ntt_sharded.sharded_ntt(mesh.scatter(x), 8, mesh)
assert (mesh.gather(ext) == ntt.planar_ntt(x, 8, False)).all()
assert merkle_sharded.merkelize(mesh, ext, 3, 256).root.shape == (4,)
# the Goldilocks recursion tier: its ten modules, the gadget library, a C12 PIL
tier = {"pil2_stark_tpu_torch.utils.r1cs"} | {f"pil2_stark_tpu_torch.compiler.{m}" for m in (
    "r1cs2plonk", "compressor", "circom_gadgets", "pil2circom", "circom_front", "compressor12",
    "compressor18", "vadcop", "chelpers_bin")}
assert tier <= set(names), tier - set(names)
from pil2_stark_tpu_torch.compiler import circom_gadgets, compressor12, pil1_parser as parser
assert "template" in circom_gadgets.emit_gadget_files()["poseidon.circom"]
assert parser.compile_pil_source(compressor12._pil_source(4, 3))["nCommitments"] == 12
# the BN128 half of the tier: its sixteen modules; Mul3 as finalfflonk set
# up, proved and verified, and a BN128 circuit emitted
tier = {f"pil2_stark_tpu_torch.{m}" for m in (
    "ops.fft_bn128", "curve.bn254", "protocol.keccak", "protocol.poly_fr", "protocol.shplonk",
    "compiler.circom_gadgets_bn128", "compiler.pil2circom_bn128", "final", "final.exec",
    "final.plonksetup", "fflonk.fr_ctx", "fflonk.fr_hints", "fflonk.chelpers",
    "fflonk.prover", "fflonk.shkey", "fflonk.verifier")}
assert tier <= set(names), tier - set(names)
import random
from pil2_stark_tpu_torch.compiler import circom_front, pilinfo, pil2circom
from pil2_stark_tpu_torch.fflonk import prover as fprover, shkey, verifier as fverifier
from pil2_stark_tpu_torch.final import exec as fexec, plonksetup
from pil2_stark_tpu_torch.protocol.shplonk import dev_ptau
mul3 = """pragma circom 2.1.0;
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
cc = circom_front.compile_and_witness({"m.circom": mul3}, "m.circom", {"x": 3, "y": 4},
                                      prime=plonksetup.FR)
fs = plonksetup.setup(cc, cols=0, options={"nCommitted": 6})
cm = fexec.exec_witness(cc.witness, fs["plonkAdditions"], fs["sMap"])
info = pilinfo.pil_info(fs["pil"], stark=False, options={"field": "fr"})
ptau = dev_ptau(40 * (1 << fs["nBits"]), tau=4242)
zkey = shkey.fflonk_setup(fs["constPols"], info["pilInfo"], ptau)
fres = fprover.fflonk_prove(zkey, ptau, info["pilInfo"], info["expressionsInfo"], cm,
                            [int(cc.witness[i]) for i in range(1, 1 + fs["nPublics"])],
                            rng=random.Random(7))
assert fverifier.fflonk_verify(shkey.verification_key(zkey, info["pilInfo"]), info["pilInfo"],
                               info["verifierInfo"], fres["proof"], fres["publics"])
bn = dict(copy.deepcopy(fibonacci.STARK_STRUCT), verificationHashType="BN128")
bs = setup.stark_setup(fibonacci.build(pil["references"], 64)[0].buffer, pil, bn, device="cpu")
assert "StarkVerifierBN0" in pil2circom.pil2circom(bs["constRoot"], bs["starkInfo"],
                                                   bs["verifierInfo"])
# the export leg: the zkey file, the contract, its calldata on the EVM, the
# search optimizer, GL sqrt; the host C++ runtime
tier = {f"pil2_stark_tpu_torch.{m}" for m in (
    "fflonk.zkey_binfile", "fflonk.solidity", "fflonk.evm", "fflonk.search_optimizer",
    "field.sqrt", "runtime", "runtime.native", "utils.host_build")}
assert tier <= set(names), tier - set(names)
import json
from pil2_stark_tpu_torch.fflonk import evm, search_optimizer, solidity, zkey_binfile
from pil2_stark_tpu_torch.field import sqrt
from pil2_stark_tpu_torch.runtime import native
vk = shkey.verification_key(zkey, info["pilInfo"])
with tempfile.TemporaryDirectory() as d:
    zkey_binfile.write_zkey(f"{d}/m.zkey", zkey, ptau)
    zk2, _ = zkey_binfile.read_zkey(f"{d}/m.zkey")
assert shkey.verification_key(zk2, info["pilInfo"]) == vk
calldata = solidity.export_calldata(vk, fres["proof"], fres["publics"])
words = [int(w, 16) for w in json.loads(f"[{calldata}]")[0]]
assert evm.run_verifier(vk, info["pilInfo"], info["verifierInfo"], words,
                        [int(p) % plonksetup.FR for p in fres["publics"]])[0] is True
assert "pragma solidity" in solidity.export_pilfflonk_verifier(vk, info["pilInfo"],
                                                               info["verifierInfo"])
assert search_optimizer.exhaustive_search_optimizer(6, 4, 10, ratio=1e9)["degP"] == 3
assert sqrt.sqrt(4) in (2, P - 2)
assert native.permute_int(list(range(12))) == poseidon_gl.permute_int(list(range(12)))
# the row-sharded prove: fibonacci 2^6 on 2 CPU ranks gives the one-device proof
mesh = distributed.proof_mesh(devices=["cpu"] * 2)
const_cols, cm_cols, publics = fibonacci.build(pil["references"], 64)
sres = prover.prove(s["starkInfo"], s["expressionsInfo"], const_cols.buffer,
                    merkle_sharded.shard_tree(s["constTree"], mesh), (cm_cols.buffer, publics),
                    mesh=mesh)
assert json.dumps(sres["proof"], default=str) == json.dumps(res["proof"], default=str)
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules if sys.modules[m] is not None)
print("IMPORTED", len(names))
'''


def test_port_runs_with_jax_blocked():
    out = subprocess.run([sys.executable, "-c", GUARDED], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "IMPORTED" in out.stdout


def test_sources_import_neither_jax_nor_the_jax_package():
    pattern = re.compile(r"(import|from) +(jax|pil2_stark_tpu)([ .]|$)", re.M)
    files = sorted((REPO / "pil2_stark_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "ab_trees.py", REPO / "kernel_designs.py"]
    hits = [f"{f.relative_to(REPO)}: {m.group(0)}" for f in files
            for m in pattern.finditer(f.read_text())]
    assert not hits


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from pil2_stark_tpu_torch.stark import context, setup

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        context.resolve_device(None)
    data = setup.read_setup("fibonacci_6")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        setup.load_setup(data["starkInfo"], data["expressionsInfo"], data["verifierInfo"],
                         [[0, 0]] * 64)


def test_cuda_wrappers_refuse_other_devices():
    from pil2_stark_tpu_torch.hash import cuda_poseidon
    from pil2_stark_tpu_torch.ops import cuda_ntt

    x = torch.zeros((12, 4), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_poseidon.permute(x)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_ntt.base_grid(x.reshape(48, 1), 2, 12, False)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_ntt.base_rows(x.reshape(4, 12), 2, False)


def test_tool_wrappers_refuse_other_devices():
    from pil2_stark_tpu_torch.tools import exp_poseidon, exp_stream

    x = torch.zeros((12, 2048), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        exp_poseidon.permute_variant(x, "packed", 2048)
    with pytest.raises(ValueError, match="unsupported device"):
        exp_poseidon.build("packed-lazy-dual", 1, 2048)(x)
    with pytest.raises(ValueError, match="unsupported device"):
        exp_stream.build_stream(1)(x)
