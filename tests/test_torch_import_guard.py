"""The PyTorch port stands alone: with `jax` and `pil2_stark_tpu` blocked
from import, every module of pil2_stark_tpu_torch imports and the port
proves and verifies fibonacci 2^6 on the CPU.  Its sources name neither
package in an import statement, and its entry points refuse to fall back
to the CPU when no card is there."""
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
from pil2_stark_tpu_torch.models import fibonacci
from pil2_stark_tpu_torch.stark import prover, setup, verifier
data = setup.read_setup("fibonacci_6")
const_cols, cm_cols, publics = fibonacci.build(data["references"], 64)
s = setup.load_setup(data["starkInfo"], data["expressionsInfo"], data["verifierInfo"],
                     const_cols.buffer, device="cpu")
res = prover.prove(s["starkInfo"], s["expressionsInfo"], const_cols.buffer, s["constTree"],
                   (cm_cols.buffer, publics), device="cpu")
assert verifier.verify(res["proof"], res["publics"], s["constRoot"], s["starkInfo"],
                       s["verifierInfo"])
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
