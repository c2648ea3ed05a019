"""PyTorch port on the CPU: prove(debug=True) checks each stage's
constraints on the base domain and returns the same error list as the JAX
package's debug prove, on valid witnesses and on witnesses with one
flipped element (tests/test_poseidon_vm.py:47 style): the boundary
machine, the Poseidon VM and both fibv airs, from the committed debug
setups (setups/*_debug.json, equal to a fresh compile by
tests/test_torch_setups.py)."""
import numpy as np
import pytest
import torch

from pil2_stark_tpu.stark import prover as jprover
from pil2_stark_tpu_torch.models import fibv as tfibv
from pil2_stark_tpu_torch.stark import prover as tprover, setup as tsetup

from test_torch_cases import case_inputs

@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch's multi-threaded int64 ops are slow on small CPU tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _witness(name):
    """(debug setup, fixed columns, stage-1 columns, publics)."""
    if name.startswith("fibv"):
        cm_mod, cm_fib, publics = tfibv.execute(101, 1, 2)
        fixed = np.asarray(tsetup.read_setup(name)["fixedPols"], dtype=np.uint64)
        cm = cm_mod if name == "fibv_module" else cm_fib
        return tsetup.read_setup(f"{name}_debug"), fixed, cm, publics
    _, const_cols, cm_cols, publics = case_inputs(name)
    return tsetup.read_setup(f"{name}_debug"), const_cols.buffer, cm_cols.buffer, publics


@pytest.fixture(scope="module", params=["boundaries_6", "poseidon_vm_6", "fibv_module",
                                        "fibv_fibonacci"])
def case(request):
    return (request.param,) + _witness(request.param)


def _both(setup, fixed, cm, publics):
    info, exprs = setup["starkInfo"], setup["expressionsInfo"]
    want = jprover.prove(info, exprs, fixed, None, (cm, publics), debug=True)
    got = tprover.prove(info, exprs, fixed, None, (cm, publics), debug=True, device="cpu")
    return got, want


def test_debug_valid_witness(case):
    _, setup, fixed, cm, publics = case
    got, want = _both(setup, fixed, cm, publics)
    assert want == []
    assert got == want


def test_debug_flipped_element(case):
    name, setup, fixed, cm, publics = case
    bad = cm.copy()
    row = 7 if len(bad) > 7 else 3
    bad[row, 0] ^= np.uint64(1)
    got, want = _both(setup, fixed, bad, publics)
    assert want, name
    assert got == want
