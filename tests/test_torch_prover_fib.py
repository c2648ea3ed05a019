"""PyTorch port, end to end on the CPU: the fibonacci machine at 2^6, with
the normal and the split linear hash, gives proofs equal to the JAX
package's backend="numpy" proofs, the same challenges, and both verifiers
accept them — on the planar route, and on the row route the port takes
above 2^24 points (its planar ceiling lowered below 2^6).  A setup that the
port's own compiler made (stark.setup.stark_setup) proves the same, and two
proves from it share the fixed columns that the const tree keeps on the
device instead of uploading them again (fault C3)."""
import copy

import numpy as np
import pytest
import torch

from pil2_stark_tpu.stark import verifier as jverifier
from pil2_stark_tpu_torch.field import torch_gl
from pil2_stark_tpu_torch.ops import ntt
from pil2_stark_tpu_torch.stark import catalog, context, prover as tprover
from pil2_stark_tpu_torch.stark import setup as tsetup, verifier as tverifier

from test_torch_cases import canon, case_inputs, prove_both, prove_port


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch's multi-threaded int64 ops are slow on small CPU tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["fibonacci_6", "fibonacci_6_split"])
def case(request):
    return request.param


@pytest.fixture(scope="module")
def proofs(case):
    return prove_both(case)


def test_proof_equals_jax(proofs):
    _, jres, _, tres = proofs
    assert canon(tres["proof"]) == canon(jres["proof"])


def test_challenges_equal_jax(proofs):
    _, jres, _, tres = proofs
    assert tres["challenges"] == jres["challenges"]
    assert tres["challengesFRISteps"] == jres["challengesFRISteps"]


def test_both_verifiers_accept(proofs):
    js, _, ts, tres = proofs
    assert tverifier.verify(tres["proof"], tres["publics"], ts["constRoot"],
                            ts["starkInfo"], ts["verifierInfo"])
    assert jverifier.verify(tres["proof"], tres["publics"], js["constRoot"],
                            js["starkInfo"], js["verifierInfo"])


@pytest.fixture(scope="module")
def row_proofs(case):
    """The port's proof through the row route: with the planar ceiling at
    2^5 and the row base at 2^3, the 2^6 and 2^9 transforms go through
    axis0_ntt's four-step recursion (split, level twiddles, transpose)."""
    calls = []
    real_axis0 = ntt.axis0_ntt
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ntt, "MAX_BITS", 5)
        mp.setattr(ntt, "BASE_BITS", 3)
        mp.setattr(ntt, "axis0_ntt", lambda x, b, inv: calls.append(b) or real_axis0(x, b, inv))
        ts, tres = prove_port(case)
    return calls, ts, tres


def test_row_route_proof_equals_jax(proofs, row_proofs):
    _, jres, _, _ = proofs
    calls, _, tres = row_proofs
    assert {6, 9} <= set(calls)  # the LDEs, the Q split and the evals took rows
    assert canon(tres["proof"]) == canon(jres["proof"])


def test_row_route_both_verifiers_accept(proofs, row_proofs):
    js = proofs[0]
    _, ts, tres = row_proofs
    assert tverifier.verify(tres["proof"], tres["publics"], ts["constRoot"],
                            ts["starkInfo"], ts["verifierInfo"])
    assert jverifier.verify(tres["proof"], tres["publics"], js["constRoot"],
                            js["starkInfo"], js["verifierInfo"])



@pytest.fixture(scope="module")
def fresh_proofs(case):
    """Two proves from one setup that the port compiled, each with the
    prover context it made and the fixed-column uploads it did."""
    _, const_cols, cm_cols, publics = case_inputs(case)
    machine, n_bits, ss = catalog.CASES[case]
    fixed = const_cols.buffer
    s = tsetup.stark_setup(fixed, catalog.machine_pil(machine, n_bits), copy.deepcopy(ss),
                           device="cpu")
    runs = []
    with pytest.MonkeyPatch.context() as mp:
        real_from_u64, real_ctx = torch_gl.from_u64, context.ProverCtx

        def from_u64(a, device=None):
            arr = np.asarray(a)
            if arr.shape == fixed.T.shape and np.array_equal(arr, fixed.T):
                runs[-1]["uploads"] += 1
            return real_from_u64(a, device)

        class Ctx(real_ctx):
            def __init__(self, *args, **kwargs):
                runs[-1]["ctx"] = self
                super().__init__(*args, **kwargs)

        mp.setattr(torch_gl, "from_u64", from_u64)
        mp.setattr(tprover, "ProverCtx", Ctx)
        for _ in range(2):
            runs.append({"uploads": 0})
            runs[-1]["res"] = tprover.prove(s["starkInfo"], s["expressionsInfo"], fixed,
                                            s["constTree"], (cm_cols.buffer, publics),
                                            device="cpu")
    return s, runs


def test_fresh_setup_proof_equals_jax(proofs, fresh_proofs):
    js, jres, _, _ = proofs
    s, runs = fresh_proofs
    np.testing.assert_array_equal(s["constRoot"], js["constRoot"])
    for run in runs:
        assert canon(run["res"]["proof"]) == canon(jres["proof"])
        assert run["res"]["challenges"] == jres["challenges"]
    tres = runs[0]["res"]
    assert tverifier.verify(tres["proof"], tres["publics"], s["constRoot"], s["starkInfo"],
                            s["verifierInfo"])


def test_proves_share_the_setup_fixed_columns(fresh_proofs):
    """C3: the const tree keeps the (nConstants, N) fixed columns on the
    device; each prove reads that tensor and uploads them zero times."""
    s, runs = fresh_proofs
    base = s["constTree"].base
    assert base.shape == (s["starkInfo"]["nConstants"], 1 << s["starkInfo"]["starkStruct"]["nBits"])
    for run in runs:
        assert run["uploads"] == 0
        assert run["ctx"].dsections["n"]["const"].data_ptr() == base.data_ptr()
    np.testing.assert_array_equal(torch_gl.to_u64(base), s["fixedPols"].T)
