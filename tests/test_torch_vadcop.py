"""PyTorch port, vadcop on the CPU: the two fibv airs (Module and
Fibonacci, coupled by a gsum argument) proved under one set of external
challenges (prove(external_challenges=)) give the JAX package's proofs bit
for bit, subproof values included; both verifiers accept each proof with
those challenges and reject wrong publics; and
verify_global_constraints accepts the proofs' subproof values and rejects
a changed one, with the JAX package's failure list.  The airs' setups and
the global constraint's code are the committed setups/fibv_*.json (equal to
a fresh compile by tests/test_torch_setups.py)."""
import copy

import numpy as np
import pytest
import torch

from pil2_stark_tpu.hash import merkle as jmerkle
from pil2_stark_tpu.ops import ntt as jntt
from pil2_stark_tpu.stark import prover as jprover, verifier as jverifier
from pil2_stark_tpu_torch.models import fibv as tfibv
from pil2_stark_tpu_torch.stark import prover as tprover, setup as tsetup, verifier as tverifier

from test_torch_cases import canon

P = 0xFFFFFFFF00000001
AIRS = ("fibv_module", "fibv_fibonacci")

@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch's multi-threaded int64 ops are slow on small CPU tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def ext_challenges(rng, pil_info, ss):
    """tests/test_vadcop.py::_ext_challenges."""
    stages = []
    for stage in range(1, pil_info["nStages"] + 4):
        n = sum(1 for c in pil_info["challengesMap"] if c["stage"] == stage)
        stages.append([tuple(int(rng.integers(0, 1 << 63)) % P for _ in range(3))
                       for _ in range(n)])
    fri = [tuple(int(rng.integers(0, 1 << 63)) % P for _ in range(3))
           for _ in range(len(ss["steps"]) + 1)]
    return {"stages": stages, "friSteps": fri}


@pytest.fixture(scope="module")
def proofs():
    cm_mod, cm_fib, publics = tfibv.execute(101, 1, 2)
    setups = {name: tsetup.read_setup(name) for name in AIRS}
    info = setups["fibv_fibonacci"]["starkInfo"]
    ext = ext_challenges(np.random.default_rng(7), info, info["starkStruct"])
    out = {}
    for name, cm in zip(AIRS, (cm_mod, cm_fib)):
        data = setups[name]
        fixed = np.asarray(data["fixedPols"], dtype=np.uint64)
        ss = data["starkInfo"]["starkStruct"]
        jtree = jmerkle.merkelize(jntt.lde_u64(fixed, ss["nBits"], ss["nBitsExt"]),
                                  fixed.shape[1], 1 << ss["nBitsExt"])
        jres = jprover.prove(data["starkInfo"], data["expressionsInfo"], fixed, jtree,
                             (cm, publics), external_challenges=copy.deepcopy(ext))
        ts = tsetup.load_setup(data["starkInfo"], data["expressionsInfo"], data["verifierInfo"],
                               fixed, device="cpu")
        tres = tprover.prove(ts["starkInfo"], ts["expressionsInfo"], fixed, ts["constTree"],
                             (cm, publics), device="cpu", external_challenges=ext)
        out[name] = (data, jtree.root, jres, ts, tres)
    return out


@pytest.mark.parametrize("name", AIRS)
def test_proof_equals_jax(proofs, name):
    _, _, jres, _, tres = proofs[name]
    assert canon(tres["proof"]) == canon(jres["proof"])
    assert tres["challenges"] == jres["challenges"]
    assert tres["challengesFRISteps"] == jres["challengesFRISteps"]
    assert len(tres["proof"]["subproofValues"]) == 1


@pytest.mark.parametrize("name", AIRS)
def test_both_verifiers_accept_and_reject_wrong_publics(proofs, name):
    data, jroot, _, ts, tres = proofs[name]
    np.testing.assert_array_equal(ts["constRoot"], jroot)
    ch = (tres["challenges"], tres["challengesFRISteps"])
    args = (ts["constRoot"], data["starkInfo"], data["verifierInfo"])
    assert tverifier.verify(tres["proof"], tres["publics"], *args, challenges=ch)
    assert jverifier.verify(tres["proof"], tres["publics"], *args, challenges=ch)
    bad = [(int(p) + 1) % P for p in tres["publics"]]
    assert not tverifier.verify(tres["proof"], bad, *args, challenges=ch)
    assert not jverifier.verify(tres["proof"], bad, *args, challenges=ch)


def test_global_constraints(proofs):
    codes = tsetup.read_setup("fibv_global")["constraints"]
    assert len(codes) == 1
    sv = [proofs[name][4]["proof"]["subproofValues"] for name in AIRS]
    assert tverifier.verify_global_constraints(codes, sv) == []
    assert jverifier.verify_global_constraints(codes, sv) == []
    # breaking the coupling breaks the cross-subproof sum
    bad = [[tuple((int(x) + 1) % P for x in sv[0][0])], sv[1]]
    failures = tverifier.verify_global_constraints(codes, bad)
    assert failures
    assert failures == jverifier.verify_global_constraints(codes, bad)
