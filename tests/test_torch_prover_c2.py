"""PyTorch port, end to end on the CPU, on the paths no earlier case ran:
the boundary machine (constraints through the Zi rows of everyFrame,
firstRow and lastRow), fibonacci with hashCommits (the publics, the evals
and the last FRI polynomial absorbed as hashes), and the Poseidon VM (39
fixed, 12 witness and 21 Q columns, a Q program of 870 instructions).
Each proof equals the JAX package's backend="numpy" proof, with the same
challenges, and both verifiers accept it and reject a wrong public."""
import pytest
import torch

from pil2_stark_tpu.stark import verifier as jverifier
from pil2_stark_tpu_torch.stark import verifier as tverifier

from test_torch_cases import canon, prove_both

P = 0xFFFFFFFF00000001

@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch's multi-threaded int64 ops are slow on small CPU tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture(scope="module", params=["boundaries_6", "fibonacci_6_hash", "poseidon_vm_6"])
def proofs(request):
    return prove_both(request.param)


def test_proof_equals_jax(proofs):
    _, jres, _, tres = proofs
    assert canon(tres["proof"]) == canon(jres["proof"])
    assert tres["challenges"] == jres["challenges"]
    assert tres["challengesFRISteps"] == jres["challengesFRISteps"]


def test_both_verifiers_accept(proofs):
    js, _, ts, tres = proofs
    assert tverifier.verify(tres["proof"], tres["publics"], ts["constRoot"],
                            ts["starkInfo"], ts["verifierInfo"])
    assert jverifier.verify(tres["proof"], tres["publics"], js["constRoot"],
                            js["starkInfo"], js["verifierInfo"])


def test_verifiers_reject_wrong_public(proofs):
    js, _, ts, tres = proofs
    publics = list(tres["publics"])
    if publics:
        publics[-1] = (int(publics[-1]) + 1) % P
        args = (tres["proof"], publics)
    else:  # the VM has no publics: change an evaluation instead
        bad = dict(tres["proof"])
        bad["evals"] = [tuple(e) for e in bad["evals"]]
        bad["evals"][0] = ((bad["evals"][0][0] + 1) % P,) + tuple(bad["evals"][0][1:])
        args = (bad, publics)
    assert not tverifier.verify(*args, ts["constRoot"], ts["starkInfo"], ts["verifierInfo"])
    assert not jverifier.verify(*args, js["constRoot"], js["starkInfo"], js["verifierInfo"])
