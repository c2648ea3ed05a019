"""PyTorch port, end to end on the CPU: the all-gadgets machine at 2^8
(plookup, permutation and connection hints, three commit stages, the imPol
device splice) gives a proof equal to the JAX package's backend="numpy"
proof, the same challenges, and both verifiers accept it."""
import pytest

from pil2_stark_tpu.stark import verifier as jverifier
from pil2_stark_tpu_torch.stark import verifier as tverifier

from test_torch_cases import canon, prove_both


@pytest.fixture(scope="module")
def proofs():
    return prove_both("all_8")


def test_proof_equals_jax(proofs):
    _, jres, _, tres = proofs
    assert canon(tres["proof"]) == canon(jres["proof"])
    assert tres["publics"] == jres["publics"]


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


def test_port_verifier_rejects_a_changed_eval(proofs):
    import copy

    _, _, ts, tres = proofs
    bad = copy.deepcopy(tres["proof"])
    e = bad["evals"][0]
    bad["evals"][0] = ((e[0] + 1) % 0xFFFFFFFF00000001, e[1], e[2])
    assert not tverifier.verify(bad, tres["publics"], ts["constRoot"],
                                ts["starkInfo"], ts["verifierInfo"])
