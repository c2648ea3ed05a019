"""PyTorch port, end to end on the CPU: the fibonacci machine at 2^6, with
the normal and the split linear hash, gives proofs equal to the JAX
package's backend="numpy" proofs, the same challenges, and both verifiers
accept them."""
import pytest

from pil2_stark_tpu.stark import verifier as jverifier
from pil2_stark_tpu_torch.stark import verifier as tverifier

from test_torch_cases import canon, prove_both


@pytest.fixture(scope="module", params=["fibonacci_6", "fibonacci_6_split"])
def proofs(request):
    return prove_both(request.param)


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
