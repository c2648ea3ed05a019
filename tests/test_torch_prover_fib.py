"""PyTorch port, end to end on the CPU: the fibonacci machine at 2^6, with
the normal and the split linear hash, gives proofs equal to the JAX
package's backend="numpy" proofs, the same challenges, and both verifiers
accept them — on the planar route, and on the row route the port takes
above 2^24 points (its planar ceiling lowered below 2^6)."""
import pytest

from pil2_stark_tpu.stark import verifier as jverifier
from pil2_stark_tpu_torch.ops import ntt
from pil2_stark_tpu_torch.stark import verifier as tverifier

from test_torch_cases import canon, prove_both, prove_port


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
