"""PyTorch port, the EVM backend of the generated verifier (fflonk/evm.py),
held against the JAX package on the CPU: the contract's bytecode equals the
JAX compiler's, and the port's interpreter gives the JAX interpreter's
verdict and gas on the real proof, on corrupted calldata words and a wrong
public, and on a word at the field's modulus; the statement evaluator of
tests/test_solidity.py accepts the same proof (mirrors
tests/test_solidity.py:306-355)."""
import json

import pytest

from pil2_stark_tpu.fflonk import evm as jevm
from pil2_stark_tpu_torch.fflonk import evm
from pil2_stark_tpu_torch.fflonk import solidity as sol
from pil2_stark_tpu_torch.ops.fft_bn128 import FR

from test_solidity import SolRun
from torch_fflonk_chain import chain


@pytest.fixture(scope="module")
def words():
    """(the verification key, fflonkinfo, verifierinfo, the proof's
    calldata words, its publics)."""
    ch = chain()
    vk, res, info = ch["vk"], ch["res"], ch["info"]
    calldata = sol.export_calldata(vk, res["proof"], res["publics"])
    w = [int(x, 16) for x in json.loads(f"[{calldata}]")[0]]
    return vk, info["pilInfo"], info["verifierInfo"], w, [int(p) % FR for p in res["publics"]]


def test_bytecode_equals_jax(words):
    vk, fi, vi, w, pubs = words
    _, em, n_words, n_publics = sol.export_pilfflonk_verifier(vk, fi, vi, return_ops=True)
    code = evm.compile_verifier(em.ops, n_words, n_publics, em.n_slots)
    assert code == jevm.compile_verifier(em.ops, n_words, n_publics, em.n_slots)
    assert len(code) > 1000
    assert evm.encode_calldata(w, pubs) == jevm.encode_calldata(w, pubs)


def test_real_proof_verdict_and_gas_equal_jax(words):
    vk, fi, vi, w, pubs = words
    ok, gas = evm.run_verifier(vk, fi, vi, w, pubs)
    assert ok is True and 0 < gas < 100_000_000
    assert (ok, gas) == jevm.run_verifier(vk, fi, vi, w, pubs)


def test_corrupted_calldata_and_public_refused_as_in_jax(words):
    vk, fi, vi, w, pubs = words
    cases = []
    for idx in (0, len(w) - 3):
        bad = list(w)
        bad[idx] = (bad[idx] + 1) % FR
        cases.append((bad, pubs))
    cases.append((w, [(pubs[0] + 1) % FR] + pubs[1:]))
    for bad_w, bad_p in cases:
        got = evm.run_verifier(vk, fi, vi, bad_w, bad_p)
        assert got[0] is False
        assert got == jevm.run_verifier(vk, fi, vi, bad_w, bad_p)


def test_oversized_word_refused_as_in_jax(words):
    vk, fi, vi, w, pubs = words
    bad = list(w)
    bad[-1] = FR  # the modulus itself fails the Fr range check
    got = evm.run_verifier(vk, fi, vi, bad, pubs)
    assert got[0] is False and got == jevm.run_verifier(vk, fi, vi, bad, pubs)


def test_statement_evaluator_agrees(words):
    vk, fi, vi, w, pubs = words
    contract = sol.export_pilfflonk_verifier(vk, fi, vi)
    assert SolRun(contract, w, pubs).run() is True
    bad = list(w)
    bad[0] = (bad[0] + 1) % FR
    assert SolRun(contract, bad, pubs).run() is evm.run_verifier(vk, fi, vi, bad, pubs)[0]
