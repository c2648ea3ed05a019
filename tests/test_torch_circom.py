"""The port's verifier-circuit generator (compiler/pil2circom.py, on the
gadget library compiler/circom_gadgets.py) and its circom front-end
(compiler/circom_front.py) against the JAX package's: the same circuit
text for the committed fibonacci_6, fibonacci_6_hash and
fibonacci_6_split setups (and for fibonacci 2^22 / ext 2^25 with its FRI
ending at 4 bits, the card's recursion path), the same gadget library,
and, on the smallest chain's circuit and zkin, the same witness,
constraints, custom gates and their uses; a corrupted zkin raises in
both.  A BN128 starkinfo with a Goldilocks (four-element) root is refused
by both packages: the BN128 circuit (tests/test_torch_circom_bn128.py)
takes one BN254 root."""
import copy

import numpy as np
import pytest
import torch

from pil2_stark_tpu.compiler import circom_front as jcf, circom_gadgets as jgad
from pil2_stark_tpu.compiler import pil2circom as jp2c
from pil2_stark_tpu_torch.compiler import circom_front as tcf, circom_gadgets as tgad
from pil2_stark_tpu_torch.compiler import pil2circom as tp2c
from pil2_stark_tpu_torch.stark import setup as tsetup

from test_torch_recursion_cases import P, circuit_files, inner_proof
from test_torch_setups import jax_columns, machine_pil


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch's multi-threaded int64 ops are slow on small CPU tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def chain():
    """The smallest chain's circuit from each package and both front-ends'
    results on the same zkin."""
    s, _, zkin = inner_proof()
    jfiles, tfiles = circuit_files(s)
    jcc = jcf.compile_and_witness(jfiles, "verifier.circom", zkin)
    tcc = tcf.compile_and_witness(tfiles, "verifier.circom", zkin)
    return s, zkin, jfiles, tfiles, jcc, tcc


def test_gadget_library_equals_jax():
    assert tgad.emit_gadget_files() == jgad.emit_gadget_files()


@pytest.mark.parametrize("name", ["fibonacci_6", "fibonacci_6_hash", "fibonacci_6_split"])
def test_circuit_text_equals_jax_on_committed_setups(name):
    data = tsetup.read_setup(name)
    const_cols = jax_columns("fibonacci", machine_pil("fibonacci", 6), 64)[0]
    s = tsetup.load_setup(data["starkInfo"], data["expressionsInfo"], data["verifierInfo"],
                          const_cols.buffer, device="cpu")
    args = ([int(v) for v in s["constRoot"]], data["starkInfo"], data["verifierInfo"])
    files = tp2c.emit_circuit_files(*args)
    assert files == jp2c.emit_circuit_files(*args)
    assert f"StarkVerifier0" in files["verifier.circom"]


def test_circuit_text_equals_jax_at_the_card_size():
    """fibonacci 2^22 / ext 2^25, 32 queries, FRI 25, 22, ..., 4: the
    inner proof of chip_smoke.py's recursion phase (text only)."""
    data = tsetup.read_setup("fibonacci_22")
    info = copy.deepcopy(data["starkInfo"])
    info["starkStruct"]["steps"] = info["starkStruct"]["steps"][:-1]
    root = [11, 22, 33, 44]
    text = tp2c.pil2circom(root, info, data["verifierInfo"])
    assert text == jp2c.pil2circom(root, info, data["verifierInfo"])


def test_front_end_equals_jax(chain):
    _, zkin, jfiles, tfiles, jcc, tcc = chain
    assert tfiles == jfiles
    assert tcc.check() and jcc.check()
    assert tcc.witness == jcc.witness
    assert tcc.constraints == jcc.constraints
    assert tcc.custom_gates == jcc.custom_gates
    assert tcc.custom_uses == jcc.custom_uses
    assert (tcc.n_vars, tcc.n_outputs, tcc.n_pub_inputs, tcc.prime) == (
        jcc.n_vars, jcc.n_outputs, jcc.n_pub_inputs, jcc.prime)
    # the publics sit at witness 1..nPublics
    assert tcc.n_pub_inputs + tcc.n_outputs == len(zkin["publics"])
    assert tcc.witness[1:1 + len(zkin["publics"])] == zkin["publics"]
    assert len(tcc.custom_uses) > 0


def test_corrupted_zkin_raises_in_both(chain):
    _, zkin, jfiles, tfiles, _, _ = chain
    bad = dict(zkin)
    bad["evals"] = copy.deepcopy(zkin["evals"])
    bad["evals"][0][0] = (int(bad["evals"][0][0]) + 1) % P
    for cf, files in ((jcf, jfiles), (tcf, tfiles)):
        with pytest.raises(AssertionError, match="failed numerically"):
            cf.compile_and_witness(files, "verifier.circom", bad)


def test_bn128_starkinfo_is_refused(chain):
    s = chain[0]
    info = copy.deepcopy(s["starkInfo"])
    info["starkStruct"]["verificationHashType"] = "BN128"
    for p2c in (jp2c, tp2c):
        with pytest.raises(TypeError, match="not 'list'"):
            p2c.emit_circuit_files([1, 2, 3, 4], info, s["verifierInfo"])


def test_witness_is_canonical(chain):
    tcc = chain[-1]
    w = np.array(tcc.witness, dtype=object)
    assert all(0 <= int(x) < P for x in w) and int(w[0]) == 1
