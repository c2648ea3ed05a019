"""The port's BN128 verifier circuit (compiler/pil2circom_bn128.py on
compiler/circom_gadgets_bn128.py) against the JAX package's on the CPU.

- The Poseidon-BN and Merkle-BN gadgets (the same text in both packages)
  go through the port's circom front-end over BN254-Fr, as in
  tests/test_circom_bn128.py: the Poseidon outputs equal the host
  permutation, a Merkle path checks and a wrong root is refused.
- One proof: fibonacci 2^6 / ext 2^9 with BN128 trees at arity 16 and 4
  queries (the struct of tests/test_circom_bn128.py), proved by the port
  on the CPU; its zkin equals the JAX package's proof's.  Both packages'
  pil2circom emit the same circuit for it, and for the merkleTreeCustom
  setup (arity 4, the custom struct of that file).
- Under the ``slow`` marker (the circuit has 178,274 constraints; the
  front-end takes minutes): the port's front-end accepts the port's
  proof in each circuit and refuses a corrupted zkin.  chip_smoke.py's
  snark phase runs the same check on every chip run."""
import copy
import json

import numpy as np
import pytest
import torch

from pil2_stark_tpu.compiler import circom_gadgets_bn128 as jgbn
from pil2_stark_tpu.compiler import pil2circom as jp2c
from pil2_stark_tpu.stark import prover as jprover, setup as jsetup
from pil2_stark_tpu.utils.proof2zkin import proof2zkin as jproof2zkin
from pil2_stark_tpu_torch.compiler import circom_front as cf, circom_gadgets_bn128 as gbn
from pil2_stark_tpu_torch.compiler import pil2circom
from pil2_stark_tpu_torch.hash import merkle_bn128, poseidon_bn128
from pil2_stark_tpu_torch.models import fibonacci
from pil2_stark_tpu_torch.stark import prover, setup as stark_setup, verifier
from pil2_stark_tpu_torch.utils.proof2zkin import proof2zkin

from test_torch_cases import case_inputs

P_GL = 0xFFFFFFFF00000001
# custom False: the arity-16 Poseidon sponge; custom True: every hash on the
# PoseidonT custom gate, at arity 4 (t = 5, the widest the final9 machine
# lays out)
STRUCTS = {False: {"merkleTreeArity": 16},
           True: {"merkleTreeArity": 4, "merkleTreeCustom": True}}


def bn128_struct(custom):
    return dict(copy.deepcopy(fibonacci.STARK_STRUCT), verificationHashType="BN128",
                nQueries=4, **STRUCTS[custom])


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch's multi-threaded int64 ops are slow on small CPU tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _poseidon_main():
    lib = gbn.gen_bit_utils() + gbn.gen_gl_lib() + gbn.gen_poseidon_bn([17])
    assert lib == jgbn.gen_bit_utils() + jgbn.gen_gl_lib() + jgbn.gen_poseidon_bn([17])
    return "pragma circom 2.1.0;\n" + lib + """
template Main() {
    signal input inputs[16];
    signal input st;
    signal output out[17];
    out <== PoseidonBN17()(inputs, st);
}
component main = Main();
"""


def test_poseidon_bn_gadget_equals_host():
    rng = np.random.default_rng(11)
    ins = [int.from_bytes(rng.bytes(32), "little") % poseidon_bn128.P for _ in range(16)]
    cc = cf.compile_and_witness({"m.circom": _poseidon_main()}, "m.circom",
                                {"inputs": ins, "st": 7}, prime=cf.BN254_FR)
    assert cc.check()
    assert [cc.witness[i] for i in range(1, 18)] == poseidon_bn128.poseidon(ins, 7, 17)


def test_merkle_bn_gadget_path():
    width, height = 7, 64
    rng = np.random.default_rng(3)
    buff = rng.integers(0, P_GL, size=(height, width), dtype=np.uint64)
    tree = merkle_bn128.merkelize(buff, width, height, arity=16)
    idx = 37
    values, proof = merkle_bn128.get_group_proof(tree, idx)
    n_levels = len(proof)
    gens = lambda m: (m.gen_bit_utils() + m.gen_gl_lib()  # noqa: E731
                      + m.gen_poseidon_bn([17, -(-((width + 2) // 3)) + 1])
                      + m.gen_one_hot(4) + m.gen_linear_hash_bn(width)
                      + m.gen_verify_merkle_bn(width, n_levels))
    lib = gens(gbn)
    assert lib == gens(jgbn)
    main = "pragma circom 2.1.0;\n" + lib + f"""
template Main() {{
    signal input values[{width}];
    signal input siblings[{n_levels}][16];
    signal input key[{n_levels * 4}];
    signal input root;
    VerifyMerkleBN{width}_{n_levels}()(values, siblings, key, root, 1);
}}
component main = Main();
"""
    inputs = {"values": [int(v) for v in values],
              "siblings": [[int(x) for x in s] for s in proof],
              "key": [(idx >> b) & 1 for b in range(n_levels * 4)],
              "root": int(tree.root)}
    cc = cf.compile_and_witness({"m.circom": main}, "m.circom", inputs, prime=cf.BN254_FR)
    assert cc.check()
    with pytest.raises(AssertionError):
        cf.compile_and_witness({"m.circom": main}, "m.circom", dict(inputs, root=int(tree.root) + 1),
                               prime=cf.BN254_FR)


def bn128_proof(custom, device="cpu"):
    """(setup, result, zkin) of fibonacci 2^6 with BN128 trees proved by the
    port; the zkin carries the publics."""
    pil, const_cols, cm_cols, publics = case_inputs("fibonacci_6")
    s = stark_setup.stark_setup(const_cols.buffer, copy.deepcopy(pil), bn128_struct(custom),
                                device=device)
    res = prover.prove(s["starkInfo"], s["expressionsInfo"], const_cols.buffer, s["constTree"],
                       (cm_cols.buffer, publics), device=device)
    zkin = proof2zkin(res["proof"], s["starkInfo"])
    zkin["publics"] = [int(p) for p in res["publics"]]
    return s, res, zkin


@pytest.fixture(scope="module")
def plain():
    """The port's proof (custom False) and the JAX package's of the same
    inputs, with their zkins."""
    s, res, zkin = bn128_proof(False)
    pil, const_cols, cm_cols, publics = case_inputs("fibonacci_6")
    js = jsetup.stark_setup(const_cols.buffer, copy.deepcopy(pil), bn128_struct(False))
    jres = jprover.prove(js["starkInfo"], js["expressionsInfo"], const_cols.buffer,
                         js["constTree"], (cm_cols.buffer, publics), backend="numpy")
    jzkin = jproof2zkin(jres["proof"], js["starkInfo"])
    jzkin["publics"] = [int(p) for p in jres["publics"]]
    return s, res, zkin, js, jzkin


def test_the_ports_proof_and_zkin_equal_jax(plain):
    s, res, zkin, js, jzkin = plain
    assert s["constRoot"] == js["constRoot"]
    assert json.dumps(zkin, default=str) == json.dumps(jzkin, default=str)
    assert verifier.verify(res["proof"], res["publics"], s["constRoot"], s["starkInfo"],
                           s["verifierInfo"])


@pytest.mark.parametrize("custom", [False, True])
def test_circuit_text_equals_jax(plain, custom):
    if custom:
        pil, const_cols, _, _ = case_inputs("fibonacci_6")
        s = stark_setup.stark_setup(const_cols.buffer, copy.deepcopy(pil), bn128_struct(True),
                                    device="cpu")
    else:
        s = plain[0]
    args = (s["constRoot"], s["starkInfo"], s["verifierInfo"])
    src = pil2circom.pil2circom(*args)
    assert src == jp2c.pil2circom(*args)
    assert f"signal rootC <== {s['constRoot']};" in src
    assert ("template custom PoseidonT(t)" in src) is custom
    assert ("PoseidonBN17" in src) is not custom


@pytest.mark.slow
@pytest.mark.parametrize("custom", [False, True])
def test_bn128_verifier_accepts_the_ports_proof(plain, custom):
    s, _, zkin = plain[:3] if not custom else bn128_proof(True)
    src = pil2circom.pil2circom(s["constRoot"], s["starkInfo"], s["verifierInfo"])
    files = {"verifier.circom": src}
    cc = cf.compile_and_witness(files, "verifier.circom", zkin, prime=cf.BN254_FR)
    assert cc.check()
    assert cc.n_pub_inputs == s["starkInfo"]["nPublics"]
    if custom:
        assert "PoseidonT" in [g["template"] for g in cc.custom_gates] and cc.custom_uses
    bad = dict(zkin, evals=[list(e) for e in zkin["evals"]])
    bad["evals"][0][0] = (bad["evals"][0][0] + 1) % P_GL
    with pytest.raises(AssertionError):
        cf.compile_and_witness(files, "verifier.circom", bad, prime=cf.BN254_FR)
