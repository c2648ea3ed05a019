"""The recursive proof on the CPU: the smallest chain's C12 machine (a
fibonacci 2^4 / ext 2^7 proof verified inside a 2^11-row C12 of 12
committed and 36 fixed columns, blowup 2) set up and proved by the port
(device="cpu") and by the JAX package (backend="numpy") from the same
pil, fixed columns, witness and publics.  The proofs must be equal bit
for bit, both verifiers must accept it, and a witness with one corrupted
wire must give the same non-empty error list in both debug proves."""
import copy

import numpy as np
import pytest
import torch

from pil2_stark_tpu.compiler import pilinfo as jpilinfo
from pil2_stark_tpu.stark import prover as jprover, setup as jsetup, verifier as jverifier
from pil2_stark_tpu_torch.compiler import circom_front as tcf, compressor12 as tc12
from pil2_stark_tpu_torch.compiler import pilinfo as tpilinfo
from pil2_stark_tpu_torch.stark import prover as tprover, setup as tsetup
from pil2_stark_tpu_torch.stark import verifier as tverifier

from test_torch_cases import canon
from test_torch_recursion_cases import P, c12_struct, circuit_files, inner_proof, jax_host_trees


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def machine():
    """The C12 machine of the smallest chain: (setup, witness columns,
    publics)."""
    s, _, zkin = inner_proof()
    _, files = circuit_files(s)
    cc = tcf.compile_and_witness(files, "verifier.circom", zkin)
    assert cc.check()
    c12 = tc12.setup(cc)
    cm = tc12.exec_witness(cc.witness, c12["plonkAdditions"], c12["sMap"], c12["nBits"])
    return c12, cm, [int(x) for x in cc.witness[1:1 + c12["nPublics"]]]


@pytest.fixture(scope="module")
def proofs(machine):
    c12, cm, publics = machine
    ss = c12_struct(c12["nBits"])
    ts = tsetup.stark_setup(c12["constBuffer"], c12["pil"], copy.deepcopy(ss), device="cpu")
    tres = tprover.prove(ts["starkInfo"], ts["expressionsInfo"], c12["constBuffer"],
                         ts["constTree"], (cm, publics), device="cpu")
    with jax_host_trees():
        js = jsetup.stark_setup(c12["constBuffer"], c12["pil"], copy.deepcopy(ss))
        jres = jprover.prove(js["starkInfo"], js["expressionsInfo"], c12["constBuffer"],
                             js["constTree"], (cm, publics), backend="numpy")
    return js, jres, ts, tres


def test_c12_machine_shape(machine, proofs):
    c12, cm, publics = machine
    ts = proofs[2]
    info = ts["starkInfo"]
    assert (c12["nBits"], info["starkStruct"]["nBitsExt"]) == (11, 12)
    assert cm.shape == (2048, 12) and len(info["constPolsMap"]) == 36
    assert info["qDeg"] == 2 and len(publics) == 3


def test_recursive_proof_equals_jax(proofs):
    js, jres, ts, tres = proofs
    np.testing.assert_array_equal(np.asarray(ts["constRoot"], dtype=np.uint64),
                                  np.asarray(js["constRoot"], dtype=np.uint64))
    assert canon(tres["proof"]) == canon(jres["proof"])
    assert tres["challenges"] == jres["challenges"]
    assert tres["challengesFRISteps"] == jres["challengesFRISteps"]


def test_both_verifiers_accept(proofs):
    js, _, ts, tres = proofs
    assert tverifier.verify(tres["proof"], tres["publics"], ts["constRoot"],
                            ts["starkInfo"], ts["verifierInfo"])
    assert jverifier.verify(tres["proof"], tres["publics"], js["constRoot"],
                            js["starkInfo"], js["verifierInfo"])
    bad = list(tres["publics"])
    bad[0] = (int(bad[0]) + 1) % P
    assert not tverifier.verify(tres["proof"], bad, ts["constRoot"], ts["starkInfo"],
                                ts["verifierInfo"])


def test_corrupted_wire_gives_the_same_debug_errors(machine):
    """One wire of a custom-gate row changed (tests/test_compressor12.py:63)."""
    c12, cm, publics = machine
    bad = cm.copy()
    row = int(np.argmax(c12["sMap"][3][c12["nPublics"] // 12 + 1:])) + 1
    bad[row, 3] = (int(bad[row, 3]) + 1) % P
    errors = []
    for pilinfo, prove, kw in ((tpilinfo, tprover.prove, {"device": "cpu"}),
                               (jpilinfo, jprover.prove, {})):
        info = pilinfo.pil_info(c12["pil"], True, {}, {"debug": True})
        errors.append(prove(info["pilInfo"], info["expressionsInfo"], c12["constBuffer"], None,
                            (bad, publics), debug=True, **kw))
    assert errors[0] != [] and errors[0] == errors[1]


def test_t1_generated_code_equals_plain_on_the_c12_programs(proofs, tmp_path):
    """Kernel T1's generated rows for the C12's im-pol, Q (about 2,900
    instructions: the Poseidon custom gates) and FRI programs, built with
    the host's g++ as tests/test_torch_tac_codegen.py does, equal
    run_plain on random inputs at 2^6 / 2^5 rows."""
    import test_torch_tac_codegen as tc
    from pil2_stark_tpu_torch.field import torch_gl
    from pil2_stark_tpu_torch.ops import torch_tac

    info, ei = proofs[2]["starkInfo"], proofs[2]["expressionsInfo"]
    progs = {}
    for which in torch_tac.PROGRAMS:
        code, dom = torch_tac.device_program(info, ei, which)
        n_bits = 6 if dom == "n" else 5
        progs[which] = (dom, torch_tac.compile_program(code, dom, info, n_bits, n_bits + 1))
    assert sorted(progs) == ["fri", "imPols", "q"]
    lib = tc.compile_host({w: prog for w, (_, prog) in progs.items()}, tmp_path)
    rng = np.random.default_rng(5)

    def rand(*shape):
        return torch_gl.from_u64(rng.integers(0, P, size=shape, dtype=np.uint64), "cpu")

    for which, (dom, prog) in progs.items():
        n = prog.n
        sections = {"const": rand(info["nConstants"], n)}
        for i in range(info["nStages"] + (1 if dom == "ext" else 0)):
            sections[f"cm{i + 1}"] = rand(info["mapSectionsN"][f"cm{i + 1}"], n)
        inputs = {"sections": sections, "x": rand(n), "Zi": rand(len(info["boundaries"]), n),
                  "xDivXSubXi": rand(len(info["openingPoints"]), 3, n),
                  "publics": rand(info["nPublics"]), "challenges": rand(len(info["challengesMap"]), 3),
                  "evals": rand(len(info["evMap"]), 3)}
        tc._assert_equal(tc.run_host(lib, which, prog, inputs), torch_tac.run_plain(prog, inputs))
