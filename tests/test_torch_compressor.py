"""The port's R1CS reader (utils/r1cs.py), R1CS-to-PlonK converter
(compiler/r1cs2plonk.py) and compressors (compiler/compressor.py, the
plain a/b/c PlonK machine; compiler/compressor12.py and compressor18.py,
the recursion machines) against the JAX package's, on the same inputs:
an .r1cs file written here in the iden3 layout from the smallest chain's
circuit, and that circuit (the port's front-end; test_torch_circom.py
holds it to the JAX one).  Every output is an integer, so equality is
exact: the PIL source and compiled pil, constBuffer, sMap, plonkAdditions,
nBits, nPublics, exec_witness and the exec file's bytes."""
import dataclasses
import struct

import numpy as np
import pytest
import torch

from pil2_stark_tpu.compiler import compressor as jcomp, compressor12 as jc12
from pil2_stark_tpu.compiler import compressor18 as jc18, pil1_parser as jparser
from pil2_stark_tpu.compiler import r1cs2plonk as jr2p
from pil2_stark_tpu.utils import r1cs as jr1cs
from pil2_stark_tpu_torch.compiler import circom_front as tcf
from pil2_stark_tpu_torch.compiler import compressor as tcomp, compressor12 as tc12
from pil2_stark_tpu_torch.compiler import compressor18 as tc18, pil1_parser as tparser
from pil2_stark_tpu_torch.compiler import r1cs2plonk as tr2p
from pil2_stark_tpu_torch.utils import r1cs as tr1cs

from test_torch_recursion_cases import P, circuit_files, inner_proof


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def circuit():
    s, _, zkin = inner_proof()
    _, files = circuit_files(s)
    cc = tcf.compile_and_witness(files, "verifier.circom", zkin)
    assert cc.check()
    return cc


@pytest.fixture(scope="module", params=["c12", "c18"])
def compressed(request, circuit):
    """(jax module, port module, jax setup, port setup) of one compressor."""
    jmod, tmod = (jc12, tc12) if request.param == "c12" else (jc18, tc18)
    return jmod, tmod, jmod.setup(circuit), tmod.setup(circuit)


def write_r1cs(path, prime, n_vars, n_outputs, n_pub, n_prv, constraints, wire2label):
    """An iden3 .r1cs file: header (1), constraints (2), wire-to-label map (3)."""
    n8 = 8

    def lc_bytes(lc):
        out = struct.pack("<I", len(lc))
        for wire, coef in sorted(lc.items()):
            out += struct.pack("<I", wire) + int(coef).to_bytes(n8, "little")
        return out

    header = (struct.pack("<I", n8) + prime.to_bytes(n8, "little")
              + struct.pack("<IIII", n_vars, n_outputs, n_pub, n_prv)
              + struct.pack("<QI", len(wire2label), len(constraints)))
    body = b"".join(lc_bytes(a) + lc_bytes(b) + lc_bytes(c) for a, b, c in constraints)
    labels = struct.pack(f"<{len(wire2label)}Q", *wire2label)
    with open(path, "wb") as f:
        f.write(b"r1cs" + struct.pack("<II", 1, 3))
        for sid, data in ((1, header), (2, body), (3, labels)):
            f.write(struct.pack("<IQ", sid, len(data)) + data)


def test_r1cs_file_round_trip(circuit, tmp_path):
    path = str(tmp_path / "verifier.r1cs")
    cons = circuit.constraints
    write_r1cs(path, P, circuit.n_vars, circuit.n_outputs, circuit.n_pub_inputs,
               3, cons, list(range(circuit.n_vars)))
    got, want = tr1cs.read_r1cs(path), jr1cs.read_r1cs(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.constraints == [tuple({k: v for k, v in lc.items()} for lc in c) for c in cons]
    assert (got.prime, got.n_vars, got.n_constraints) == (P, circuit.n_vars, len(cons))
    with open(path, "r+b") as f:
        f.write(b"xxxx")
    for reader in (tr1cs.read_r1cs, jr1cs.read_r1cs):
        with pytest.raises(ValueError, match="Not an r1cs file"):
            reader(path)


def test_r1cs2plonk_equals_jax(circuit):
    plonk_in = [(a, b, {s: (P - v) % P for s, v in c.items()})
                for a, b, c in circuit.constraints]
    got = tr2p.r1cs2plonk(P, plonk_in, circuit.n_vars)
    assert got == jr2p.r1cs2plonk(P, plonk_in, circuit.n_vars)
    assert len(got[1]) > 0  # the addition chain


def test_plain_compressor_equals_jax(circuit):
    """The a/b/c PlonK compressor on a slice of the circuit's R1CS."""
    cons = circuit.constraints[:300]
    got = tcomp.setup(P, cons, circuit.n_vars)
    want = jcomp.setup(P, cons, circuit.n_vars)
    assert got.keys() == want.keys()
    for k in got:
        if isinstance(got[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k])
        else:
            assert got[k] == want[k], k
    np.testing.assert_array_equal(tcomp.exec_witness(got, circuit.witness),
                                  jcomp.exec_witness(want, circuit.witness))
    pil = tparser.compile_pil_source(got["pilSource"])
    assert pil == jparser.compile_pil_source(want["pilSource"])


def test_compressor_setup_equals_jax(compressed):
    _, _, want, got = compressed
    assert got.keys() == want.keys()
    assert got["pilSource"] == want["pilSource"]
    assert got["pil"] == want["pil"]
    np.testing.assert_array_equal(got["constBuffer"], want["constBuffer"])
    assert len(got["sMap"]) == len(want["sMap"])
    for a, b in zip(got["sMap"], want["sMap"]):
        np.testing.assert_array_equal(a, b)
    assert got["plonkAdditions"] == want["plonkAdditions"]
    assert (got["nBits"], got["nPublics"], got["nUsed"]) == (
        want["nBits"], want["nPublics"], want["nUsed"])
    assert got["nPublics"] == 3 and got["constBuffer"].dtype == np.uint64


def test_compressor_sizes(compressed, circuit):
    """The smallest chain's machines: a C12 of 2^11 rows and 36 fixed
    columns (12 committed); the C18 is denser."""
    jmod, _, _, got = compressed
    cols = len(got["sMap"])
    if jmod is jc12:
        assert (got["nBits"], got["constBuffer"].shape, cols) == (11, (2048, 36), 12)
    else:
        assert cols == 18 and got["nBits"] <= 11


def test_exec_witness_equals_jax(compressed, circuit):
    jmod, tmod, want, got = compressed
    cm = tmod.exec_witness(circuit.witness, got["plonkAdditions"], got["sMap"], got["nBits"])
    np.testing.assert_array_equal(
        cm, jmod.exec_witness(circuit.witness, want["plonkAdditions"], want["sMap"],
                              want["nBits"]))
    assert cm.shape == (1 << got["nBits"], len(got["sMap"]))


def test_exec_file_equals_jax(compressed, circuit, tmp_path):
    """write_exec_file's bytes, read back by both packages (compressor12's
    reader serves both machines, as in the JAX CLI)."""
    _, _, want, got = compressed
    cols = len(got["sMap"])
    paths = [str(tmp_path / f"{k}.exec") for k in ("jax", "port")]
    jc12.write_exec_file(paths[0], want["plonkAdditions"], want["sMap"])
    tc12.write_exec_file(paths[1], got["plonkAdditions"], got["sMap"])
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    adds, smap = tc12.read_exec_file(paths[1], n_cols=cols)
    jadds, jsmap = jc12.read_exec_file(paths[1], n_cols=cols)
    assert adds == jadds == [list(map(int, a)) for a in got["plonkAdditions"]]
    for a, b, c in zip(smap, jsmap, got["sMap"]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
