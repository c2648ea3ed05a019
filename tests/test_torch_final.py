"""The port's final tier (final/plonksetup.py, final/exec.py, the exec
binfile of utils/binfile.py) and its fflonk leg against the JAX package's
on the CPU.

- The custom-gate circuit of tests/test_final.py (PoseidonT, Num2Bytes,
  CustomGLCMulAdd), compiled over BN254-Fr by each package's circom
  front-end: the final9 setup (PIL, constPols, sMap, plonkAdditions) and
  the exec buffer are equal, and so are the exec files' bytes in both
  formats.  The final9 debug constraint check runs on the port's side only
  (the JAX package's tests/test_final.py runs it on its side).
- The Mul3 circuit laid out as finalfflonk (cols 0, 6 committed columns):
  setup, exec buffer, fflonkinfo, zkey, verification key and proof equal
  for one shared powers-of-tau string and random.Random(seed) blinding;
  both packages accept the proof and refuse a changed public; debug mode
  finds no error in the witness and the same errors in a changed one."""
import json
import random
import re

import numpy as np
import pytest

from pil2_stark_tpu.compiler import circom_front as jcf, pilinfo as jpilinfo
from pil2_stark_tpu.fflonk.prover import fflonk_prove as jprove
from pil2_stark_tpu.fflonk.shkey import fflonk_setup as jsetup, verification_key as jvk
from pil2_stark_tpu.fflonk.verifier import fflonk_verify as jverify
from pil2_stark_tpu.final import exec as jexec, plonksetup as jplonk
from pil2_stark_tpu.utils import binfile as jbinfile
from pil2_stark_tpu_torch.compiler import circom_front as cf, pilinfo
from pil2_stark_tpu_torch.fflonk.prover import fflonk_prove
from pil2_stark_tpu_torch.fflonk.shkey import build_shkey, fflonk_setup, verification_key
from pil2_stark_tpu_torch.fflonk.verifier import fflonk_verify
from pil2_stark_tpu_torch.final import exec as fexec, plonksetup
from pil2_stark_tpu_torch.protocol.shplonk import dev_ptau
from pil2_stark_tpu_torch.utils import binfile

from test_final import _const_index, _main_circuit

FR = plonksetup.FR
MUL3 = """
pragma circom 2.1.0;

template Mul3() {
    signal input x;
    signal input y;
    signal output out;
    signal t1 <== x * y;
    signal t2 <== t1 * t1 + x + 5;
    out <== t2 * y;
}

component main {public [x]} = Mul3();
"""


def _canon(obj) -> str:
    return json.dumps(obj, default=str, sort_keys=True)


def _machine(cf_mod, plonk_mod, exec_mod, files, entry, inputs, cols, options=None):
    """(circuit, setup, exec buffer, publics) through one package."""
    cc = cf_mod.compile_and_witness(files, entry, inputs, prime=plonk_mod.FR)
    assert cc.check()
    s = plonk_mod.setup(cc, cols=cols, options=options)
    cm = exec_mod.exec_witness(cc.witness, s["plonkAdditions"], s["sMap"])
    return cc, s, cm, [int(cc.witness[i]) for i in range(1, 1 + s["nPublics"])]


def _same_setup(s, js):
    assert s["nBits"] == js["nBits"] and s["nPublics"] == js["nPublics"]
    assert _canon(s["pil"]) == _canon(js["pil"])
    assert np.array_equal(np.asarray(s["constPols"], dtype=object),
                          np.asarray(js["constPols"], dtype=object))
    assert len(s["sMap"]) == len(js["sMap"])
    assert all(np.array_equal(a, b) for a, b in zip(s["sMap"], js["sMap"]))
    assert [[int(x) for x in a] for a in s["plonkAdditions"]] == [
        [int(x) for x in a] for a in js["plonkAdditions"]]


@pytest.fixture(scope="module")
def final9():
    args = (_main_circuit(), "final.circom", {"a": 11, "b": 20}, 9)
    port = _machine(cf, plonksetup, fexec, *args)
    jax = _machine(jcf, jplonk, jexec, *args)
    return port, jax


def test_final9_setup_and_exec_equal_jax(final9):
    (_, s, cm, publics), (_, js, jcm, jpublics) = final9
    _same_setup(s, js)
    assert s["nBits"] == 7
    assert np.array_equal(cm, jcm) and publics == jpublics


def test_exec_files_equal_jax(final9, tmp_path):
    for ref_format in (False, True):
        _same_exec_file(final9[0][1], tmp_path, ref_format)


def _same_exec_file(s, tmp_path, ref_format):
    n_cols = len(s["sMap"])
    fexec.write_exec_file(str(tmp_path / "port.exec"), s["plonkAdditions"], s["sMap"],
                          ref_format=ref_format)
    jexec.write_exec_file(str(tmp_path / "jax.exec"), s["plonkAdditions"], s["sMap"],
                          ref_format=ref_format)
    data = (tmp_path / "port.exec").read_bytes()
    assert data == (tmp_path / "jax.exec").read_bytes()
    adds, smap = fexec.read_exec_file(str(tmp_path / "port.exec"), n_cols=n_cols)
    assert [[int(x) for x in a] for a in adds] == [
        [int(a), int(b), int(c) % FR, int(d) % FR] for a, b, c, d in s["plonkAdditions"]]
    assert all(np.array_equal(a, np.asarray(b, dtype=np.uint64)) for a, b in zip(smap, s["sMap"]))
    if ref_format:
        assert data[:4] == b"exec"
        back = binfile.read_exec_binfile(str(tmp_path / "port.exec"), n_cols)
        jback = jbinfile.read_exec_binfile(str(tmp_path / "jax.exec"), n_cols)
        assert back[0] == jback[0]
        assert all(np.array_equal(a, b) for a, b in zip(back[1], jback[1]))


def test_final9_debug_check_on_the_port(final9):
    """The debug check reads only the zkey's constant evaluations, so the
    powers of tau are those of tau = 1, sized to what the shkey needs."""
    _, s, cm, publics = final9[0]
    info = pilinfo.pil_info(s["pil"], stark=False, options={"field": "fr"})
    with pytest.raises(ValueError, match="ptau too small") as e:
        build_shkey(info["pilInfo"], {"g1": [], "X_2": None})
    ptau = dev_ptau(int(re.search(r"need (\d+)", str(e.value)).group(1)), tau=1)
    zkey = fflonk_setup(s["constPols"], info["pilInfo"], ptau)
    args = (zkey, ptau, info["pilInfo"], info["expressionsInfo"])
    assert fflonk_prove(*args, cm, publics, debug=True) == []
    glc = s["constPols"][:, _const_index(s["pil"], "Final.GLCMULADD")]
    row = int(np.argmax(np.asarray(glc, dtype=np.uint64)))
    bad = cm.copy()
    bad[row + 1, 3] = (int(bad[row + 1, 3]) + 1) % FR
    assert fflonk_prove(*args, bad, publics, debug=True) != []
    wrong = [(publics[0] + 1) % FR] + publics[1:]
    assert fflonk_prove(*args, cm, wrong, debug=True) != []


@pytest.fixture(scope="module")
def mul3():
    args = ({"m.circom": MUL3}, "m.circom", {"x": 3, "y": 4}, 0, {"nCommitted": 6})
    out = {}
    for key, mods in (("port", (cf, plonksetup, fexec, pilinfo)),
                      ("jax", (jcf, jplonk, jexec, jpilinfo))):
        _, s, cm, publics = _machine(*mods[:3], *args)
        out[key] = {"s": s, "cm": cm, "publics": publics,
                    "info": mods[3].pil_info(s["pil"], stark=False, options={"field": "fr"})}
    ptau = dev_ptau(40 * (1 << out["port"]["s"]["nBits"]), tau=4242)
    for key, setup, prove, vkey in (("port", fflonk_setup, fflonk_prove, verification_key),
                                    ("jax", jsetup, jprove, jvk)):
        o = out[key]
        o["zkey"] = setup(o["s"]["constPols"], o["info"]["pilInfo"], ptau)
        o["res"] = prove(o["zkey"], ptau, o["info"]["pilInfo"], o["info"]["expressionsInfo"],
                         o["cm"], o["publics"], rng=random.Random(7))
        o["vk"] = vkey(o["zkey"], o["info"]["pilInfo"])
    return out, ptau


def test_finalfflonk_mul3_equals_jax_and_verifies(mul3):
    out = mul3[0]
    port, jax = out["port"], out["jax"]
    _same_setup(port["s"], jax["s"])
    assert np.array_equal(port["cm"], jax["cm"]) and port["publics"] == jax["publics"]
    for k in ("pilInfo", "expressionsInfo", "verifierInfo"):
        assert _canon(port["info"][k]) == _canon(jax["info"][k]), k
    assert _canon(port["zkey"]) == _canon(jax["zkey"])
    assert port["vk"] == jax["vk"]
    assert _canon(port["res"]["proof"]) == _canon(jax["res"]["proof"])
    info, res = port["info"], port["res"]
    args = (port["vk"], info["pilInfo"], info["verifierInfo"], res["proof"])
    bad = [(res["publics"][0] + 1) % FR] + list(res["publics"][1:])
    for verify in (fflonk_verify, jverify):
        assert verify(*args, res["publics"]) is True
        assert verify(*args, bad) is False


def test_finalfflonk_mul3_debug_equals_jax(mul3):
    out, ptau = mul3
    port = out["port"]
    args = (port["zkey"], ptau, port["info"]["pilInfo"], port["info"]["expressionsInfo"])
    assert fflonk_prove(*args, port["cm"], port["publics"], debug=True) == []
    bad = port["cm"].copy()
    bad[1, 2] = (int(bad[1, 2]) + 1) % FR
    errors = fflonk_prove(*args, bad, port["publics"], debug=True)
    assert errors and errors == jprove(*args, bad, port["publics"], debug=True)
