"""The port's pil-fflonk tier (fflonk/: fr_ctx, fr_hints, chelpers, prover,
shkey, verifier) against the JAX package's on the CPU, on fibonacci 2^4
over BN254-Fr (the machine of tests/test_fflonk.py): each package compiles
the PIL with its own compiler (pil_info, stark=False), sets up the zkey
from the same constants and one shared powers-of-tau string, proves the
same witness with random.Random(seed) blinding and verifies; fflonkinfo,
zkey, verification key, proof and verdict must be equal.  Both packages
refuse a changed public and a changed evaluation.  Through fflonk.chelpers
the `.fflonkchelpers.bin` file holds the same bytes as the JAX one, and
the prove through its streams gives the same proof; debug mode finds no
error in the witness and errors in a changed one."""
import json
import random

import numpy as np
import pytest

from pil2_stark_tpu.compiler import pil1_parser as jparser, pilinfo as jpilinfo
from pil2_stark_tpu.fflonk import chelpers as jchelpers
from pil2_stark_tpu.fflonk.prover import fflonk_prove as jprove
from pil2_stark_tpu.fflonk.shkey import fflonk_setup as jsetup, verification_key as jvk
from pil2_stark_tpu.fflonk.verifier import fflonk_verify as jverify
from pil2_stark_tpu.models import fibonacci as jfib
from pil2_stark_tpu_torch.compiler import pil1_parser, pilinfo
from pil2_stark_tpu_torch.fflonk import chelpers
from pil2_stark_tpu_torch.fflonk.prover import fflonk_prove
from pil2_stark_tpu_torch.fflonk.shkey import fflonk_setup, verification_key
from pil2_stark_tpu_torch.fflonk.verifier import fflonk_verify
from pil2_stark_tpu_torch.models import fibonacci
from pil2_stark_tpu_torch.ops.fft_bn128 import FR
from pil2_stark_tpu_torch.protocol.shplonk import dev_ptau

N_BITS = 4
N = 1 << N_BITS
SEED = 99


def _canon(obj) -> str:
    return json.dumps(obj, default=str, sort_keys=True)


def _info(parser, pilinfo_mod, source):
    pil = parser.compile_pil_source(source)
    pil["name"] = "Fibonacci"
    return pilinfo_mod.pil_info(pil, stark=False)


def _inputs(fflonk_info):
    """Constants (L1, LLAST), the stage-1 witness over Fr and publics."""
    const_names = [p["name"] for p in fflonk_info["constPolsMap"]]
    const_pols = [[0] * len(const_names) for _ in range(N)]
    const_pols[0][const_names.index("Fibonacci.L1")] = 1
    const_pols[N - 1][const_names.index("Fibonacci.LLAST")] = 1
    cm_names = [p["name"] for p in fflonk_info["cmPolsMap"] if p["stage"] == 1]
    l1, l2 = [0] * N, [0] * N
    l2[0], l1[0] = 1, 2
    for i in range(1, N):
        l2[i] = l1[i - 1]
        l1[i] = (l1[i - 1] ** 2 + l2[i - 1] ** 2) % FR
    cm1 = np.empty((N, len(cm_names)), dtype=object)
    cm1[:, cm_names.index("Fibonacci.l1")] = l1
    cm1[:, cm_names.index("Fibonacci.l2")] = l2
    return const_pols, cm1, [1, 2, l1[N - 1]]


@pytest.fixture(scope="module")
def both():
    info = _info(pil1_parser, pilinfo, fibonacci.pil_source(N_BITS))
    jinfo = _info(jparser, jpilinfo, jfib.pil_source(N_BITS))
    const_pols, cm1, publics = _inputs(info["pilInfo"])
    ptau = dev_ptau(4 * (N + 4) + 8 * N, tau=12345)
    out = {}
    for key, inf, setup, prove, vkey in (("port", info, fflonk_setup, fflonk_prove,
                                          verification_key),
                                         ("jax", jinfo, jsetup, jprove, jvk)):
        zkey = setup(const_pols, inf["pilInfo"], ptau)
        res = prove(zkey, ptau, inf["pilInfo"], inf["expressionsInfo"], cm1, publics,
                    rng=random.Random(SEED))
        out[key] = {"info": inf, "zkey": zkey, "res": res, "vk": vkey(zkey, inf["pilInfo"])}
    return out, ptau, cm1, publics


def test_fflonkinfo_zkey_and_proof_equal_jax(both):
    out = both[0]
    port, jax = out["port"], out["jax"]
    for k in ("pilInfo", "expressionsInfo", "verifierInfo"):
        assert _canon(port["info"][k]) == _canon(jax["info"][k]), k
    assert _canon(port["zkey"]) == _canon(jax["zkey"])
    assert port["vk"] == jax["vk"]
    assert _canon(port["res"]["proof"]) == _canon(jax["res"]["proof"])
    assert port["res"]["publics"] == jax["res"]["publics"]


def test_verify_equals_jax_and_refuses_tampering(both):
    out = both[0]
    info, res, vk = out["port"]["info"], out["port"]["res"], out["port"]["vk"]
    args = (info["pilInfo"], info["verifierInfo"])
    assert fflonk_verify(vk, *args, res["proof"], res["publics"]) is True
    assert jverify(vk, *args, res["proof"], res["publics"]) is True
    bad = list(res["publics"])
    bad[2] = (bad[2] + 1) % FR
    proof = {"polynomials": dict(res["proof"]["polynomials"]),
             "evaluations": dict(res["proof"]["evaluations"])}
    name = next(k for k in proof["evaluations"] if k not in ("inv", "invZh"))
    proof["evaluations"][name] = (proof["evaluations"][name] + 1) % FR
    for verify in (fflonk_verify, jverify):
        assert verify(vk, *args, res["proof"], bad) is False
        assert verify(vk, *args, proof, res["publics"]) is False


def test_chelpers_file_equals_jax_and_keeps_the_proof(both, tmp_path):
    out, ptau, cm1, publics = both
    info = out["port"]["info"]
    written = chelpers.write_file(str(tmp_path / "port.bin"), info["pilInfo"],
                                  info["expressionsInfo"])
    jchelpers.write_file(str(tmp_path / "jax.bin"), info["pilInfo"], info["expressionsInfo"])
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()
    units = chelpers.read_file(str(tmp_path / "port.bin"))
    assert units["pilPower"] == N_BITS
    assert [len(u["ops"]) for u in units["expressions"]] == [
        len(u["ops"]) for u in written["expressions"]]
    res = fflonk_prove(out["port"]["zkey"], ptau, info["pilInfo"], info["expressionsInfo"],
                       cm1, publics, rng=random.Random(SEED), chelpers=units)
    assert _canon(res["proof"]) == _canon(out["port"]["res"]["proof"])


def test_debug_mode_finds_errors_as_jax_does(both):
    out, ptau, cm1, publics = both
    info, zkey = out["port"]["info"], out["port"]["zkey"]
    args = (zkey, ptau, info["pilInfo"], info["expressionsInfo"])
    assert fflonk_prove(*args, cm1, publics, debug=True) == []
    bad = cm1.copy()
    bad[5, 0] = (int(bad[5, 0]) + 1) % FR
    errors = fflonk_prove(*args, bad, publics, debug=True)
    assert errors and errors == jprove(*args, bad, publics, debug=True)
