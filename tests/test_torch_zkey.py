"""PyTorch port, the pil-fflonk zkey binfile (fflonk/zkey_binfile.py) and
``exportverificationkey``, held against the JAX package on the CPU: the
port's file equals the JAX package's byte for byte, its read-back fields
equal the JAX reader's, a prove from the read-back zkey gives the proof of
the original one (tests/test_zkey_binfile.py), and the CLI subcommand
writes the JAX CLI's file."""
import json
import random

import pytest

from pil2_stark_tpu.__main__ import main as jmain
from pil2_stark_tpu.fflonk import zkey_binfile as jzkey
from pil2_stark_tpu_torch.__main__ import main as tmain
from pil2_stark_tpu_torch.fflonk import zkey_binfile
from pil2_stark_tpu_torch.fflonk.prover import fflonk_prove
from pil2_stark_tpu_torch.fflonk.shkey import verification_key
from pil2_stark_tpu_torch.fflonk.verifier import fflonk_verify
from pil2_stark_tpu_torch.utils import serialization

from torch_fflonk_chain import chain


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The zkey written by the port and by the JAX package, and the port's
    read-back (zkey, ptau)."""
    ch = chain()
    tmp = tmp_path_factory.mktemp("zkey")
    port, jax = str(tmp / "port.zkey"), str(tmp / "jax.zkey")
    zkey_binfile.write_zkey(port, ch["zkey"], ch["ptau"])
    jzkey.write_zkey(jax, ch["zkey"], ch["ptau"])
    return tmp, port, jax, zkey_binfile.read_zkey(port)


def test_zkey_bytes_equal_jax(files):
    _, port, jax, _ = files
    with open(port, "rb") as a, open(jax, "rb") as b:
        got, want = a.read(), b.read()
    assert got[:4] == b"zkey" and len(got) > 1000
    assert got == want


def test_read_back_fields_equal_jax(files):
    _, port, _, (zk2, ptau2) = files
    jzk, jptau = jzkey.read_zkey(port)
    assert json.dumps(zk2, sort_keys=True, default=str) == \
        json.dumps(jzk, sort_keys=True, default=str)
    assert ptau2 == jptau
    ch = chain()
    for k in ("power", "powerW", "nPublics", "maxQDegree", "X_2", "qNames"):
        assert zk2[k] == ch["zkey"][k], k
    assert ptau2["g1"] == ch["ptau"]["g1"]
    vk, _ = zkey_binfile.read_zkey(port, vk_only=True)
    jvk, _ = jzkey.read_zkey(port, vk_only=True)
    assert "constPolsEvals" not in vk and json.dumps(vk, default=str) == \
        json.dumps(jvk, default=str)


def test_prove_from_read_back_zkey_equals_library(files):
    ch = chain()
    _, _, _, (zk2, ptau2) = files
    info = ch["info"]
    res = fflonk_prove(zk2, ptau2, info["pilInfo"], info["expressionsInfo"], ch["cm1"],
                       ch["publics"], rng=random.Random(3))
    assert json.dumps(res["proof"], default=str) == json.dumps(ch["res"]["proof"], default=str)
    assert res["publics"] == ch["res"]["publics"]
    vk = verification_key(zk2, info["pilInfo"])
    assert vk == ch["vk"]
    assert fflonk_verify(vk, info["pilInfo"], info["verifierInfo"], res["proof"], res["publics"])


def test_exportverificationkey_file_equals_jax_cli(files, capsys):
    tmp = files[0]
    ch = chain()
    with open(tmp / "zkey.json", "w") as f:  # as the fflonk-setup subcommand writes it
        json.dump(ch["zkey"], f, default=lambda o: o.tolist() if hasattr(o, "tolist") else int(o))
    serialization.dump_json(ch["info"]["pilInfo"], str(tmp / "fflonkinfo.json"))
    for main, out in ((tmain, "port.vk.json"), (jmain, "jax.vk.json")):
        main(["exportverificationkey", "--zkey", str(tmp / "zkey.json"),
              "--fflonkinfo", str(tmp / "fflonkinfo.json"),
              "--verificationkey", str(tmp / out)])
    got, want = (tmp / "port.vk.json").read_bytes(), (tmp / "jax.vk.json").read_bytes()
    assert got == want
    assert serialization.load_json(str(tmp / "port.vk.json"))["X_2"] == \
        json.loads(json.dumps(ch["vk"]["X_2"], default=str))
