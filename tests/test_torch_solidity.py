"""PyTorch port, the Solidity exporter (fflonk/solidity.py) and the
``exportsolidityverifier`` / ``exportcalldata`` subcommands, held against
the JAX package on the CPU: the contract text (and its statement ops) and
the calldata equal the JAX exporter's for the same verification key and
proof, ``decode_calldata`` round-trips to a proof that verifies, a
corrupted word is refused and a short calldata raises
(tests/test_solidity.py), and both subcommands write the JAX CLI's
files."""
import json

import pytest

from pil2_stark_tpu.__main__ import main as jmain
from pil2_stark_tpu.fflonk import solidity as jsol
from pil2_stark_tpu_torch.__main__ import main as tmain
from pil2_stark_tpu_torch.fflonk import solidity as sol
from pil2_stark_tpu_torch.fflonk.verifier import fflonk_verify
from pil2_stark_tpu_torch.ops.fft_bn128 import FR
from pil2_stark_tpu_torch.utils import serialization

from torch_fflonk_chain import chain


def test_contract_text_and_ops_equal_jax():
    ch = chain()
    args = (ch["vk"], ch["info"]["pilInfo"], ch["info"]["verifierInfo"])
    text = sol.export_pilfflonk_verifier(*args)
    assert text == jsol.export_pilfflonk_verifier(*args)
    assert text.startswith("// SPDX-License-Identifier") and "staticcall(gas(), 0x08" in text
    got = sol.export_pilfflonk_verifier(*args, return_ops=True)
    want = jsol.export_pilfflonk_verifier(*args, return_ops=True)
    assert got[0] == want[0] and got[2:] == want[2:]
    assert json.dumps(got[1].ops, default=str) == json.dumps(want[1].ops, default=str)
    assert got[1].n_slots == want[1].n_slots


def test_calldata_equals_jax_and_round_trips():
    ch = chain()
    vk, res, info = ch["vk"], ch["res"], ch["info"]
    calldata = sol.export_calldata(vk, res["proof"], res["publics"])
    assert calldata == jsol.export_calldata(vk, res["proof"], res["publics"])
    proof2, publics2 = sol.decode_calldata(vk, calldata)
    jproof2, jpublics2 = jsol.decode_calldata(vk, calldata)
    assert json.dumps(proof2, default=str) == json.dumps(jproof2, default=str)
    assert publics2 == jpublics2 == [int(p) % FR for p in res["publics"]]
    assert fflonk_verify(vk, info["pilInfo"], info["verifierInfo"], proof2, publics2) is True


def test_corrupted_or_short_calldata_refused():
    ch = chain()
    vk, res, info = ch["vk"], ch["res"], ch["info"]
    arrays = json.loads(f"[{sol.export_calldata(vk, res['proof'], res['publics'])}]")
    bad = [list(a) for a in arrays]
    bad[0][-3] = f"0x{int(bad[0][-3], 16) ^ 1:064x}"
    proof2, publics2 = sol.decode_calldata(vk, ",".join(json.dumps(a) for a in bad))
    assert not fflonk_verify(vk, info["pilInfo"], info["verifierInfo"], proof2, publics2)
    short = [arrays[0][:-1]] + arrays[1:]
    for decode in (sol.decode_calldata, jsol.decode_calldata):
        with pytest.raises(ValueError, match="proof words"):
            decode(vk, ",".join(json.dumps(a) for a in short))


def test_export_subcommands_write_jax_files(tmp_path):
    ch = chain()
    res, info = ch["res"], ch["info"]
    d = str(tmp_path)
    serialization.dump_json(json.loads(json.dumps(ch["vk"], default=str)), f"{d}/vk.json")
    serialization.dump_json(info["pilInfo"], f"{d}/fflonkinfo.json")
    serialization.dump_json(info["verifierInfo"], f"{d}/verifierinfo.json")
    serialization.dump_json(json.loads(json.dumps(res["proof"], default=str)), f"{d}/proof.json")
    serialization.dump_json([str(p) for p in res["publics"]], f"{d}/publics.json")
    for main, tag in ((tmain, "port"), (jmain, "jax")):
        main(["exportsolidityverifier", "--verificationkey", f"{d}/vk.json",
              "--fflonkinfo", f"{d}/fflonkinfo.json", "--verifierinfo", f"{d}/verifierinfo.json",
              "-o", f"{d}/{tag}.sol"])
        main(["exportcalldata", "--verificationkey", f"{d}/vk.json", "--proof",
              f"{d}/proof.json", "--publics", f"{d}/publics.json", "-o", f"{d}/{tag}.txt"])
    for ext in ("sol", "txt"):
        got = (tmp_path / f"port.{ext}").read_bytes()
        assert got and got == (tmp_path / f"jax.{ext}").read_bytes(), ext
    assert (tmp_path / "port.txt").read_text() == \
        sol.export_calldata(ch["vk"], res["proof"], res["publics"])
