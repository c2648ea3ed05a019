"""The port's CLI (python -m pil2_stark_tpu_torch) against the JAX
package's (python -m pil2_stark_tpu): the same subcommands with the same
arguments, the JAX side with --backend numpy, the port's with --device
cpu, each in its own directory, must write the same bytes.  Then the
port's verify and pilverify accept and reject as the JAX package's do.
Each JAX run happens once per module; the JAX verify is not run (the
proofs are compared bit for bit)."""
import contextlib
import io
import json

import numpy as np
import pytest
import torch

from pil2_stark_tpu.__main__ import main as jax_main
from pil2_stark_tpu.compiler import pil1_parser
from pil2_stark_tpu.models import fibonacci as jfib
from pil2_stark_tpu.stark import witness as jwitness
from pil2_stark_tpu.utils import binfile as jbinfile, serialization as jser
from pil2_stark_tpu_torch.__main__ import main as port_main

SS4 = {
    "nBits": 4, "nBitsExt": 5, "nQueries": 4,
    "verificationHashType": "GL",
    "steps": [{"nBits": 5}, {"nBits": 2}],
}
SS6 = dict(jfib.STARK_STRUCT)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch's multi-threaded int64 ops are slow on small CPU tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _w(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f)
    return str(path)


def _run(main, argv):
    """(exit code, stdout) of one CLI call in this process."""
    out = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(out):
        try:
            main(argv)
        except SystemExit as e:
            code = e.code
    return code, out.getvalue()


def _both(tmp, argv_of, port_extra=("--device", "cpu"), jax_extra=()):
    """Run argv_of(dir) through both CLIs, in tmp/jax and tmp/port."""
    dirs = {"jax": tmp / "jax", "port": tmp / "port"}
    for d in dirs.values():
        d.mkdir(exist_ok=True)
    jax_code, _ = _run(jax_main, argv_of(dirs["jax"]) + list(jax_extra))
    port_code, _ = _run(port_main, argv_of(dirs["port"]) + list(port_extra))
    assert jax_code == port_code == 0
    return dirs


def _same_bytes(dirs, name):
    """The JAX and the port's file `name` hold the same bytes."""
    a = (dirs["jax"] / name).read_bytes()
    b = (dirs["port"] / name).read_bytes()
    assert len(a) > 0
    assert a == b


# -- genstarkinfo / preparepil / genpilcode / calculateimpols -----------------

PIPELINE_FILES = ["si.json", "ei.json", "vi.json", "prepared.json", "ei2.json", "vi2.json",
                  "impols.json"]


@pytest.fixture(scope="module")
def pipeline_dirs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    ss = _w(tmp / "ss.json", SS4)
    base = ["--model", "fibonacci", "--nbits", "4", "--starkstruct", ss]
    dirs = None
    for argv in (
        lambda d: ["genstarkinfo", *base, "--starkinfo", f"{d}/si.json",
                   "--expressionsinfo", f"{d}/ei.json", "--verifierinfo", f"{d}/vi.json"],
        lambda d: ["preparepil", *base, "-o", f"{d}/prepared.json"],
        lambda d: ["genpilcode", *base, "--expressionsinfo", f"{d}/ei2.json",
                   "--verifierinfo", f"{d}/vi2.json"],
        lambda d: ["calculateimpols", *base, "-o", f"{d}/impols.json"],
    ):
        dirs = _both(tmp, argv, port_extra=())
    return dirs


@pytest.mark.parametrize("name", PIPELINE_FILES)
def test_pipeline_file_equals_jax(pipeline_dirs, name):
    _same_bytes(pipeline_dirs, name)


# -- prove --model fibonacci --nbits 6 ---------------------------------------

PROVE_FILES = ["proof.json", "publics.json", "zkin.json", "verkey.json", "starkinfo.json",
               "verifierinfo.json"]


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("model")
    return _both(tmp, lambda d: ["prove", "--model", "fibonacci", "--nbits", "6", "--tmp", str(d)],
                 jax_extra=("--backend", "numpy"))


@pytest.mark.parametrize("name", PROVE_FILES)
def test_model_prove_file_equals_jax(model_dirs, name):
    _same_bytes(model_dirs, name)


def _verify(d, publics=None):
    return _run(port_main, ["verify", "--proof", f"{d}/proof.json",
                            "--publics", publics or f"{d}/publics.json",
                            "--verkey", f"{d}/verkey.json", "--starkinfo", f"{d}/starkinfo.json",
                            "--verifierinfo", f"{d}/verifierinfo.json"])


def test_verify_accepts_and_rejects_a_changed_public(model_dirs, tmp_path):
    d = model_dirs["port"]
    assert _verify(d) == (0, "VALID proof\n")
    pubs = json.loads((d / "publics.json").read_text())
    bad = _w(tmp_path / "bad.json", [str(int(pubs[0]) + 1)] + pubs[1:])
    assert _verify(d, bad) == (1, "INVALID proof\n")


# -- prove --pil-json/--const/--commit at 2^4 --------------------------------


@pytest.fixture(scope="module")
def machine_files(tmp_path_factory):
    """pil.json, const.npy, commit.npy, publics.json and ss.json of
    fibonacci 2^4, and a copy of the witness with one flipped cell."""
    tmp = tmp_path_factory.mktemp("machine")
    n = 16
    pil = pil1_parser.compile_pil_source(jfib.pil_source(4))
    pil["name"] = "Fibonacci"
    const_cols = jwitness.generate_fixed_cols(pil["references"], n)
    jfib.build_constants(n, const_cols.Fibonacci)
    cm_cols = jwitness.generate_wtns_cols(pil["references"], n)
    out = jfib.execute(n, cm_cols.Fibonacci, [1, 2])
    files = {"pil": _w(tmp / "pil.json", pil), "ss": _w(tmp / "ss.json", SS4),
             "const": str(tmp / "const.npy"), "commit": str(tmp / "commit.npy"),
             "bad_commit": str(tmp / "bad.npy"),
             "publics": _w(tmp / "publics.json", [str(x) for x in (1, 2, out)])}
    np.save(files["const"], const_cols.buffer)
    np.save(files["commit"], cm_cols.buffer)
    bad = cm_cols.buffer.copy()
    bad[5, 0] ^= np.uint64(1)
    np.save(files["bad_commit"], bad)
    return files


@pytest.fixture(scope="module")
def file_dirs(tmp_path_factory, machine_files):
    f = machine_files
    tmp = tmp_path_factory.mktemp("file")
    return _both(tmp, lambda d: ["prove", "--pil-json", f["pil"], "--const", f["const"],
                                 "--commit", f["commit"], "--publics", f["publics"],
                                 "--starkstruct", f["ss"], "--tmp", str(d)],
                 jax_extra=("--backend", "numpy"))


@pytest.mark.parametrize("name", PROVE_FILES)
def test_file_prove_file_equals_jax(file_dirs, name):
    _same_bytes(file_dirs, name)


def test_file_prove_verifies(file_dirs):
    assert _verify(file_dirs["port"])[0] == 0


@pytest.mark.parametrize("commit", ["commit", "bad_commit"])
def test_pilverify_matches_jax(machine_files, commit):
    f = machine_files
    argv = ["pilverify", "--pil-json", f["pil"], "--const", f["const"], "--commit", f[commit],
            "--publics", f["publics"]]
    jax = _run(jax_main, argv)
    port = _run(port_main, argv + ["--device", "cpu"])
    assert port == jax
    if commit == "commit":
        assert port == (0, "PIL OK!\n")
    else:
        assert port[0] == 1 and "PIL OK" not in port[1] and port[1].strip()


def test_pilverify_model(tmp_path):
    assert _run(port_main, ["pilverify", "--model", "fibonacci", "--nbits", "4",
                            "--device", "cpu"]) == (0, "PIL OK!\n")


# -- buildconsttree -----------------------------------------------------------

TREE_FILES = ["consttree.bin", "verkey.json", "consts.bin", "cnts.bin", "pilcom.const"]


@pytest.fixture(scope="module", params=["model", "pstc", "pilcom"])
def tree_dirs(request, tmp_path_factory):
    """buildconsttree from --model, from a PSTC consts container and from a
    headerless pilcom file (--npols), with --ref-consts and --pilcom-const."""
    tmp = tmp_path_factory.mktemp(f"tree_{request.param}")
    ss = _w(tmp / "ss.json", SS6)
    pil = pil1_parser.compile_pil_source(jfib.pil_source(6))
    const_cols = jwitness.generate_fixed_cols(pil["references"], 64)
    jfib.build_constants(64, const_cols.Fibonacci)
    if request.param == "model":
        source = ["--model", "fibonacci"]
    elif request.param == "pstc":
        jser.write_const_file(str(tmp / "in.pstc"), const_cols.buffer)
        source = ["--const-file", str(tmp / "in.pstc")]
    else:
        jbinfile.write_pilcom_const(str(tmp / "in.const"), const_cols.buffer)
        source = ["--const-file", str(tmp / "in.const"), "--npols", "2"]
    dirs = _both(tmp, lambda d: ["buildconsttree", *source, "--starkstruct", ss,
                                 "--consttree", f"{d}/consttree.bin",
                                 "--verkey", f"{d}/verkey.json",
                                 "--constsfile", f"{d}/consts.bin",
                                 "--ref-consts", f"{d}/cnts.bin",
                                 "--pilcom-const", f"{d}/pilcom.const"])
    return dirs


@pytest.mark.parametrize("name", TREE_FILES)
def test_buildconsttree_file_equals_jax(tree_dirs, name):
    _same_bytes(tree_dirs, name)


def test_buildconsttree_root_is_the_setup_root(tree_dirs, model_dirs):
    """read_tree of the port's file gives the verkey's root, the one the
    model's prove committed to."""
    from pil2_stark_tpu_torch.hash import merkle
    from pil2_stark_tpu_torch.utils import serialization

    d = tree_dirs["port"]
    root = serialization.load_verkey(str(d / "verkey.json"))
    assert [int(x) for x in merkle.read_tree(str(d / "consttree.bin")).root] == root
    assert root == serialization.load_verkey(str(model_dirs["port"] / "verkey.json"))


# -- buildchelpers -------------------------------------------------------------


def test_buildchelpers_file_equals_jax(tmp_path):
    ss = _w(tmp_path / "ss.json", SS4)
    dirs = _both(tmp_path, lambda d: ["buildchelpers", "--model", "fibonacci", "--nbits", "4",
                                      "--starkstruct", ss, "--chelpers", f"{d}/m.chelpers.bin"],
                 port_extra=())
    _same_bytes(dirs, "m.chelpers.bin")


# -- the recursion tier: pil2circom -> compressor-setup -> compressor-exec ------

INNER_STRUCT = {"nBits": 4, "nBitsExt": 7, "nQueries": 2, "verificationHashType": "GL",
                "steps": [{"nBits": 7}, {"nBits": 3}]}
CIRCUIT_FILES = ["circuit/verifier.circom", "circuit/poseidon.circom", "circuit/fft.circom"]
COMPRESSOR_FILES = ["c12.pil.json", "c12.const.npy", "c12.exec", "c12.wtns.json",
                    "c12.meta.json", "c12.commit.npy", "c12.publics.json"]


@pytest.fixture(scope="module")
def recursion_dirs(tmp_path_factory):
    """fibonacci 2^4 / ext 2^7 proved by each CLI, then its verifier
    circuit, the C12 setup of that circuit on the proof's zkin, and the
    C12 witness, each through each CLI from that CLI's own files."""
    tmp = tmp_path_factory.mktemp("recursion")
    ss = _w(tmp / "ss.json", INNER_STRUCT)
    dirs = _both(tmp, lambda d: ["prove", "--model", "fibonacci", "--nbits", "4",
                                 "--starkstruct", ss, "--tmp", str(d)],
                 jax_extra=("--backend", "numpy"))
    for argv in (
        lambda d: ["pil2circom", "--starkinfo", f"{d}/starkinfo.json",
                   "--verifierinfo", f"{d}/verifierinfo.json", "--verkey", f"{d}/verkey.json",
                   "-o", f"{d}/circuit"],
        lambda d: ["compressor-setup", "--circom-dir", f"{d}/circuit", "--inputs",
                   f"{d}/zkin.json", "--out-prefix", f"{d}/c12", "--cols", "12"],
        lambda d: ["compressor-exec", "--exec", f"{d}/c12.exec", "--wtns", f"{d}/c12.wtns.json",
                   "--meta", f"{d}/c12.meta.json", "--commit", f"{d}/c12.commit.npy",
                   "--publics", f"{d}/c12.publics.json"],
    ):
        _both(tmp, argv, port_extra=())
    return dirs


@pytest.mark.parametrize("name", CIRCUIT_FILES + COMPRESSOR_FILES)
def test_recursion_file_equals_jax(recursion_dirs, name):
    _same_bytes(recursion_dirs, name)


def test_recursion_files_hold_the_c12(recursion_dirs):
    d = recursion_dirs["port"]
    jax_names = sorted(p.name for p in (recursion_dirs["jax"] / "circuit").iterdir())
    assert sorted(p.name for p in (d / "circuit").iterdir()) == jax_names
    meta = json.loads((d / "c12.meta.json").read_text())
    assert meta == {"nBits": 11, "nPublics": 3, "cols": 12}
    assert np.load(d / "c12.commit.npy").shape == (2048, 12)
    assert json.loads((d / "c12.publics.json").read_text()) == json.loads(
        (d / "publics.json").read_text())


def test_pil2circom_refuses_bn128(recursion_dirs, tmp_path):
    d = recursion_dirs["port"]
    info = json.loads((d / "starkinfo.json").read_text())
    info["starkStruct"]["verificationHashType"] = "BN128"
    si = _w(tmp_path / "si.json", info)
    with pytest.raises(NotImplementedError, match="Queue A 5b"):
        port_main(["pil2circom", "--starkinfo", si, "--verifierinfo",
                   f"{d}/verifierinfo.json", "--verkey", f"{d}/verkey.json",
                   "-o", str(tmp_path / "c")])


def test_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main(["prove", "--model", "fibonacci", "--nbits", "6", "--tmp", str(tmp_path)])
