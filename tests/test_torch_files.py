"""The port's artifact files against the JAX package's on the CPU:
serialization (proof, verkey and JSON files, the PSTC consts container and
its errors), the binfile interop layer (the iden3 container, pilcom .const
files, the "cnts" consts file, the node count) and the Merkle tree file.
The same inputs must give the same bytes, each side must read the other's
files, and a device tree (here on CPU tensors) written through
stark.device.to_host_tree must give the JAX package's tree file of the same
columns, for a uniform zero-width tree and at 1, 3 and 12 columns, with
the normal and the split linear hash."""
import numpy as np
import pytest
import torch

from pil2_stark_tpu.field import gl64
from pil2_stark_tpu.hash import merkle as jmerkle
from pil2_stark_tpu.utils import binfile as jbinfile, proof2zkin as jzkin
from pil2_stark_tpu.utils import serialization as jser
from pil2_stark_tpu_torch.field import torch_gl
from pil2_stark_tpu_torch.hash import merkle
from pil2_stark_tpu_torch.stark import device as dev, verifier
from pil2_stark_tpu_torch.utils import binfile, proof2zkin, serialization

from test_torch_cases import canon, prove_port


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch's multi-threaded int64 ops are slow on small CPU tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random(rows, cols, seed):
    return np.random.default_rng(seed).integers(0, gl64.P_INT, size=(rows, cols),
                                                dtype=np.uint64)


def _same(tmp_path, name, write_port, write_jax):
    """write_port(path) and write_jax(path) give the same bytes."""
    a, b = str(tmp_path / f"port_{name}"), str(tmp_path / f"jax_{name}")
    write_port(a)
    write_jax(b)
    data = open(a, "rb").read()
    assert len(data) > 0 and data == open(b, "rb").read()
    return a, b


# -- proofs, verkeys, zkin -------------------------------------------------------


@pytest.fixture(scope="module")
def proven():
    return prove_port("fibonacci_6")


@pytest.mark.parametrize("what", ["proof", "publics", "verkey", "starkinfo", "zkin"])
def test_json_file_equals_jax(proven, tmp_path, what):
    s, res = proven
    obj = {"proof": res["proof"], "publics": [str(int(p)) for p in res["publics"]],
           "verkey": s["constRoot"], "starkinfo": s["starkInfo"]}.get(what)
    if what == "proof":
        writers = serialization.dump_proof, jser.dump_proof
    elif what == "verkey":
        writers = serialization.dump_verkey, jser.dump_verkey
    elif what == "zkin":
        obj = proof2zkin.proof2zkin(res["proof"], s["starkInfo"])
        assert canon(obj) == canon(jzkin.proof2zkin(res["proof"], s["starkInfo"]))
        writers = serialization.dump_proof, jser.dump_proof
    else:
        writers = serialization.dump_json, jser.dump_json
    _same(tmp_path, what, lambda p: writers[0](obj, p), lambda p: writers[1](obj, p))


def test_proof_json_round_trip_verifies(proven, tmp_path):
    s, res = proven
    p = tmp_path
    jser.dump_proof(res["proof"], str(p / "proof.json"))  # read back what the JAX side wrote
    serialization.dump_verkey(s["constRoot"], str(p / "verkey.json"))
    serialization.dump_json(s["starkInfo"], str(p / "starkinfo.json"))
    proof = serialization.load_proof(str(p / "proof.json"))
    assert canon(proof) == canon(jser.load_proof(str(p / "proof.json")))
    root = serialization.load_verkey(str(p / "verkey.json"))
    assert root == jser.load_verkey(str(p / "verkey.json"))
    assert verifier.verify(proof, res["publics"], root,
                           serialization.load_json(str(p / "starkinfo.json")),
                           s["verifierInfo"])


def test_zkin_shape(proven):
    s, res = proven
    zkin = proof2zkin.proof2zkin(res["proof"], s["starkInfo"])
    ss = s["starkInfo"]["starkStruct"]
    assert len(zkin["s0_vals1"]) == len(zkin["s0_valsC"]) == ss["nQueries"]
    assert len(zkin["finalPol"]) == 1 << ss["steps"][-1]["nBits"]
    assert all(isinstance(v, int) for v in zkin["root1"])


def test_int_root_is_refused_as_in_jax(tmp_path):
    """The JAX package's dump_verkey cannot write a BN128 (int) root; the
    port keeps that behaviour."""
    for dump in (serialization.dump_verkey, jser.dump_verkey):
        with pytest.raises(TypeError):
            dump(12345, str(tmp_path / "v.json"))


# -- the PSTC consts container --------------------------------------------------


@pytest.mark.parametrize("with_ext", [False, True])
def test_const_file_equals_jax(tmp_path, with_ext):
    const_n = _random(16, 3, 1)
    const_ext = _random(64, 3, 2) if with_ext else None
    a, b = _same(tmp_path, "consts.bin",
                 lambda p: serialization.write_const_file(p, const_n, const_ext),
                 lambda p: jser.write_const_file(p, const_n, const_ext))
    for path in (a, b):
        header, n, ext = serialization.read_const_file(path)
        jheader, jn, jext = jser.read_const_file(path)
        assert header == jheader and header["nConstants"] == 3
        np.testing.assert_array_equal(n, const_n)
        np.testing.assert_array_equal(n, jn)
        if with_ext:
            np.testing.assert_array_equal(ext, const_ext)
        else:
            assert ext is None and jext is None


def test_const_file_errors(tmp_path):
    good = tmp_path / "good.const"
    serialization.write_const_file(str(good), np.arange(16, dtype=np.uint64).reshape(8, 2))
    cases = {"bad magic": b"XXXX" + good.read_bytes()[4:],
             "truncated": good.read_bytes()[:-16]}
    for match, data in cases.items():
        path = tmp_path / "bad.const"
        path.write_bytes(data)
        with pytest.raises(ValueError, match=match):
            serialization.read_const_file(str(path))
    (tmp_path / "hdr.const").write_bytes(good.read_bytes()[:6])
    with pytest.raises(ValueError, match="truncated"):
        serialization.read_const_file(str(tmp_path / "hdr.const"))


# -- binfile ----------------------------------------------------------------------


def test_container_equals_jax(tmp_path):
    secs = [(2, b"hello"), (3, b""), (5, bytes(range(17)))]
    a, _ = _same(tmp_path, "x.bin", lambda p: binfile.write_bin_file(p, b"abcd", 7, secs, 5),
                 lambda p: jbinfile.write_bin_file(p, b"abcd", 7, secs, 5))
    assert binfile.read_bin_file(a, b"abcd") == (b"abcd", 7, dict(secs))
    assert binfile.is_bin_file(a, b"abcd") and not binfile.is_bin_file(a, b"cnts")
    with pytest.raises(ValueError, match="bad magic"):
        binfile.read_bin_file(a, b"zzzz")
    with open(a, "rb") as f:
        data = f.read()
    with open(a, "wb") as f:  # truncate inside the section payload
        f.write(data[:-1])
    with pytest.raises(ValueError, match="overruns"):
        binfile.read_bin_file(a, b"abcd")


def test_pilcom_const_equals_jax(tmp_path):
    pols = _random(8, 3, 3)
    a, _ = _same(tmp_path, "a.const", lambda p: binfile.write_pilcom_const(p, pols),
                 lambda p: jbinfile.write_pilcom_const(p, pols))
    assert np.array_equal(np.fromfile(a, dtype="<u8")[:3], pols[0])
    np.testing.assert_array_equal(binfile.read_pilcom_const(a, 3), pols)
    header, const_n, ext = serialization.read_const_file(a, n_pols=3)
    assert header == jser.read_const_file(a, n_pols=3)[0]
    assert header["pilcom"] and header["nBits"] == 3 and ext is None
    np.testing.assert_array_equal(const_n, pols)
    with pytest.raises(ValueError, match="not a multiple"):
        binfile.read_pilcom_const(a, 5)


@pytest.mark.parametrize("height", [2, 8, 33, 100, 4096])
def test_node_count_equals_jax(height):
    """(A one-leaf tree is left out: the JAX package's get_n_nodes counts a
    padded level 0 for it, its read_tree a lone root.)"""
    assert binfile.get_n_nodes(height) == jbinfile.get_n_nodes(height)
    assert binfile.get_n_nodes(height) == 4 * sum(merkle.level_sizes(height))


def test_consts_binfile_equals_jax(tmp_path):
    n_bits, ext_bits, n_consts = 4, 6, 3
    fixed_ext = _random(1 << ext_bits, n_consts, 4)
    jtree = jmerkle.merkelize(fixed_ext, n_consts, 1 << ext_bits, backend="np")
    tree = merkle.merkelize(fixed_ext, n_consts, 1 << ext_bits)
    x_n = gl64.powers(gl64.w(n_bits), 1 << n_bits)
    x_ext = gl64.powers(gl64.w(ext_bits), 1 << ext_bits, start=gl64.SHIFT_INT)
    a, _ = _same(tmp_path, "consts.cnts",
                 lambda p: binfile.write_consts_binfile(p, fixed_ext, tree, x_n, x_ext),
                 lambda p: jbinfile.write_consts_binfile(p, fixed_ext, jtree, x_n, x_ext))
    out = binfile.read_consts_binfile(a)
    np.testing.assert_array_equal(out["fixedPolsEvals"], fixed_ext.reshape(-1))
    np.testing.assert_array_equal(out["x_ext"], x_ext)
    tree2 = binfile.tree_from_consts(*out["tree"])
    np.testing.assert_array_equal(tree2.root, jtree.root)
    values, proof = merkle.get_group_proof(tree2, 5)
    assert merkle.verify_group_proof(tree.root, proof, 5, values)


# -- tree files ----------------------------------------------------------------------


def test_tree_file_round_trip(tmp_path):
    buff = _random(33, 4, 9)
    a, b = _same(tmp_path, "tree.bin",
                 lambda p: merkle.write_tree(merkle.merkelize(buff, 4, 33), p),
                 lambda p: jmerkle.write_tree(jmerkle.merkelize(buff, 4, 33, backend="np"), p))
    for path in (a, b):
        tree = merkle.read_tree(path)
        jtree = jmerkle.read_tree(path)
        assert (tree.width, tree.height) == (4, 33)
        np.testing.assert_array_equal(tree.elements, buff)
        np.testing.assert_array_equal(tree.nodes_flat(), jtree.nodes_flat())
        values, proof = merkle.get_group_proof(tree, 20)
        assert merkle.verify_group_proof(tree.root, proof, 20, values)


@pytest.mark.parametrize("split", [False, True], ids=["normal", "split"])
@pytest.mark.parametrize("width,height", [(0, 64), (1, 64), (3, 32), (12, 16), (12, 256)])
def test_device_tree_file_equals_jax(tmp_path, width, height, split):
    buff = _random(height, width, width + height)
    cols = torch_gl.from_u64(np.ascontiguousarray(buff.T)).reshape(width, height)
    tree = dev.merkelize(cols, width, height, split)
    assert tree.uniform == (width == 0)
    host = dev.to_host_tree(tree)
    jtree = jmerkle.merkelize(buff, width, height, split_linear_hash=split, backend="np")
    a, _ = _same(tmp_path, "tree.bin", lambda p: merkle.write_tree(host, p),
                 lambda p: jmerkle.write_tree(jtree, p))
    np.testing.assert_array_equal(merkle.read_tree(a).root, tree.root)

