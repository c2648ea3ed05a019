"""The PyTorch port's PIL compiler (pil2_stark_tpu_torch/compiler/) equals
the JAX package's: every committed setup compiles to its JSON, the PIL1
front end gives the same pil and the same errors, optImPols selects the
same im-pols, the pilout codec gives the same bytes, the models' sources
are the same strings, and ``stark_setup`` gives the JAX constRoot.  The
proofs from a setup the port compiled are in tests/test_torch_prover_fib.py,
beside the JAX proofs they equal."""
import copy
import json

import numpy as np
import pytest
import torch

from pil2_stark_tpu.compiler import pil1_parser as jparser, pil2_frontend as jpf
from pil2_stark_tpu.compiler import impols_opt as jimpols_opt, pilinfo as jpilinfo
from pil2_stark_tpu.models import fibonacci as jfib, fibv as jfibv
from pil2_stark_tpu.models import gadgets as jgad, poseidon_vm as jvm
from pil2_stark_tpu.stark import setup as jsetup
from pil2_stark_tpu_torch.compiler import pil1_parser as tparser, pil2_frontend as tpf
from pil2_stark_tpu_torch.compiler import impols_opt as timpols_opt, pilinfo as tpilinfo
from pil2_stark_tpu_torch.field import torch_gl
from pil2_stark_tpu_torch.models import fibonacci as tfib, fibv as tfibv
from pil2_stark_tpu_torch.models import gadgets as tgad, poseidon_vm as tvm
from pil2_stark_tpu_torch.stark import catalog, prover as tprover, setup as tsetup

import test_torch_setups as ts
from test_pilout_codec import _strip, _synthetic_pilout


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch's multi-threaded int64 ops are slow on small CPU tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _json(obj):
    return json.loads(json.dumps(obj))


# -- every committed setup --------------------------------------------------


def test_catalog_tables_match_the_setup_tests():
    assert catalog.CASES == ts.CASES
    assert catalog.DEBUG_CASES == ts.DEBUG_CASES
    assert catalog.FIBV_AIRS == ts.FIBV_AIRS
    assert catalog.FIBV_FILES == ts.FIBV_FILES
    assert catalog.BOUNDARY_STRUCT == ts.BOUNDARY_STRUCT
    assert len(catalog.FILES) == 17
    assert sorted(catalog.FILES) == sorted(p.stem for p in tsetup.SETUPS_DIR.glob("*.json"))


@pytest.mark.parametrize("name", sorted(ts.CASES))
def test_case_compiles_to_committed_json(name):
    assert catalog.compile_file(name) == tsetup.read_setup(name)


@pytest.mark.parametrize("name", ts.DEBUG_CASES)
def test_debug_case_compiles_to_committed_json(name):
    assert catalog.compile_file(f"{name}_debug") == tsetup.read_setup(f"{name}_debug")


@pytest.mark.parametrize("name", ts.FIBV_FILES)
def test_fibv_file_compiles_to_committed_json(name):
    assert catalog.compile_file(name) == tsetup.read_setup(name)


def test_machine_pil_matches_jax():
    for machine, n_bits in (("all", 8), ("fibonacci", 6), ("boundaries", 6), ("poseidon_vm", 6)):
        assert catalog.machine_pil(machine, n_bits) == ts.machine_pil(machine, n_bits), machine


# -- the PIL1 front end -----------------------------------------------------

SOURCES = {
    "fibonacci": lambda m: m.pil_source(6),
    "plookup": lambda m: m.plookup_source(6),
    "permutation": lambda m: m.permutation_source(7),
    "connection": lambda m: m.connection_source(8),
    "all": lambda m: m.all_source(8),
    "poseidon_vm": lambda m: m.pil_source(6),
}
MODELS = {"fibonacci": (tfib, jfib), "poseidon_vm": (tvm, jvm)}


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_compile_pil_source_matches_jax(name):
    tmod, jmod = MODELS.get(name, (tgad, jgad))
    src = SOURCES[name](tmod)
    assert src == SOURCES[name](jmod)
    assert tparser.compile_pil_source(src) == jparser.compile_pil_source(src)


def test_pil_boundaries_matches_jax():
    assert tfib.pil_boundaries(6) == jfib.pil_boundaries(6)


MALFORMED = [
    "constant N = 2**4;",
    "constant %N = 2**4;\nnamespace A(%N);\n    pol commit a;\n    a * b = 0;\n",
    "constant %N = 2**4;\nnamespace A(%N);\n    pol commit a;\n    a = 0\n",
    "constant %N = 2**4;\nnamespace A(%N);\n    pol commit a;\n    a $ 1 = 0;\n",
    "constant %N = 2**4;\nnamespace A(%N);\n    pol commit a;\n    (a + a)' = 0;\n",
    "constant %N = 2**4;\nnamespace A(%N);\n    pol commit a;\n    public p = q(0);\n",
]


@pytest.mark.parametrize("src", MALFORMED)
def test_malformed_source_raises_the_same_pil_error(src):
    with pytest.raises(jparser.PilError) as jerr:
        jparser.compile_pil_source(src)
    with pytest.raises(tparser.PilError) as terr:
        tparser.compile_pil_source(src)
    assert str(terr.value) == str(jerr.value)


def test_include_reads_relative_to_the_file(tmp_path):
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "global.pil").write_text(jgad.GLOBAL_PIL)
    (tmp_path / "main.pil").write_text(
        'constant %N = 2**5;\ninclude "sub/global.pil";\n' + jgad.PERMUTATION_PIL)
    path = str(tmp_path / "main.pil")
    got = tparser.compile_pil_source(open(path).read(), base_dir=str(tmp_path))
    assert got == jparser.compile_pil_source(open(path).read(), base_dir=str(tmp_path))
    assert tparser.compile_pil_source(jgad.permutation_source(5)) == got


# -- optImPols --------------------------------------------------------------


@pytest.mark.parametrize("machine,n_bits,budget", [("fibonacci", 6, None), ("fibonacci", 8, None),
                                                   ("all", 6, 2000), ("all", 8, 3000)])
def test_opt_im_pols_matches_jax(machine, n_bits, budget, monkeypatch):
    """The exact search over the all-gadgets machine spends its whole node
    budget (200,000 nodes per degree, about a minute on each side), so
    there both compilers get the same smaller budget: the same search,
    cut at the same node."""
    if budget is not None:
        monkeypatch.setattr(jimpols_opt, "_NODE_BUDGET", budget)
        monkeypatch.setattr(timpols_opt, "_NODE_BUDGET", budget)
    ss = jgad.stark_struct(n_bits, n_bits + 2)
    got = tpilinfo.pil_info(catalog.machine_pil(machine, n_bits), True, copy.deepcopy(ss),
                            {"optImPols": True})
    want = jpilinfo.pil_info(ts.machine_pil(machine, n_bits), True, copy.deepcopy(ss),
                             {"optImPols": True})
    assert _json(got) == _json(want)


# -- the pilout wire format -------------------------------------------------


def test_encode_pilout_bytes_match_jax():
    assert tfibv.build_pilout() == jfibv.build_pilout()
    assert tpf.encode_pilout(tfibv.build_pilout()) == jpf.encode_pilout(jfibv.build_pilout())
    assert tpf.encode_pilout(_synthetic_pilout()) == jpf.encode_pilout(_synthetic_pilout())


def test_load_pilout_round_trip(tmp_path):
    src = _synthetic_pilout()
    path = tmp_path / "synth.pilout"
    path.write_bytes(tpf.encode_pilout(src))
    dec = tpf.load_pilout(str(path))
    assert _strip(dec) == _strip(src)
    assert dec == jpf.load_pilout(str(path))
    assert tpf.decode_pilout(path.read_bytes()) == dec
    np.testing.assert_array_equal(tpf.fixed_cols_array(tpf.select_air(dec, 0, 0)),
                                  jpf.fixed_cols_array(jpf.select_air(dec, 0, 0)))


def test_load_pilout_unknown_field_raises():
    blob = tpf.encode_pilout(_synthetic_pilout()) + tpf._enc_tag(15, 0) + tpf._enc_varint(7)
    with pytest.raises(ValueError, match="unknown PilOut field"):
        tpf.decode_pilout(blob)


# -- the models' sources ----------------------------------------------------


def test_model_sources_equal_jax():
    assert tfib.PIL_SOURCE == jfib.PIL_SOURCE
    assert tfib.PIL_SOURCE_BOUNDARIES == jfib.PIL_SOURCE_BOUNDARIES
    assert tfib.STARK_STRUCT == jfib.STARK_STRUCT
    for n_bits in (4, 6, 22):
        assert tfib.pil_source(n_bits) == jfib.pil_source(n_bits)
    for name in ("GLOBAL_PIL", "PLOOKUP_PIL", "PERMUTATION_PIL", "CONNECTION_PIL"):
        assert getattr(tgad, name) == getattr(jgad, name), name
    for n_bits in (6, 20):
        for name in ("plookup_source", "permutation_source", "connection_source", "all_source"):
            assert getattr(tgad, name)(n_bits) == getattr(jgad, name)(n_bits), name
    assert tgad.source(["a", "b"], 5) == jgad.source(["a", "b"], 5)
    for args in ((6,), (20, 23), (22, 25)):
        assert tgad.stark_struct(*args, n_queries=32) == jgad.stark_struct(*args, n_queries=32)
    assert tvm.PIL_SOURCE_HEADER == jvm.PIL_SOURCE_HEADER
    assert tvm._pow7_expr("s3") == jvm._pow7_expr("s3")
    for n_bits in (6, 20):
        assert tvm.pil_source(n_bits) == jvm.pil_source(n_bits)
    assert tfibv.STARK_STRUCT == jfibv.STARK_STRUCT
    assert (tfibv.N_BITS, tfibv.MODULE_ID) == (jfibv.N_BITS, jfibv.MODULE_ID)


# -- stark_setup ------------------------------------------------------------


def _fixed_columns(name):
    machine, n_bits, _ = catalog.CASES[name]
    refs = catalog.machine_pil(machine, n_bits)["references"]
    if machine == "poseidon_vm":
        const_cols, _, _ = tvm.build(refs, 1 << n_bits, ts.vm_inputs(1 << n_bits))
    else:
        const_cols, _, _ = tfib.build(refs, 1 << n_bits)
    return const_cols.buffer


@pytest.mark.parametrize("name", ["fibonacci_6", "poseidon_vm_6"])
def test_stark_setup_const_root_matches_jax(name):
    machine, n_bits, ss = catalog.CASES[name]
    fixed = _fixed_columns(name)
    got = tsetup.stark_setup(fixed, catalog.machine_pil(machine, n_bits), copy.deepcopy(ss),
                             device="cpu")
    want = jsetup.stark_setup(fixed, ts.machine_pil(machine, n_bits), copy.deepcopy(ss))
    np.testing.assert_array_equal(got["constRoot"], want["constRoot"])
    assert _json(got["starkInfo"]) == tsetup.read_setup(name)["starkInfo"]
    # the const tree keeps the fixed columns, planar, on the device
    base = got["constTree"].base
    assert base.shape == (fixed.shape[1], 1 << n_bits) and base.device.type == "cpu"
    np.testing.assert_array_equal(torch_gl.to_u64(base), fixed.T)


def test_stark_setup_skip_const_tree():
    machine, n_bits, ss = catalog.CASES["fibonacci_6"]
    got = tsetup.stark_setup(None, catalog.machine_pil(machine, n_bits), copy.deepcopy(ss),
                             {"skipConstTree": True})
    assert "constTree" not in got
    data = tsetup.read_setup("fibonacci_6")
    for key in ("starkInfo", "expressionsInfo", "verifierInfo"):
        assert _json(got[key]) == data[key], key


# -- debug mode without a const tree (fault C3's fallback) -------------------


def test_debug_prove_without_const_tree_uploads_once(monkeypatch):
    """A debug prove with const_tree=None uploads the fixed columns itself,
    once, from the host, and finds no error on a valid witness."""
    data = catalog.compile_file("fibv_module_debug")
    fixed = np.asarray(tsetup.read_setup("fibv_module")["fixedPols"], dtype=np.uint64)
    cm_mod, _, publics = tfibv.execute(101, 1, 2)
    uploads = []
    real = torch_gl.from_u64

    def counting(a, device=None):
        arr = np.asarray(a)
        if arr.shape == fixed.T.shape and np.array_equal(arr, fixed.T):
            uploads.append(arr.shape)
        return real(a, device)

    monkeypatch.setattr(torch_gl, "from_u64", counting)
    errors = tprover.prove(data["starkInfo"], data["expressionsInfo"], fixed, None,
                           (cm_mod, publics), debug=True, device="cpu")
    assert errors == []
    assert uploads == [fixed.T.shape]
