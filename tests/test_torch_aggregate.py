"""The port's vadcop aggregation circuits (compiler/vadcop.py) against the
JAX package's: the vadcop mux library, the Aggregate2 main template (with
and without subproof values), the whole aggregation file set for the
smallest chain's fibonacci setup, and aggregate2_zkin of two proofs made
from different inputs.  The circuit text and inputs are strings and
integers, so equality is exact.  Compiling Aggregate2 through the circom
front-end (about 30 s here under pytest) and proving its C12 are left to
chip_smoke.py's small phase, on the card and on the CPU, to keep this
file within its time budget."""
import copy

import pytest
import torch

from pil2_stark_tpu.compiler import vadcop as jvad
from pil2_stark_tpu_torch.compiler import vadcop as tvad
from pil2_stark_tpu_torch.stark import setup as tsetup

from test_torch_recursion_cases import inner_proof


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def two_proofs():
    s, _, zkin_a = inner_proof((1, 2))
    _, _, zkin_b = inner_proof((3, 5), setup=s)
    return s, zkin_a, zkin_b


def test_vadcop_library_equals_jax():
    assert tvad.emit_vadcop() == jvad.emit_vadcop()


@pytest.mark.parametrize("name", ["fibonacci_6", "fibv_fibonacci"])
@pytest.mark.parametrize("n_recursives1", [1, 3])
def test_aggregate2_template_equals_jax(name, n_recursives1):
    """fibv_fibonacci carries a subproof value (AggregateSubproofValues)."""
    info = tsetup.read_setup(name)["starkInfo"]
    n_sub = info.get("nSubproofValues", 0)
    for agg_types in (None, [1] * n_sub):
        text = tvad.gen_aggregate2(info, n_recursives1, agg_types)
        assert text == jvad.gen_aggregate2(info, n_recursives1, agg_types)
    assert ("AggregateSubproofValues" in text) == (n_sub > 0)


def test_aggregation_files_equal_jax(two_proofs):
    s = two_proofs[0]
    root = [int(v) for v in s["constRoot"]]
    for n_rec in (1, 2):
        files = tvad.emit_aggregation_files(root, s["starkInfo"], s["verifierInfo"],
                                            n_recursives1=n_rec)
        assert files == jvad.emit_aggregation_files(root, s["starkInfo"], s["verifierInfo"],
                                                    n_recursives1=n_rec)
    assert {"aggregate2.circom", "vadcop.circom", "verifier.circom"} <= set(files)
    assert "component main" not in files["verifier.circom"]


def test_aggregate2_zkin_equals_jax(two_proofs):
    s, zkin_a, zkin_b = two_proofs
    root = [int(v) for v in s["constRoot"]]
    assert zkin_a["publics"] != zkin_b["publics"]
    for kw in ({}, {"circuit_type_b": 0}, {"circuit_type_a": 1, "circuit_type_b": 7}):
        got = tvad.aggregate2_zkin(copy.deepcopy(zkin_a), copy.deepcopy(zkin_b),
                                   [0, 0, 0, 0], [root], **kw)
        want = jvad.aggregate2_zkin(copy.deepcopy(zkin_a), copy.deepcopy(zkin_b),
                                    [0, 0, 0, 0], [root], **kw)
        assert got == want
    assert got["a_publics"] == zkin_a["publics"] and got["b_publics"] == zkin_b["publics"]
    assert (got["a_circuitType"], got["b_circuitType"]) == (1, 7)

