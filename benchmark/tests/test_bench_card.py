"""The harness, the reference and the control on the card, at 2^6 (the
full-size control runs on the chip through benchmark.control).  Run on the
machine with the card:

    python -m pytest -m cuda benchmark/tests -q -p no:cacheprovider
"""
from __future__ import annotations

import pytest

from benchmark import control, run
from benchmark.reference import stark as reference
from benchmark.tests.small_cells import SMALL, make_root


@pytest.fixture(scope="module")
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALL))
@pytest.mark.parametrize("trace", [False, True])
def test_a_small_cell_runs_correct_on_the_card(card, root, cell, trace):
    out = run.run_cell(root, cell, 2**31 + 3, 1.0, trace, card, 0.0)
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
    if trace:
        assert {"b4_roofline", "idle_share", "launches_per_proof"} <= set(out["metrics"])
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
        assert out["breakdown"]["device_ops"]
    else:
        assert out["metrics"]["peak_device_GiB"]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_control_is_not_correct_on_the_card(card, root, cell):
    spec = run.find_cell(root, cell)
    data = run.load_setup_file(spec)
    fixed, pool = run.build_inputs(spec, data, 9)
    ctl = reference.prove(control.broken(data["starkInfo"]), data["expressionsInfo"], fixed,
                          *pool[0], card)
    checks = run.check(spec, data, fixed, pool, [(0, ctl["proof"])], ctl["constRoot"], 9, card)
    assert not run.passes(checks)


@pytest.mark.cuda
def test_the_window_peak_outlasts_the_programs_resets(card, root):
    """The prover resets torch's peak statistics at each phase; the
    harness's reading still holds the highest phase peak of the proof."""
    p = run.Prover(root, "vm6.serial", 5, card)
    p.one()
    memory = run.PeakMemory(card)
    memory.start()
    _, res = p.one()
    assert memory.read() >= max(res["peakBytes"].values()) > 0
