"""What decides ``correct``: the reference gives the program's CPU proof
at 2^6; the control (the reference at a broken guarantee) and the faults
planted under the timed path come out as not correct."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import control, run
from benchmark.reference import stark as reference
from benchmark.tests.small_cells import SMALL, make_root


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


def _inputs(root, cell, seed):
    spec = run.find_cell(root, cell)
    data = run.load_setup_file(spec)
    fixed, pool = run.build_inputs(spec, data, seed)
    return data, fixed, pool


@pytest.mark.parametrize("blocks", [False, True], ids=["whole", "blocks"])
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_reference_gives_the_programs_proof(root, cell, blocks, monkeypatch):
    """Also with the reference's blocks cut small, so that its block loops
    run at 2^6 as they run at the full sizes."""
    if blocks:
        from benchmark.reference import hash as ref_hash

        monkeypatch.setattr(ref_hash, "CHUNK", 24)
        monkeypatch.setattr(reference, "BLOCK", 1 << 9)
        monkeypatch.setattr(reference, "ROW_BLOCK", 1 << 5)
    from pil2_stark_tpu_torch.stark import prover
    from pil2_stark_tpu_torch.stark import setup as stark_setup

    data, fixed, pool = _inputs(root, cell, 2**31 + 11)
    setup = stark_setup.load_setup(data["starkInfo"], data["expressionsInfo"],
                                   data["verifierInfo"], fixed, device="cpu")
    res = prover.prove(setup["starkInfo"], setup["expressionsInfo"], fixed, setup["constTree"],
                       pool[1], device="cpu")
    ref = reference.prove(data["starkInfo"], data["expressionsInfo"], fixed, *pool[1], "cpu")
    mine = run.flatten({"proof": res["proof"], "constRoot": setup["constRoot"]})
    theirs = run.flatten({"proof": ref["proof"], "constRoot": ref["constRoot"]})
    assert len(theirs) > 1000 and run.differing(mine, theirs) == 0


class _Control:
    """The reference in the program's place, answering one query fewer
    than the setup states."""

    def prove(self, info, expressions, fixed, witness, publics, device):
        return reference.prove(control.broken(info), expressions, fixed, witness, publics,
                               device)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_control_is_not_correct(root, cell):
    data, fixed, pool = _inputs(root, cell, 3)
    ctl = _Control().prove(data["starkInfo"], data["expressionsInfo"], fixed, *pool[0], "cpu")
    checks = run.check(run.find_cell(root, cell), data, fixed, pool, [(0, ctl["proof"])],
                       ctl["constRoot"], 3, "cpu")
    assert checks["numbers_differing_from_reference"]["value"] > 0
    assert not run.passes(checks)


def _stale():
    """A prove that hands back the proof it made before (its state left
    unchanged), from the second call on."""
    from pil2_stark_tpu_torch.stark import prover

    last = []

    def prove(*a, **k):
        res = prover.prove(*a, **k)
        if last:
            res, last[0] = last[0], res
        else:
            last.append(res)
        return res
    return prove


def _altered():
    """A prove whose proof has one answer altered where it is made: the
    first value of the first query's first tree."""
    from pil2_stark_tpu_torch.stark import prover

    def prove(*a, **k):
        res = prover.prove(*a, **k)
        vals = res["proof"]["fri"][0]["polQueries"][0][0][0]
        vals[0] = (int(vals[0]) + 1) % (2**64 - 2**32 + 1)
        return res
    return prove


def _half_queries():
    """A prove that leaves half of its query answers out."""
    from pil2_stark_tpu_torch.stark import prover

    def prove(*a, **k):
        res = prover.prove(*a, **k)
        for step in res["proof"]["fri"][:-1]:
            step["polQueries"] = step["polQueries"][: len(step["polQueries"]) // 2]
        return res
    return prove


@pytest.mark.parametrize("fault", [_stale, _altered, _half_queries])
def test_a_run_with_a_broken_timed_path_is_not_correct(root, fault):
    out = run.run_cell(root, "fib6.serial", 21, 0.5, False, "cpu", 0.0, prove=fault())
    assert out["correct"] is False
    assert list(out)[-1] == "checks"


def test_a_sound_run_is_correct(root):
    out = run.run_cell(root, "vm6.serial", 2**31 + 7, 0.5, False, "cpu", 0.0)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"proofs_per_min", "prove_s", "peak_device_GiB", "setup_s"}
    assert list(out)[-1] == "checks"
