"""The permutation and transform-byte reckonings equal what counting
wrappers see in a CPU proof of the frozen 2^6 setups."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from benchmark import roofline, run
from benchmark.tests.small_cells import SMALL, make_root


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_reckonings_equal_the_counted_work(cell, tmp_path, monkeypatch):
    from pil2_stark_tpu_torch.hash import torch_poseidon
    from pil2_stark_tpu_torch.ops import ntt as ntt_ops
    from pil2_stark_tpu_torch.stark import prover
    from pil2_stark_tpu_torch.stark import setup as stark_setup

    spec = run.find_cell(make_root(tmp_path), cell)
    data = run.load_setup_file(spec)
    fixed, pool = run.build_inputs(spec, data, 5)
    setup = stark_setup.load_setup(data["starkInfo"], data["expressionsInfo"],
                                   data["verifierInfo"], fixed, device="cpu")
    perms, words, depth = [0], [0], [0]
    real = {k: getattr(ntt_ops, k) for k in ("lde_planar", "planar_ntt", "intt", "intt_rows")}
    real_perm = torch_poseidon.permute_planar

    def counted(name):
        def f(x, *a, **k):
            depth[0] += 1
            try:
                out = real[name](x, *a, **k)
            finally:
                depth[0] -= 1
            if depth[0] == 0:
                if name == "planar_ntt":  # Q: its values read once, its pieces written once
                    words[0] += x.numel() if a[1] else out.numel()
                else:
                    words[0] += x.numel() + out.numel()
            return out
        return f

    def perm(state):
        perms[0] += state.shape[1]
        return real_perm(state)

    for name in real:
        monkeypatch.setattr(ntt_ops, name, counted(name))
    monkeypatch.setattr(torch_poseidon, "permute_planar", perm)
    prover.prove(setup["starkInfo"], setup["expressionsInfo"], fixed, setup["constTree"],
                 pool[0], device="cpu")
    info = data["starkInfo"]
    assert perms[0] == roofline.permutations_per_proof(info)
    assert words[0] * roofline.WORD == roofline.transform_bytes_per_proof(info)


def test_the_full_size_reckonings():
    """The configuration's counts, reckoned by hand from its starkInfo."""
    from benchmark.tests.small_cells import BENCH

    fib = json.loads((BENCH / "configs" / "fibonacci_22.setup.json").read_text())["starkInfo"]
    ext = 1 << 25
    # each FRI tree but the last: 3 << 3 values a row (24 > 4: 3 absorptions), 2^b rows
    fri = sum((1 << b) * 3 + (1 << b) - 1 for b in (22, 19, 16, 13, 10, 7, 4, 1))
    assert roofline.permutations_per_proof(fib) == (
        3 * (ext - 1) + fri)  # cm1 2 wide, cm3 1, Q 3: each row copied; cm2 empty
    assert roofline.tree_permutations(24, 8) == 8 * 3 + 4 + 2 + 1
    assert roofline.tree_permutations(5, 3) == 3 + 2 + 1
    n = 1 << 22
    assert roofline.transform_bytes_per_proof(fib) == 8 * (
        (2 + 0 + 1) * (n + ext) + 3 * ext * 2 + 2 * 3 * n * 2
        + sum(3 * (1 << a) * 2 for a in (25, 22, 19, 16, 13, 10, 7, 4)))
    assert np.isclose(roofline.b4_least_s(fib),
                      roofline.permutations_per_proof(fib) * 6504 / 16.75e12)


def test_idle_share_divides_the_busy_time_by_the_unprofiled_proofs():
    """Busy seconds per profiled proof over the mean wall time of the
    window's proofs, not over the profiled proofs' own (slower) spans."""
    import importlib

    from benchmark import trace

    idle = importlib.import_module("benchmark.metrics.idle_share")
    busy = importlib.import_module("benchmark.metrics.device_busy_s")
    span = trace.PROOF_SPAN
    t = trace.Trace(spans=[(span, 0.0, 4.0), (span, 10.0, 14.0)],
                    device=[("k", 0.5, 1.0), ("k", 0.8, 1.5), ("m", 10.0, 11.0), ("k", 20.0, 21.0)])
    ctx = {"trace": t, "times": [2.0, 2.0, 2.0]}
    assert busy.read(ctx) == pytest.approx(1.0)  # (1.0 + 1.0) over 2 proofs
    assert idle.read(ctx) == pytest.approx(50.0)  # 1 - 1.0 / 2.0
    assert idle.read({"trace": t, "times": []}) is None
    assert busy.read({"trace": trace.Trace(spans=[], device=[])}) is None
