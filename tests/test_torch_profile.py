"""The profiler of the PyTorch port on the CPU: utils/timing.py::idle_share
on small synthetic Chrome traces (overlapping, nested and clipped device
intervals), and prove(profile_dir=) writing a trace whose "prove" span and
phase spans idle_share reads."""
import json

import numpy as np
import pytest
import torch

from pil2_stark_tpu_torch.stark import prover as tprover, setup as tsetup
from pil2_stark_tpu_torch.utils import timing

from test_torch_cases import case_inputs

@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch's multi-threaded int64 ops are slow on small CPU tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _trace(window, device):
    events = [{"ph": "X", "cat": "user_annotation", "name": "prove", "ts": window[0],
               "dur": window[1] - window[0]},
              {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": window[0] + 1, "dur": 50}]
    events += [{"ph": "X", "cat": cat, "name": f"k{i}", "ts": a, "dur": b - a}
               for i, (cat, a, b) in enumerate(device)]
    return {"traceEvents": events}


@pytest.mark.parametrize("device,want", [
    ([], 1.0),
    ([("kernel", 100, 200)], 0.9),
    # overlapping and nested intervals count once; a memcpy and a memset count
    ([("kernel", 100, 300), ("kernel", 200, 400), ("kernel", 250, 260),
      ("gpu_memcpy", 500, 600), ("gpu_memset", 700, 750)], 0.55),
    # intervals outside the window are clipped to it
    ([("kernel", -100, 50), ("kernel", 950, 1200), ("kernel", 2000, 3000)], 0.9),
    # host spans on the device's stream annotation do not count
    ([("gpu_user_annotation", 0, 1000), ("kernel", 0, 1000)], 0.0),
])
def test_idle_share_synthetic(tmp_path, device, want):
    trace = _trace((0, 1000), device)
    assert timing.idle_share(trace) == pytest.approx(want, abs=1e-12)
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(trace))
    assert timing.idle_share(str(path)) == pytest.approx(want, abs=1e-12)


def test_idle_share_needs_the_window():
    with pytest.raises(ValueError):
        timing.idle_share(_trace((0, 1000), []), window="absent")


def test_prove_writes_a_trace(tmp_path):
    """prove(profile_dir=) around a debug prove of the Poseidon VM at 2^6
    (a whole prove's trace on the CPU holds every plain-torch op: about
    150 MB for the smallest air; tests/test_torch_cuda.py profiles a whole
    prove on the card): the same errors, and a trace with the prove's and
    the phases' spans."""
    debug = tsetup.read_setup("poseidon_vm_6_debug")
    _, const_cols, cm_cols, _ = case_inputs("poseidon_vm_6")
    bad = cm_cols.buffer.copy()
    bad[7, 0] ^= np.uint64(1)
    args = (debug["starkInfo"], debug["expressionsInfo"], const_cols.buffer, None, (bad, []))
    plain = tprover.prove(*args, debug=True, device="cpu")
    errors = tprover.prove(*args, debug=True, device="cpu", profile_dir=str(tmp_path))
    assert errors == plain and errors
    with open(tmp_path / "trace.json") as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"prove", "init", "stage1.witness", "stage3.witness"} <= names
    assert timing.idle_share(trace) == 1.0  # no device on the CPU
