"""The manifest and the files the harness finds by name."""
from __future__ import annotations

import json
import re

import pytest

from benchmark import run
from benchmark.tests.small_cells import ROOT, SMALL, make_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = ["fib22.serial"]
E2E = ["proofs_per_min", "prove_s", "peak_device_GiB", "setup_s"]
LAYER = ["upload_s", "commit_s", "evals_s", "fri_s", "b4_roofline", "ntt_roofline",
         "idle_share", "device_busy_s", "launches_per_proof"]


def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_manifest_holds_the_cells_and_metrics():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert [w["name"] for w in m["workloads"]] == CELLS
    assert [e["name"] for e in m["end_to_end"]] == E2E
    assert [p["name"] for p in m["per_layer"]] == LAYER
    for item in m["configs"] + m["workloads"] + m["end_to_end"] + m["per_layer"]:
        assert NAME.match(item["name"]), item["name"]
    for e in m["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25 and e["source"] in ("host_clock", "device_trace")
    assert next(e for e in m["end_to_end"] if e["name"] == "setup_s")["bound"] <= 0.25
    for p in m["per_layer"]:
        assert p["moves"] in E2E and set(p["workloads"]) <= set(CELLS)
    for w in m["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


@pytest.mark.parametrize("cell", CELLS)
def test_every_file_of_a_cell_is_found_by_name(cell):
    spec = run.find_cell(ROOT, cell)
    setup = run.load_setup_file(spec)
    assert setup["starkInfo"]["starkStruct"]["nQueries"] == spec["config"]["security"]["nQueries"]
    assert (spec["bench"] / "inputs" / f"{spec['config']['builder']}.py").is_file()
    assert {m["name"] for m in spec["end_to_end"]} == set(E2E)
    for m in spec["per_layer"]:
        assert callable(run._module(spec["bench"] / "metrics" / f"{m['name']}.py", m["name"]).read)


def test_a_cell_added_as_files_is_listed_without_an_edit(tmp_path):
    root = make_root(tmp_path)
    for cell in SMALL:
        spec = run.find_cell(root, cell)
        assert run.load_setup_file(spec)["starkInfo"]["starkStruct"]["nBits"] == 6
        assert [m["name"] for m in spec["per_layer"]] == LAYER


def test_a_metric_added_as_a_file_is_read(tmp_path):
    root = make_root(tmp_path)
    (root / "benchmark" / "metrics" / "proofs_profiled.py").write_text(
        "def read(ctx):\n    return ctx['profiled_proofs']\n")
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["per_layer"].append({"name": "proofs_profiled", "unit": "proofs", "better": "higher",
                           "source": "program_counter", "layer": "device", "moves": "prove_s",
                           "workloads": ["vm6.serial"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    spec = run.find_cell(root, "vm6.serial")
    names = [p["name"] for p in spec["per_layer"]]
    assert names[-1] == "proofs_profiled"
    reader = run._module(root / "benchmark" / "metrics" / "proofs_profiled.py", "x")
    assert reader.read({"profiled_proofs": 2}) == 2
    assert "proofs_profiled" not in [p["name"] for p in run.find_cell(root, "fib6.serial")
                                     ["per_layer"]]


def test_a_setup_at_other_security_parameters_is_refused(tmp_path):
    root = make_root(tmp_path)
    path = root / "benchmark" / "configs" / "fibonacci_6.json"
    data = json.loads(path.read_text())
    data["security"]["nQueries"] += 1
    path.write_text(json.dumps(data))
    with pytest.raises(run.CellError, match="proves at"):
        run.load_setup_file(run.find_cell(root, "fib6.serial"))


def test_an_unknown_cell_is_refused():
    with pytest.raises(run.CellError, match="no workload"):
        run.find_cell(ROOT, "nothing.here")


def test_the_spread_is_the_quartile_distance_over_the_median():
    from benchmark.sweep import spread

    assert spread([1.0]) is None
    assert spread([1.0, 1.0, 1.0, 1.0]) == 0.0
    assert abs(spread([0.9, 1.0, 1.0, 1.1]) - 0.15) < 1e-12  # quartiles 0.925 and 1.075
