"""A copy of the benchmark in a temporary root whose BENCHMARK.json holds
2^6 cells of two machines, the fibonacci of the benchmark's configuration
and the wide Poseidon VM (the frozen 2^6 setups under tests/data/), added
as files and entries the way a later change adds a configuration and a
cell."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
SMALL = {"vm6.serial": ("poseidon_vm_6", "poseidon_vm", "poseidon_vm_6.setup.json"),
         "fib6.serial": ("fibonacci_6", "fibonacci", "fibonacci_6.setup.json")}


def make_root(tmp: Path) -> Path:
    """A checkout-shaped root: BENCHMARK.json and benchmark/, with the
    small cells added."""
    shutil.copytree(BENCH, tmp / "benchmark", ignore=shutil.ignore_patterns(
        "__pycache__", "_cache"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cell, (config, builder, setup) in SMALL.items():
        info = json.loads((BENCH / "tests" / "data" / setup).read_text())["starkInfo"]
        ss = info["starkStruct"]
        data = dict(name=config, setup=f"../tests/data/{setup}", builder=builder,
                    security={"nBits": ss["nBits"], "blowupBits": ss["nBitsExt"] - ss["nBits"],
                              "nQueries": ss["nQueries"],
                              "friSteps": [s["nBits"] for s in ss["steps"]],
                              "hash": ss["verificationHashType"]})
        (tmp / "benchmark" / "configs" / f"{config}.json").write_text(json.dumps(data))
        (tmp / "benchmark" / "workloads" / f"{cell}.json").write_text(json.dumps(
            {"pool": 2, "profiled_proofs": 1}))
        manifest["configs"].append({"name": config, "source": "https://example.org/small",
                                    "file": f"benchmark/configs/{config}.json",
                                    "reduced": ["nBits"], "why": "a test size"})
        manifest["workloads"].append({"name": cell, "config": config, "traffic": "serial",
                                      "chips": 1, "why": "a test size"})
        for m in manifest["per_layer"]:
            m["workloads"].append(cell)
    (tmp / "BENCHMARK.json").write_text(json.dumps(manifest, indent=1))
    return tmp
