"""Runs of one cell, one process after another, and the spread of each
metric: how the bounds of BENCHMARK.json are measured.

    python3 -m benchmark.sweep --workload <cell> --seeds 11,12,13 --seconds 20 \\
        [--trace 0|1] [--out <file>.jsonl]

Each run is ``python3 -m benchmark.run`` with one seed of the list; its
result line (or its exit code and the end of its standard error) is
appended to --out.  The summary line gives, per metric, the median and the
spread: the distance between the first and the third quartile of
statistics.quantiles(values, n=4), as a share of the median.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time


def spread(values: list) -> float | None:
    if len(values) < 2:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return (q3 - q1) / med if med else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    values, rcs = {}, []
    for seed in [int(s) for s in a.seeds.split(",")]:
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", a.workload,
                            "--seed", str(seed), "--seconds", str(a.seconds),
                            "--trace", str(a.trace)], capture_output=True, text=True)
        rec = {"workload": a.workload, "seed": seed, "trace": a.trace, "rc": p.returncode,
               "wall_s": time.perf_counter() - t0}
        lines = p.stdout.strip().splitlines()
        if p.returncode == 0 and lines:
            rec["result"] = json.loads(lines[-1])
            for k, m in rec["result"]["metrics"].items():
                values.setdefault(k, []).append(m["value"])
        rec["stderr_tail"] = p.stderr[-3000:]
        rcs.append(p.returncode)
        print(json.dumps(rec), flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    summary = {"workload": a.workload, "rcs": rcs,
               "metrics": {k: {"median": statistics.median(v), "spread": spread(v), "n": len(v),
                               "values": v} for k, v in values.items()}}
    print(json.dumps(summary), flush=True)
    if a.out:
        with open(a.out, "a") as f:
            f.write(json.dumps(summary) + "\n")
    return 0 if all(rc == 0 for rc in rcs) else 1


if __name__ == "__main__":
    sys.exit(main())
