"""The control of ``correct`` at a cell's own size: the reference put in
the program's place with one guarantee of the configuration broken (one
query fewer than its starkStruct states), compared with the reference as
the benchmark's runs compare the program.  It has to read as not correct.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3

One line per seed: the numbers of the control's proof that differ from the
reference's (the run's limit is 0), and the seconds each proof took.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from . import run
from .reference import stark as reference


def broken(info: dict) -> dict:
    """The starkInfo with one query fewer than the configuration states."""
    ss = dict(info["starkStruct"], nQueries=info["starkStruct"]["nQueries"] - 1)
    return dict(info, starkStruct=ss)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    a = ap.parse_args(argv)
    spec = run.find_cell(run.HERE.parent, a.workload)
    data = run.load_setup_file(spec)
    info, expressions = data["starkInfo"], data["expressionsInfo"]
    failed_all = True
    for seed in [int(s) for s in a.seeds.split(",")]:
        fixed, pool = run.build_inputs(spec, data, seed)
        t0 = time.perf_counter()
        ref = reference.prove(info, expressions, fixed, *pool[0], "cuda:0")
        t1 = time.perf_counter()
        ctl = reference.prove(broken(info), expressions, fixed, *pool[0], "cuda:0")
        t2 = time.perf_counter()
        diff = run.differing(run.flatten({"proof": ctl["proof"], "constRoot": ctl["constRoot"]}),
                             run.flatten({"proof": ref["proof"], "constRoot": ref["constRoot"]}))
        failed_all &= diff > 0
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "control_numbers_differing": diff, "limit": 0,
                          "reference_s": t1 - t0, "control_s": t2 - t1}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
