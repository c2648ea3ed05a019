#!/usr/bin/env python3
"""A/B of checkouts on one card: kernel B4's time, kernel T1's time on the Q
and FRI programs of both proves, kernel B1's at the fibonacci 2^25 prove's
shapes and T2's at 2^22 and 2^25 points, and the fibonacci 2^22 / ext 2^25
prove (its phases and per-phase peak memory), one process per checkout, in
the order given.

    python3 ab_trees.py PARENT . . PARENT

Each argument is the root of a checkout of this repository (for the parent
commit, unpack `git archive <commit>` into a directory that .gitignore
lists).  In each, a fresh process builds every kernel source of that
checkout (``cuda_build.build()``) and, where the checkout generates T1 per
program, the setup's programs (``torch_tac.build_programs``), so no compile
falls inside a timed prove; it times its ``cuda_poseidon.permute`` on 2^22
and 2^25 random states with CUDA events, its T1 on the all-gadgets 2^22
and fibonacci 2^25 Q and FRI programs with its own ``chip_smoke._tac_rows``
(which also holds T1 against ``run_plain``), its B1 and T2 with its own
``_b1_rows`` and ``_xdiv_row`` (each held against its plain version), then
runs its own
``chip_smoke.phase_prove`` on setups/fibonacci_22.json (cold and warm
prove, verify) with the launch counters of its own
``chip_smoke.prove_counters`` (B1–B4 in checkouts older than it);
phase_prove fails if one of them never launched in the cold prove.  Every
run prints one JSON line; then one line with the card's name and power
limit.  Runs in turns
(parent, change, change, parent) put the card's drift on both sides.
Needs a CUDA card; the checkouts' code does the measuring, so both sides
are measured as they measure themselves.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

SETUP = "fibonacci_22"
PHASES = ("commit", "friFold", "friPol", "witness")

SNIPPET = f"""
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as c
from pil2_stark_tpu_torch.hash import cuda_poseidon
from pil2_stark_tpu_torch.ops import cuda_ntt
from pil2_stark_tpu_torch.ops import torch_tac
from pil2_stark_tpu_torch.stark import setup as stark_setup
from pil2_stark_tpu_torch.utils import cuda_build
build_s = cuda_build.build()
if hasattr(torch_tac, "build_programs"):
    data = stark_setup.read_setup("{SETUP}")
    names = torch_tac.build_programs(data["starkInfo"], data["expressionsInfo"])
    build_s.update({{"T1 " + w: cuda_build.build_seconds.get(n, 0.0) for w, n in names.items()}})
dev = torch.device("cuda", 0)
ms = {{}}
for bits, reps in ((22, 20), (25, 5)):
    x = c.random_field((12, 1 << bits), 7, dev)
    ms[bits] = c.cuda_ms(lambda: cuda_poseidon.permute(x), reps)
    del x
    torch.cuda.empty_cache()
t1 = {{}}
for setup in ("all_20", "fibonacci_22"):
    for r in c._tac_rows(dev, setup, ("q", "fri")):
        assert r["max_abs_err"] == 0, r
        t1[setup + "." + r["shape"]["program"]] = r["ms"]
b1 = {{}}
for r in c._b1_rows(dev):
    assert r["max_abs_err"] == 0, r
    b1["{{n}}x{{lanes}}".format(**r["shape"])] = r["ms"]
t2 = {{}}
for bits in (22, 25):
    r = c._xdiv_row(dev, bits, "{SETUP}")
    assert r["max_abs_err"] == 0, r
    t2[bits] = r["ms"]
print(json.dumps({{"b4_ms": ms, "t1_ms": t1, "b1_ms": b1, "t2_ms": t2, "build_s": build_s}}),
      flush=True)
if hasattr(c, "prove_counters"):
    counters = c.prove_counters()
else:
    counters = [cuda_ntt.base_rows, cuda_ntt.level_planar, cuda_ntt.base_grid,
                cuda_poseidon.permute]
c.phase_prove(dev, "{SETUP}", counters)
"""


def run_tree(root: str) -> dict:
    out = subprocess.run([sys.executable, "-c", SNIPPET], cwd=root, capture_output=True,
                         text=True, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"{root}: exit {out.returncode}\n{out.stderr[-3000:]}")
    lines = [json.loads(ln) for ln in out.stdout.splitlines() if ln.startswith("{")]
    b4 = next(ln for ln in lines if "b4_ms" in ln)
    prove = next(ln for ln in lines if ln.get("phase") == "prove_large")
    phases = {k: v for k, v in prove["phases_warm_s"].items()
              if any(p in k for p in PHASES)}
    return {"tree": os.path.abspath(root), "b4_ms": b4["b4_ms"], "t1_ms": b4["t1_ms"],
            "b1_ms": b4["b1_ms"], "t2_ms": b4["t2_ms"],
            "build_s": b4["build_s"], "verified": prove["verified"],
            "cold_s": prove["cold_s"], "warm_s": prove["warm_s"],
            "phases_warm_s": phases, "peak_device_bytes": prove["peak_device_bytes"],
            "phases_peak_bytes": prove["phases_peak_bytes"], "launches": prove["launches"]}


def main(roots) -> int:
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    ok = True
    for root in roots:
        r = run_tree(root)
        ok &= bool(r["verified"])
        print(json.dumps(r), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(card, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
