"""The benchmark of pil2_stark_tpu_torch: back-to-back eSTARK proofs.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  A cell of BENCHMARK.json names a
configuration (benchmark/configs/<config>.json: its source, security
parameters, frozen setup and input builder) and a traffic mix
(benchmark/traffic/<traffic>.json); benchmark/workloads/<cell>.json holds
what belongs to the cell alone (its witness pool, its profiled proofs).

Set-up builds the fixed columns and a pool of distinct witnesses from the
seed, loads the setup (stark.setup.load_setup: LDE, const tree, T1 from
the build cache) and runs one warm-up proof.  The window then calls
stark.prover.prove back to back in a closed loop, the next witness of the
pool each time, each proof ended by a device synchronisation, and closes
at the return of the first proof that ends after --seconds.  With
--trace 1 the window is followed by the cell's profiled proofs under
torch.profiler, and the line carries the per-layer metrics
(benchmark/metrics/<metric>.py), read from the window's phase timings and
the profiled proofs' events.

After the window the program's state is freed and the result is checked:
every proof of a witness must equal the first proof of that witness, and
one proof drawn from the seed must equal, field for field, the proof that
the plain reference (benchmark/reference/) computes from the same inputs,
with the const root that set-up derived.  The numbers compared close the
standard error and come last in the result line, each with its limit.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import hashlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pil2_stark_tpu")
GIB = 1 << 30
HOST_THREADS = 1  # torch's CPU threads in a run: one setting, so runs differ less
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
              "CUDA_CACHE_PATH": "cuda"}


class CellError(Exception):
    """A cell, configuration or setup that the harness cannot run."""


# -- finding a cell's files by name --------------------------------------------


def load_manifest(root: Path) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise CellError(f"no BENCHMARK.json in {root}")
    with open(path) as f:
        return json.load(f)


def _json(path: Path) -> dict:
    if not path.is_file():
        raise CellError(f"missing {path}")
    with open(path) as f:
        return json.load(f)


def find_cell(root: Path, name: str) -> dict:
    """The cell's manifest entry with its configuration, traffic and cell
    files, and the per-layer metrics it reports."""
    manifest = load_manifest(root)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise CellError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config_entry = configs[cell["config"]]
    bench = root / "benchmark"
    config = _json(root / config_entry["file"])
    e2e = {m["name"] for m in manifest["end_to_end"]
           if "workloads" not in m or name in m["workloads"]}
    per_layer = [m for m in manifest["per_layer"]
                 if m["moves"] in e2e and ("workloads" not in m or name in m["workloads"])]
    return {"name": name, "cell": cell, "config": config, "config_dir": (root / config_entry["file"]).parent,
            "traffic": _json(bench / "traffic" / f"{cell['traffic']}.json"),
            "workload": _json(bench / "workloads" / f"{name}.json"),
            "end_to_end": [m for m in manifest["end_to_end"] if m["name"] in e2e],
            "per_layer": per_layer, "bench": bench}


def _module(path: Path, name: str):
    if not path.is_file():
        raise CellError(f"missing {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_setup_file(spec: dict) -> dict:
    """The configuration's frozen setup, held to the security parameters
    its file states: a setup that proves at other parameters is refused."""
    config = spec["config"]
    setup = _json(spec["config_dir"] / config["setup"])
    ss = setup["starkInfo"]["starkStruct"]
    sec = config["security"]
    have = {"nBits": ss["nBits"], "blowupBits": ss["nBitsExt"] - ss["nBits"],
            "nQueries": ss["nQueries"], "friSteps": [s["nBits"] for s in ss["steps"]],
            "hash": ss.get("verificationHashType", "GL")}
    want = {k: sec[k] for k in have}
    if have != want:
        raise CellError(f"the setup of {config['name']} proves at {have}, its file states {want}")
    return setup


def build_inputs(spec: dict, setup: dict, seed: int):
    """(fixed (N, nConstants) u64, [(witness (N, nCm1) u64, publics)] of
    the cell's pool, each witness drawn from the seed)."""
    info = setup["starkInfo"]
    n = 1 << info["starkStruct"]["nBits"]
    builder = _module(spec["bench"] / "inputs" / f"{spec['config']['builder']}.py",
                      f"benchmark_inputs_{spec['config']['builder']}")
    fixed_cols = builder.fixed(n)
    fixed = np.zeros((n, len(info["constPolsMap"])), dtype=np.uint64)
    for i, c in enumerate(info["constPolsMap"]):
        fixed[:, i] = fixed_cols[c["name"]]
    stage1 = sorted((c["stagePos"], c["name"]) for c in info["cmPolsMap"] if c["stage"] == 1)
    rng = np.random.default_rng(seed)
    pool = []
    for _ in range(spec["workload"]["pool"]):
        cols, publics = builder.witness(n, rng)
        w = np.zeros((n, info["mapSectionsN"]["cm1"]), dtype=np.uint64)
        for pos, name in stage1:
            w[:, pos] = cols[name]
        pool.append((w, [int(p) for p in publics]))
    return fixed, pool


# -- the comparison that decides ``correct`` ----------------------------------


def flatten(obj, prefix="", out=None) -> dict:
    """Every number of a proof under its path."""
    out = {} if out is None else out
    if isinstance(obj, dict):
        for k in sorted(obj):
            flatten(obj[k], f"{prefix}/{k}", out)
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            flatten(v, f"{prefix}/{i}", out)
    elif isinstance(obj, np.ndarray):
        flatten(obj.reshape(-1).tolist(), prefix, out)
    else:
        out[prefix] = int(obj)
    return out


def differing(a: dict, b: dict) -> int:
    """Numbers of two flattened proofs that differ or that one lacks."""
    return sum(a.get(k) != b.get(k) for k in set(a) | set(b))


def digest(proof) -> str:
    return hashlib.sha256(json.dumps(flatten(proof), sort_keys=True).encode()).hexdigest()


def check(spec, setup, fixed, pool, done, const_root, seed, device) -> dict:
    """The numbers compared, each {"value", "limit"}: proofs that differ
    from the first proof of their witness; numbers of the proof drawn from
    the seed (and of the const root) that differ from the reference's."""
    first, repeats = {}, 0
    for k, proof in done:
        d = digest(proof)
        repeats += first.setdefault(k, d) != d
    fields = None  # no proof completed: nothing was checked
    if done:
        from .reference import stark as reference

        k, proof = done[int(np.random.default_rng([seed, 1]).integers(len(done)))]
        witness, publics = pool[k]
        t0 = time.perf_counter()
        ref = reference.prove(setup["starkInfo"], setup["expressionsInfo"], fixed, witness,
                              publics, device)
        print(f"reference proof {time.perf_counter() - t0:.3f} s", file=sys.stderr)
        fields = differing(flatten({"proof": proof, "constRoot": const_root}),
                           flatten({"proof": ref["proof"], "constRoot": ref["constRoot"]}))
    return {"numbers_differing_from_reference": {"value": fields, "limit": 0},
            "proofs_differing_from_repeat": {"value": repeats, "limit": 0}}


def passes(checks: dict) -> bool:
    return all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())


# -- the run ------------------------------------------------------------------


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Prover:
    """One cell set up on a device: its inputs from the seed, the loaded
    setup, and the timed entry (stark.prover.prove unless a test breaks
    it) called on the k-th witness of the pool."""

    def __init__(self, root: Path, name: str, seed: int, device, prove=None):
        from pil2_stark_tpu_torch.stark import prover
        from pil2_stark_tpu_torch.stark import setup as stark_setup

        self.device, self.prove = device, prove or prover.prove
        self.spec = find_cell(root, name)
        self.setup_json = load_setup_file(self.spec)
        self.fixed, self.pool = build_inputs(self.spec, self.setup_json, seed)
        setup = stark_setup.load_setup(self.setup_json["starkInfo"],
                                       self.setup_json["expressionsInfo"],
                                       self.setup_json["verifierInfo"], self.fixed, device=device)
        self.const_root = [int(x) for x in np.asarray(setup["constRoot"]).reshape(-1)]
        self.args = (setup["starkInfo"], setup["expressionsInfo"], self.fixed, setup["constTree"])
        self.k = 0

    def one(self):
        """Prove the next witness of the pool; returns (witness index, result)."""
        k, self.k = self.k % len(self.pool), self.k + 1
        res = self.prove(*self.args, self.pool[k], device=self.device)
        _sync(self.device)
        return k, res

    def window(self, seconds: float) -> dict:
        """Proofs back to back until the first that ends after `seconds`."""
        times, done, phases, failed = [], [], [], 0
        w0 = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            try:
                k, res = self.one()
            except Exception:  # a proof that fails is counted, and the loop goes on
                traceback.print_exc(file=sys.stderr)
                failed, res = failed + 1, None
            t1 = time.perf_counter()
            times.append(t1 - t0)
            if res is not None:
                done.append((k, res["proof"]))
                phases.append(res["timings"])
            if t1 - w0 >= seconds:
                break
        return {"times": times, "done": done, "phases": phases, "failed": failed,
                "window_s": time.perf_counter() - w0}

    def release(self):
        """Free the program's state on the device."""
        import torch

        self.args = None
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()


class PeakMemory:
    """The card's peak of allocated bytes from `start` on, the harness's own
    reading: the program resets torch's peak statistics at each of its
    phases, so every reset first folds the peak up to it in here."""

    def __init__(self, device):
        import torch

        self.device, self.peak = torch.device(device), 0
        self._reset = torch._C._cuda_resetPeakMemoryStats

    def _fold(self, *args):
        import torch

        self.peak = max(self.peak, torch.cuda.max_memory_allocated(self.device))
        return self._reset(*args)

    def start(self):
        import torch

        torch._C._cuda_resetPeakMemoryStats = self._fold
        torch.cuda.reset_peak_memory_stats(self.device)
        self.peak = 0

    def read(self) -> int:
        import torch

        torch._C._cuda_resetPeakMemoryStats = self._reset
        self.peak = max(self.peak, torch.cuda.max_memory_allocated(self.device))
        return self.peak


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, prove=None) -> dict:
    """One run of a cell on `device`; returns the result line's object."""
    import torch

    p = Prover(root, name, seed, device, prove)
    spec = p.spec
    if spec["traffic"]["provers"] != 1:
        raise CellError("this harness runs one prover per card")
    p.one()  # the warm-up proof: every kernel and table of the cell built
    cuda = torch.device(device).type == "cuda"
    memory = PeakMemory(device) if cuda else None
    if cuda:
        memory.start()
    setup_s = time.perf_counter() - t_start
    w = p.window(seconds)  # the window: a closed loop over the pool, nothing else
    times, done, phases, failed, window_s = (w[k] for k in ("times", "done", "phases", "failed",
                                                             "window_s"))
    peak = memory.read() if cuda else 0
    print(f"window {window_s:.3f} s, proofs {[round(t, 4) for t in times]}", file=sys.stderr)

    out = {"attempted": len(times), "failed": failed}
    metrics = {}
    breakdown = None
    dev_extra = {}
    if not trace:
        values = {"proofs_per_min": (len(done) * 60.0 / window_s, "proofs/min"),
                  "prove_s": (sum(times) / len(times), "s"),
                  "peak_device_GiB": (peak / GIB, "GiB"),
                  "setup_s": (setup_s, "s")}
        for m in spec["end_to_end"]:
            v, unit = values[m["name"]]
            metrics[m["name"]] = {"value": v, "unit": unit}
    else:
        from torch.profiler import ProfilerActivity, profile, record_function

        from . import trace as tr

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        n_prof = spec["workload"]["profiled_proofs"]
        with profile(activities=activities, record_shapes=False, profile_memory=False,
                     with_stack=False) as prof:  # events and spans alone
            for _ in range(n_prof):
                with record_function(tr.PROOF_SPAN):
                    p.one()
        tr_ = tr.read_profile(prof, {tr.PROOF_SPAN} | {k for ph in phases for k in ph})
        del prof
        ctx = {"phases": phases, "times": times, "trace": tr_, "info": p.setup_json["starkInfo"],
               "profiled_proofs": n_prof}
        for m in spec["per_layer"]:
            reader = _module(spec["bench"] / "metrics" / f"{m['name']}.py",
                             f"benchmark_metric_{m['name'].replace('.', '_')}")
            v = reader.read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        wins = tr_.proofs
        busy_s = sum(tr.busy(tr_.device, a, b) for a, b in wins)
        dev_extra = {"busy_s": busy_s, "window_s": sum(b - a for a, b in wins)}
        breakdown = _breakdown(tr_, n_prof)

    # the window is closed: free the program's state, then check the proofs
    p.release()
    checks = check(spec, p.setup_json, p.fixed, p.pool, done, p.const_root, seed, device)
    out.update(correct=failed == 0 and passes(checks), metrics=metrics,
               device={"platform": "gpu" if cuda else "cpu", "kind": _device_kind(device),
                       "count": 1, "memory_peak_bytes": peak, **dev_extra,
                       **_power_limit(cuda)})
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def _breakdown(t, n_prof: int) -> dict:
    """Per profiled proof: the device operations that took most time, and
    the device's idle time split over the host spans (the prover's
    phases) it fell in."""
    from .trace import PROOF_SPAN, gaps

    by_op, idle = {}, {}
    for name, a, b in t.device_in_proofs():
        by_op[name[:160]] = by_op.get(name[:160], 0.0) + (b - a) / n_prof
    phases = [s for s in t.spans if s[0] != PROOF_SPAN]
    for a, b in t.proofs:
        for g0, g1 in gaps(t.device, a, b):
            rest = g1 - g0
            for name, p0, p1 in phases:
                part = min(g1, p1) - max(g0, p0)
                if part > 0:
                    idle[name] = idle.get(name, 0.0) + part / n_prof
                    rest -= part
            if rest > 0:
                idle["between phases"] = idle.get("between phases", 0.0) + rest / n_prof
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    gap = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in gap]}


def _device_kind(device) -> str:
    import torch

    if torch.device(device).type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def _power_limit(cuda: bool) -> dict:
    if not cuda:
        return {}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                              "-i", str(_visible_index())], capture_output=True, text=True,
                             timeout=30, check=True).stdout.strip()
        return {"power_limit_w": float(out.splitlines()[0])}
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return {"power_limit_w": None}


def _visible_index() -> int:
    vis = os.environ.get("CUDA_VISIBLE_DEVICES", "")
    first = vis.split(",")[0].strip()
    return int(first) if first.isdigit() else 0


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    root = HERE.parent
    for var, sub in CACHE_DIRS.items():  # every cache at a fixed place in the checkout
        os.environ.setdefault(var, str(HERE / "_cache" / sub))
    import torch

    torch.set_num_threads(HOST_THREADS)
    try:
        chips = find_cell(root, a.workload)["cell"]["chips"]
    except CellError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3
    try:
        out = run_cell(root, a.workload, a.seed, a.seconds, bool(a.trace), "cuda:0", T_START)
    except CellError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"benchmark: the process loaded {found}", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(f"correct = {out['correct']}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
