"""Structured per-phase wall-clock timing of a prove.

Counterpart of pil2_stark_tpu/utils/timing.py.  On a CUDA device a phase
waits for the device at its end, so its time includes the device work it
queued, and its peak device memory is recorded (``peaks``); each phase is
also labelled in a torch.profiler trace (``record_function``), from which
``idle_share`` reads the card's idle share over the prove."""
from __future__ import annotations

import contextlib
import json
import time

import torch


class PhaseTimer:
    """devices: every device the prove runs on (a mesh's; default
    [device]).  Each phase waits for all of their cards; ``peaks`` holds the
    lead card's (`device`) peak per phase and ``device_peaks`` each card's."""

    def __init__(self, logger=None, device=None, devices=None):
        self.timings: dict[str, float] = {}
        self.peaks: dict[str, int] = {}
        self.device_peaks: dict[str, dict[str, int]] = {}
        self.logger = logger
        self.cuda = device if device is not None and device.type == "cuda" else None
        devices = [device] if devices is None else devices
        self.cards = list(dict.fromkeys(d for d in devices if d is not None and d.type == "cuda"))

    def sync(self):
        for card in self.cards:
            torch.cuda.synchronize(card)

    @contextlib.contextmanager
    def phase(self, name: str):
        for card in self.cards:
            torch.cuda.reset_peak_memory_stats(card)
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(name):
                yield
            self.sync()
        finally:
            dt = time.perf_counter() - t0
            self.timings[name] = self.timings.get(name, 0.0) + dt
            peaks = self.device_peaks.setdefault(name, {})
            for card in self.cards:
                peaks[str(card)] = max(peaks.get(str(card), 0),
                                       torch.cuda.max_memory_allocated(card))
            if self.cuda is not None:
                self.peaks[name] = peaks[str(self.cuda)]
            if self.logger:
                self.logger.debug(f"··· {name}: {dt * 1000:.1f} ms")

    def summary(self) -> dict[str, float]:
        return dict(sorted(self.timings.items(), key=lambda kv: -kv[1]))


def chain_ms(fn, x: torch.Tensor, k: int, reps: int) -> float:
    """Milliseconds of one call of `fn` in a chain of `k` calls (each takes
    the previous output), the best of `reps` chains after one warm-up call.
    On a CUDA tensor the chain is timed by CUDA events on the current
    stream; on the CPU by the host clock."""
    fn(x)
    best = float("inf")
    for _ in range(reps):
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            cur = x
            for _ in range(k):
                cur = fn(cur)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / k
        else:
            t0 = time.perf_counter()
            cur = x
            for _ in range(k):
                cur = fn(cur)
            ms = (time.perf_counter() - t0) * 1e3 / k
        best = min(best, ms)
    return best


DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def idle_share(trace, window: str = "prove") -> float:
    """The card's idle share over a window of a torch.profiler Chrome trace
    (a path or the loaded JSON): 1 − (union of the device's kernel, memcpy
    and memset intervals inside the window) / the window.  The window is
    the first CPU span named `window` (stark.prover.prove(profile_dir=)
    records the prove as "prove")."""
    if not isinstance(trace, dict):
        with open(trace) as f:
            trace = json.load(f)
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    span = next((e for e in events if e.get("name") == window
                 and e.get("cat") in ("user_annotation", "cpu_op")), None)
    if span is None:
        raise ValueError(f"no span named {window!r} in the trace")
    w0, w1 = float(span["ts"]), float(span["ts"]) + float(span["dur"])
    if w1 <= w0:
        raise ValueError(f"the span {window!r} is empty")
    busy = sorted((max(w0, float(e["ts"])), min(w1, float(e["ts"]) + float(e["dur"])))
                  for e in events if e.get("cat") in DEVICE_CATEGORIES)
    covered, end = 0.0, w0
    for a, b in busy:
        a = max(a, end)
        if b > a:
            covered += b - a
            end = b
    return 1.0 - covered / (w1 - w0)
