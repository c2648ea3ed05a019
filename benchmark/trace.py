"""What the benchmark reads from a torch.profiler run over whole proofs:
the host's spans (the prover's phases and the benchmark's own span around
each proof) and the device's operations, kept in memory (no Chrome trace
is written), in seconds from the trace's start.

``busy`` is the arithmetic of pil2_stark_tpu_torch/utils/timing.py
idle_share at commit a529475: the union of the device's kernel, memcpy
and memset intervals clipped to a window.
"""
from __future__ import annotations

import dataclasses

PROOF_SPAN = "bench.proof"


@dataclasses.dataclass
class Trace:
    spans: list  # (name, start s, end s) of the host's annotations
    device: list  # (name, start s, end s) of the device's operations

    @property
    def proofs(self) -> list:
        return [(a, b) for name, a, b in self.spans if name == PROOF_SPAN]

    def device_in_proofs(self) -> list:
        """The device operations that start inside a profiled proof."""
        wins = self.proofs
        return [d for d in self.device if any(a <= d[1] < b for a, b in wins)]


def read_profile(prof, span_names) -> Trace:
    """The spans and device operations of a finished torch.profiler.profile.
    span_names: the host annotations to keep (the prover's phases and
    PROOF_SPAN); the device's copies of those annotations are not
    operations, and every other event on the card is a kernel, a memcpy or
    a memset.  Reads the events' names, devices and times alone, which
    every recent torch gives."""
    from torch.autograd import DeviceType

    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    spans, device = [], []
    for e in res.events():
        name = e.name()
        start = e.start_ns()
        end = e.end_ns() if hasattr(e, "end_ns") else start + e.duration_ns()
        item = (name, (start - t0) * 1e-9, (end - t0) * 1e-9)
        if e.device_type() == DeviceType.CPU:
            if name in span_names:
                spans.append(item)
        elif name not in span_names:
            device.append(item)
    spans.sort(key=lambda s: s[1])
    device.sort(key=lambda d: d[1])
    return Trace(spans, device)


def busy(device: list, w0: float, w1: float) -> float:
    """Seconds of [w0, w1] in which some device operation ran."""
    covered, end = 0.0, w0
    for _, a, b in device:
        a, b = max(a, end, w0), min(b, w1)
        if b > a:
            covered += b - a
            end = b
    return covered


def gaps(device: list, w0: float, w1: float) -> list:
    """The idle intervals of [w0, w1]."""
    out, end = [], w0
    for _, a, b in device:
        if a > end and a <= w1:
            out.append((end, min(a, w1)))
        end = max(end, min(b, w1))
    if end < w1:
        out.append((end, w1))
    return out
