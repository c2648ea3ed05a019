"""device_busy_s: seconds per profiled proof in which some kernel, memcpy
or memset ran on the card (the union of the device's operations inside
each proof's span, benchmark/trace.py busy).  The work the card does for
a proof, which the profiler's cost on the host leaves alone: the floor
that prove_s approaches as host dispatch is hidden."""
from benchmark import trace


def read(ctx):
    t = ctx["trace"]
    wins = t.proofs
    if not t.device or not wins:
        return None
    return sum(trace.busy(t.device, a, b) for a, b in wins) / len(wins)
