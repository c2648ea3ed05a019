"""idle_share: the share (%) of an unprofiled proof in which no kernel,
memcpy or memset ran on the card: 1 - (device busy seconds per profiled
proof) / (mean wall seconds of the window's unprofiled proofs).

The device's busy time is the union of its operations inside each
profiled proof (benchmark/trace.py busy).  The profiler slows the host,
not the card: a profiled proof of fibonacci 2^22 takes 1.3 to 1.5 times an
unprofiled one, so the idle share over the profiled proofs' own spans
(the run's device.busy_s / device.window_s) reads far higher and moves
with the profiler's cost per launch.  Dividing by the unprofiled wall
time is the arithmetic of chip_smoke.py's idle_share_unprofiled
(chip_smoke.py:2277-2288 at commit a529475)."""
from benchmark import trace


def read(ctx):
    t, times = ctx["trace"], ctx["times"]
    wins = t.proofs
    if not t.device or not wins or not times:
        return None
    busy = sum(trace.busy(t.device, a, b) for a, b in wins) / len(wins)
    return 100.0 * (1.0 - busy / (sum(times) / len(times)))
