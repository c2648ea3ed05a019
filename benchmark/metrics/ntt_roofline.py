"""ntt_roofline: the NTT kernels' (csrc/ntt.cu: B1's row passes, B2's
level pass, B3's grid passes) share (%) of their roofline over the
profiled proofs: the least time of the bytes the proof's transforms need
(benchmark/roofline.py, each word read once and written once, at the
card's data-sheet HBM rate) over the device time of the kernels named
below.  A renamed kernel drops out of the measured time, so a program
that renames one reads wrong until a benchmark change names it."""
import re

from benchmark import roofline

KERNELS = ("base_rows_reg_kernel", "base_rows_pass_kernel", "level_pass_kernel")
_NAME = re.compile(r"\b(" + "|".join(KERNELS) + r")\b")


def read(ctx):
    spent = sum(b - a for name, a, b in ctx["trace"].device_in_proofs() if _NAME.search(name))
    if spent <= 0:
        return None
    return 100.0 * roofline.ntt_least_s(ctx["info"]) * ctx["profiled_proofs"] / spent
