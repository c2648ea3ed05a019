"""b4_roofline: kernel B4's (csrc/poseidon.cu) share (%) of its roofline
over the profiled proofs: the least time of the permutations the proof's
Merkle trees need (benchmark/roofline.py: permutations x POSEIDON_IMAD at
the card's data-sheet IMAD rate) over the device time of the kernels
named below.  A program whose trees run under another kernel name reads
nothing here until a benchmark change names it."""
import re

from benchmark import roofline

KERNELS = ("poseidon_kernel",)
_NAME = re.compile(r"\b(" + "|".join(KERNELS) + r")\b")


def read(ctx):
    spent = sum(b - a for name, a, b in ctx["trace"].device_in_proofs() if _NAME.search(name))
    if spent <= 0:
        return None
    return 100.0 * roofline.b4_least_s(ctx["info"]) * ctx["profiled_proofs"] / spent
