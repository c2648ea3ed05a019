"""The yardstick of the kernel rooflines: the card's peaks and the work a
proof needs, reckoned from its starkInfo.

The peaks are a frozen copy of chip_smoke.py:298-308 at commit a529475.
Both are NVIDIA H100 SXM data-sheet figures at the full 700 W, not
measurements: HBM at 3.35 TB/s, and the 32-bit integer multiply-add rate
inferred from the published FP32 rate (67e12 FLOP/s, 2 FLOP per FMA, half
as many INT32 lanes as FP32 lanes per SM: 16.75e12 IMAD/s).  A Goldilocks
product is counted as its 4 partial 32x32->64 products, and a Poseidon
permutation as 1,122 such products plus 7 products by the small MDS
matrix of 144 entries, 2 halves each.

The work counts what the proof needs, not what the program launches, so a
share reads the same work whatever implements it (pil2-stark-js
stark_gen_helpers.js, merklehash_p.js, linearhash.js, fri.js):
  * permutations: every Merkle tree the proof builds (each stage's and Q's
    tree over the extended domain, each FRI step's tree but the last),
    a row of more than 4 values absorbed 8 at a time, a row of 4 or fewer
    copied, one permutation per inner node; a zero-width tree is one
    digest chain reckoned on the host, and the const tree is set-up work;
  * transform bytes: each input word read once and each output word
    written once, over each stage's low-degree extension (N to extN rows),
    Q's inverse transform and split (qDim to qDeg·qDim columns of extN),
    the inverse transform of each opening's evaluation vector (3 x N) and
    each FRI fold's grouped inverse transform (3 x the folded size).
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 67e12 / 4
IMAD_PER_GL_MUL = 4
POSEIDON_IMAD = 1122 * IMAD_PER_GL_MUL + 7 * 144 * 2
WORD = 8  # bytes of a Goldilocks element


def tree_permutations(width: int, height: int) -> int:
    if width == 0:
        return 0
    total = height * (0 if width <= 4 else -(-width // 8))
    while height > 1:
        height = (height + 1) // 2
        total += height
    return total


def permutations_per_proof(info: dict) -> int:
    ss = info["starkStruct"]
    ext_n = 1 << ss["nBitsExt"]
    total = sum(tree_permutations(info["mapSectionsN"].get(f"cm{s}", 0), ext_n)
                for s in range(1, info["nStages"] + 2))
    steps = [s["nBits"] for s in ss["steps"]]
    for a, b in zip(steps, steps[1:]):
        total += tree_permutations(3 << (a - b), 1 << b)
    return total


def transform_bytes_per_proof(info: dict) -> int:
    ss = info["starkStruct"]
    n, ext_n = 1 << ss["nBits"], 1 << ss["nBitsExt"]
    words = 0
    for s in range(1, info["nStages"] + 1):
        words += info["mapSectionsN"].get(f"cm{s}", 0) * (n + ext_n)
    words += info["qDim"] * ext_n * (1 + info["qDeg"])
    words += len(info["openingPoints"]) * 3 * n * 2
    steps = [s["nBits"] for s in ss["steps"]]
    words += sum(3 * (1 << a) * 2 for a in steps[:-1])
    return words * WORD


def b4_least_s(info: dict) -> float:
    return permutations_per_proof(info) * POSEIDON_IMAD / IMAD_PER_S


def ntt_least_s(info: dict) -> float:
    return transform_bytes_per_proof(info) / HBM_BYTES_PER_S
