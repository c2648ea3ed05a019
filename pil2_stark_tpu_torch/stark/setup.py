"""STARK setup, device half: extend and Merkelize the fixed columns.

The port does not compile PIL.  It takes the artifacts the JAX compiler
emits (``starkInfo``, ``expressionsInfo``, ``verifierInfo``, committed as
JSON under ``setups/``) the way the reference's prover takes
``starkinfo.json``, plus the fixed columns, and builds the constant tree on
the device with its own LDE and Merkle code — the non-compiler half of
pil2_stark_tpu/stark/setup.py:30-45.  On a CUDA device it also builds
kernel T1 for the setup's TAC programs (ops/torch_tac.build_programs), so
that no prove waits on nvcc.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..field import torch_gl as gl
from ..ops import ntt as ntt_ops
from ..ops import torch_tac
from . import device as dev
from .context import resolve_device

SETUPS_DIR = Path(__file__).resolve().parent.parent / "setups"


def read_setup(name: str) -> dict:
    """A committed setup: {"starkInfo", "expressionsInfo", "verifierInfo",
    "references", ...} from setups/<name>.json."""
    with open(SETUPS_DIR / f"{name}.json") as f:
        return json.load(f)


def load_setup(stark_info: dict, expressions_info: dict, verifier_info: dict,
               const_pols: np.ndarray, device=None) -> dict:
    """const_pols: (N, nConstants) u64.  Returns {starkInfo, expressionsInfo,
    verifierInfo, fixedPols, constTree, constRoot}; the const tree is a
    DeviceTree on `device` (None means "cuda").  On CUDA, T1 is built for
    the im-pol, Q and FRI programs first."""
    device = resolve_device(device)
    if device.type == "cuda":
        torch_tac.build_programs(stark_info, expressions_info)
    ss = stark_info["starkStruct"]
    n_bits, n_bits_ext = ss["nBits"], ss["nBitsExt"]
    n_constants = len(stark_info["constPolsMap"])
    const_pols = np.asarray(const_pols, dtype=np.uint64).reshape(1 << n_bits, n_constants)
    const_n = gl.from_u64(np.ascontiguousarray(const_pols.T), device)
    if n_constants > 0:
        const_ext = ntt_ops.lde_planar(const_n, n_bits, n_bits_ext)
    else:
        const_ext = const_n.new_zeros((0, 1 << n_bits_ext))
    tree = dev.merkelize(const_ext, n_constants, 1 << n_bits_ext,
                         ss.get("splitLinearHash", False))
    return {
        "starkInfo": stark_info,
        "expressionsInfo": expressions_info,
        "verifierInfo": verifier_info,
        "fixedPols": const_pols,
        "constTree": tree,
        "constRoot": tree.root,
    }
