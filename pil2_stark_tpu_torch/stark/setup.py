"""STARK setup: compile the constraint system, extend and Merkelize the
fixed columns.

``stark_setup`` is the port of pil2_stark_tpu/stark/setup.py:16: the
port's own PIL compiler (compiler/pilinfo.py) makes ``starkInfo``,
``expressionsInfo`` and ``verifierInfo``, and ``load_setup`` builds the
constant tree on the device with the port's LDE and Merkle code.
``load_setup`` also takes artifacts compiled before (the JSON committed
under ``setups/``, ``read_setup``) the way the reference's prover takes
``starkinfo.json``.  On a CUDA device it builds kernel T1 for the setup's
TAC programs (ops/torch_tac.build_programs), so that no prove waits on
nvcc, and the const tree keeps the base-domain fixed columns on the device
(``DeviceTree.base``), so that no prove uploads them again.  The tree's
hash follows ``verificationHashType`` (hash/mh.py): GL trees are built on
the device, BN128 trees on the host from the extended columns the device
computed, and a BN128 tree keeps ``base`` too.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..compiler.pilinfo import pil_info as compile_pil_info
from ..field import torch_gl as gl
from ..hash.mh import build_mh
from ..ops import ntt as ntt_ops
from ..ops import torch_tac
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
    verifierInfo, fixedPols, constTree, constRoot}; the const tree (a
    DeviceTree, or an mh.TreeBN128 whose root is an int) holds its
    extended columns on `device` (None means "cuda") and keeps the
    (nConstants, N) base-domain columns as ``base``.  On CUDA, T1 is built
    for the im-pol, Q and FRI programs first."""
    device = resolve_device(device)
    if device.type == "cuda":
        torch_tac.build_programs(stark_info, expressions_info)
    ss = stark_info["starkStruct"]
    n_constants = len(stark_info["constPolsMap"])
    const_pols = np.asarray(const_pols, dtype=np.uint64).reshape(1 << ss["nBits"], n_constants)
    mh = build_mh(ss)
    tree = const_tree(const_pols, ss["nBits"], ss["nBitsExt"], mh, device)
    return {
        "starkInfo": stark_info,
        "expressionsInfo": expressions_info,
        "verifierInfo": verifier_info,
        "fixedPols": const_pols,
        "constTree": tree,
        "constRoot": mh.root(tree),
    }


def const_tree(const_pols: np.ndarray, n_bits: int, n_bits_ext: int, mh, device):
    """The const tree of (N, nConstants) u64 fixed columns: uploaded to
    `device` (a torch.device) as (nConstants, N), extended there
    (ops/ntt.lde_planar) and Merkelized by `mh` (hash/mh.py); the tree
    keeps the base-domain columns as ``base``."""
    const_n = gl.from_u64(np.ascontiguousarray(np.asarray(const_pols, dtype=np.uint64).T),
                          device)
    if const_n.shape[0] > 0:
        const_ext = ntt_ops.lde_planar(const_n, n_bits, n_bits_ext)
    else:
        const_ext = const_n.new_zeros((0, 1 << n_bits_ext))
    tree = mh.merkelize(const_ext, const_n.shape[0], 1 << n_bits_ext)
    tree.base = const_n
    return tree


def stark_setup(const_pols, pil: dict, stark_struct: dict, options=None, device=None) -> dict:
    """pil2_stark_tpu/stark/setup.py:16: compile `pil` (the pilcom-style
    dict of compiler.pil1_parser.compile_pil_source) under `stark_struct`,
    then build the const tree of const_pols ((N, nConstants) u64) on
    `device` (None means "cuda") through ``load_setup``.
    options["skipConstTree"]: compile only.  Returns {starkInfo,
    expressionsInfo, verifierInfo, fixedPols[, constTree, constRoot]}."""
    options = options or {}
    info = compile_pil_info(pil, stark=True, stark_struct=stark_struct, options=options)
    if options.get("skipConstTree"):
        return {"fixedPols": const_pols, "starkInfo": info["pilInfo"],
                "expressionsInfo": info["expressionsInfo"],
                "verifierInfo": info["verifierInfo"]}
    return load_setup(info["pilInfo"], info["expressionsInfo"], info["verifierInfo"],
                      const_pols, device=device)
