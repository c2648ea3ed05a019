"""Kernel B4: the width-12 Poseidon-GL permutation (csrc/poseidon.cu),
beside its plain PyTorch version.

Replaces pallas_poseidon._permute_combined (pallas_poseidon.py:433) and its
entry points permute_planes_pair / permute_pair / permute_pallas_u64.  Input
and output are planar (12, B) int64 tensors, one state per column; the
batch is not padded (the TPU's bucket padding kept its compile count down).

``permute`` computes the plain version for a CPU tensor and launches the
kernel for a CUDA tensor (building it at first use) or raises; it counts
its launches in ``permute.launches``.  The kernel's round constants and
matrices are compiled in from csrc/poseidon_constants.cuh, which
``constants_header()`` regenerates from poseidon_gl_constants.npz.
"""
from __future__ import annotations

import ctypes

import torch

from ..field import torch_gl as gl
from ..utils import cuda_build
from . import poseidon_gl as ref

T = 12
HALF_F = ref.N_ROUNDS_F // 2
RP = ref.N_ROUNDS_P

_CONSTS: dict = {}


def _consts(device):
    key = str(device)
    k = _CONSTS.get(key)
    if k is None:
        if int(ref.M.max()) >= 1 << 20:
            raise ValueError("MDS entries must be small for the split product")
        k = {
            "C": gl.from_u64(ref.C, device),
            "S": gl.from_u64(ref.S, device),
            "MT": torch.as_tensor(ref.M.astype("int64").T.copy(), device=device),
            "P": gl.from_u64(ref.P, device),
        }
        _CONSTS[key] = k
    return k


def _mds_small(s, mt):
    """out_i = Σ_j s_j·M[j][i] with small M: the 32-bit halves of s_j
    accumulate separately (sums < 2^42), one reduction per output."""
    lo = torch.zeros_like(s)
    hi = torch.zeros_like(s)
    for j in range(T):
        lo += mt[:, j, None] * (s[j] & gl.MASK32)[None]
        hi += mt[:, j, None] * ((s[j] >> 32) & gl.MASK32)[None]
    return gl.combine_sums(lo, hi)


def _mat_full(s, mat):
    """out_i = Σ_j s_j·mat[j][i] for a dense GL matrix."""
    acc = gl.mul(s[0][None, :], mat[0][:, None])
    for j in range(1, T):
        acc = gl.add(acc, gl.mul(s[j][None, :], mat[j][:, None]))
    return acc


def permute_plain(state: torch.Tensor) -> torch.Tensor:
    """(12, B) -> (12, B), the schedule of poseidon_gl.permute."""
    k = _consts(state.device)
    c = k["C"]
    s = gl.add(gl.canon(state), c[:T, None])
    for r in range(HALF_F - 1):
        s = gl.add(gl.pow7(s), c[(r + 1) * T:(r + 2) * T, None])
        s = _mds_small(s, k["MT"])
    s = gl.add(gl.pow7(s), c[HALF_F * T:(HALF_F + 1) * T, None])
    s = _mat_full(s, k["P"])
    for r in range(RP):
        srow = k["S"][(2 * T - 1) * r:(2 * T - 1) * (r + 1)]
        s0 = gl.add(gl.pow7(s[0]), c[(HALF_F + 1) * T + r])
        rows = torch.cat([s0[None], s[1:]])
        new0 = gl.gl_sum(gl.mul(rows, srow[:T, None]), 0)
        rest = gl.add(s[1:], gl.mul(s0[None], srow[T:, None]))
        s = torch.cat([new0[None], rest])
    base = (HALF_F + 1) * T + RP
    for r in range(HALF_F - 1):
        s = gl.add(gl.pow7(s), c[base + r * T:base + (r + 1) * T, None])
        s = _mds_small(s, k["MT"])
    return _mds_small(gl.pow7(s), k["MT"])


def _lib():
    lib = cuda_build.lib("poseidon")
    if not getattr(lib, "_typed", False):
        vp = ctypes.c_void_p
        lib.poseidon_permute.argtypes = [vp, vp, ctypes.c_longlong, vp]
        lib.poseidon_permute.restype = ctypes.c_int
        lib._typed = True
    return lib


def permute(state: torch.Tensor) -> torch.Tensor:
    if state.device.type == "cpu":
        return permute_plain(state)
    if state.device.type != "cuda":
        raise ValueError(f"poseidon permute: unsupported device {state.device}")
    if state.dtype != torch.int64 or state.dim() != 2 or state.shape[0] != T:
        raise ValueError(f"poseidon permute: want (12, B) int64, got {state.dtype} {tuple(state.shape)}")
    state = state.contiguous()
    out = torch.empty_like(state)
    stream = ctypes.c_void_p(torch.cuda.current_stream(state.device).cuda_stream)
    rc = _lib().poseidon_permute(state.data_ptr(), out.data_ptr(), state.shape[1], stream)
    if rc != 0:
        raise RuntimeError(f"poseidon_permute launch failed: CUDA error {rc}")
    permute.launches += 1
    return out


permute.launches = 0


def constants_header() -> str:
    """Text of csrc/poseidon_constants.cuh for the current constant tables."""
    def arr(name, values):
        vals = [f"0x{int(v):016x}ull" for v in values]
        lines = [", ".join(vals[i:i + 4]) for i in range(0, len(vals), 4)]
        body = ",\n    ".join(lines)
        return f"__constant__ uint64_t {name}[{len(vals)}] = {{\n    {body}}};\n"

    return (
        "// Poseidon-GL round constants and matrices (hash/poseidon_gl_constants.npz).\n"
        "// Generated by hash/cuda_poseidon.py:constants_header(); do not edit.\n"
        "#pragma once\n#include <cstdint>\n\n"
        + arr("POSEIDON_C", ref.C)
        + arr("POSEIDON_S", ref.S)
        + arr("POSEIDON_M", ref.M.reshape(-1))
        + arr("POSEIDON_P", ref.P.reshape(-1))
    )
