"""Kernel X1: the Poseidon permutation streamed through a persistent grid
whose input the card's bulk-copy engine brings into a ring of shared
stages (csrc/poseidon_stream.cu), and the tool that times it.

Counterpart of tools/exp_stream.py (``build_stream`` :108, ``main`` :130).
The question it asks is whether overlapping the copies of the next tile
with the permutation of this one pays; on the card it asks it of B4's
schedule (chip_smoke.py's tools phase times it beside B4).  Its plain
version is B4's (hash/cuda_poseidon.py::permute_plain): the same
function, any u64 in.

``build_stream(n_blocks)`` returns a callable on planar (12, n_blocks·2048)
int64 tensors.  On a CUDA tensor it launches X1 (building it at first use)
and counts ``permute_stream.launches``; on a CPU tensor it runs the plain
version; any other device raises.

    python -m pil2_stark_tpu_torch.tools.exp_stream            # check and time
"""
from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from ..field import torch_gl as gl
from ..hash import cuda_poseidon as cp
from ..hash import poseidon_gl as ref
from ..stark.context import resolve_device
from ..utils import cuda_build
from ..utils.timing import chain_ms

P = gl.P_INT
T = cp.T
BLK = 2048  # states per tile (pallas_poseidon._BLOCK)


def _lib():
    lib = cuda_build.lib("poseidon_stream")
    if not getattr(lib, "_typed", False):
        vp = ctypes.c_void_p
        lib.poseidon_stream.argtypes = [vp, vp, ctypes.c_longlong, vp]
        lib.poseidon_stream.restype = ctypes.c_int
        lib._typed = True
    return lib


def permute_stream(state: torch.Tensor) -> torch.Tensor:
    """X1 on a CUDA tensor, B4's plain version on a CPU tensor; the batch
    must be a multiple of 2048."""
    if state.dim() != 2 or state.shape[0] != T or state.shape[1] % BLK:
        raise ValueError(f"poseidon stream: want (12, a multiple of {BLK}), "
                         f"got {tuple(state.shape)}")
    if state.device.type == "cpu":
        return cp.permute_plain(state)
    if state.device.type != "cuda":
        raise ValueError(f"poseidon stream: unsupported device {state.device}")
    if state.dtype != torch.int64:
        raise ValueError(f"poseidon stream: want int64, got {state.dtype}")
    state = state.contiguous()
    out = torch.empty_like(state)
    if state.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("poseidon stream: bulk copies need 16-byte aligned tensors")
    stream = ctypes.c_void_p(torch.cuda.current_stream(state.device).cuda_stream)
    with torch.cuda.device(state.device):
        rc = _lib().poseidon_stream(state.data_ptr(), out.data_ptr(), state.shape[1], stream)
    if rc != 0:
        raise RuntimeError(f"poseidon_stream launch failed: CUDA error {rc}")
    permute_stream.launches += 1
    return out


permute_stream.launches = 0


def build_stream(n_blocks: int):
    """A callable on (12, n_blocks·2048) int64 tensors."""
    if n_blocks < 1:
        raise ValueError(f"build_stream: n_blocks={n_blocks}")
    batch = n_blocks * BLK

    def fn(state: torch.Tensor) -> torch.Tensor:
        if tuple(state.shape) != (T, batch):
            raise ValueError(f"stream: want (12, {batch}), got {tuple(state.shape)}")
        return permute_stream(state)

    return fn


def main(device=None, check_bits: int = 14, bench_bits=(16, 17, 20)) -> dict:
    """A check at 2^check_bits states (the first 64 against the numpy
    oracle), then the rate at each of bench_bits: chains of 5 calls, the
    best of 3."""
    dev = resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    rng = np.random.default_rng(0)
    n = 1 << check_bits
    states = rng.integers(0, P, size=(n, T), dtype=np.uint64)
    out = build_stream(n // BLK)(gl.from_u64(states.T.copy(), dev))
    ok = bool(np.array_equal(gl.to_u64(out[:, :64]).T, ref.permute(states[:64])))
    print("ok:", ok, flush=True)
    res = {"ok": ok, "device": name, "ms": {}}
    for bits in bench_bits:
        n = 1 << bits
        x = gl.from_u64(rng.integers(0, P, size=(T, n), dtype=np.uint64), dev)
        ms = chain_ms(build_stream(n // BLK), x, 5, 3)
        res["ms"][bits] = ms
        print(f"stream 2^{bits}: {n / ms / 1e3:.1f}M perms/s ({ms:.3f} ms, {name})", flush=True)
    return res


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
