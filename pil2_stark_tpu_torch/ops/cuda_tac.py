"""Kernels T1 and T2 (csrc/tac.cu): the constraint and FRI arithmetic of
the prove.

  * ``tac_eval`` (T1) evaluates one segment of a compiled TAC program
    (ops/torch_tac.py) for every row of its domain.  It is the counterpart
    of the XLA fusion the JAX package traces in jax_tac.make_executor
    (pil2_stark_tpu/ops/jax_tac.py:53), not of a ``pallas_call``; its plain
    version is ``torch_tac.run_plain``.
  * ``gl_xdiv`` (T2) computes the xDivXSubXi table x/(x − xi_o) over the
    extended coset, the counterpart of the jitted elementwise program
    pil2_stark_tpu/stark/device.py:349 ``_jit_xdiv``; its plain version is
    ``stark/device.py::compute_xdiv_plain``.

Both launch only on CUDA tensors (building the library at first use) and
raise on anything else; each counts its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from ..field import torch_gl as gl
from ..utils import cuda_build

SLOT_CAPS = (8, 16, 32, 64)  # the slot capacities T1 is compiled for


def _lib():
    lib = cuda_build.lib("tac")
    if not getattr(lib, "_typed", False):
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.tac_eval.argtypes = [vp, ci, vp, ci, vp, ci, cll, ci, vp]
        lib.tac_eval.restype = ci
        lib.gl_xdiv.argtypes = [vp, vp, ci, vp, cll, vp]
        lib.gl_xdiv.restype = ci
        lib._typed = True
    return lib


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _check(t: torch.Tensor, what: str, device=None):
    if t.device.type != "cuda" or (device is not None and t.device != device):
        raise ValueError(f"{what}: want a CUDA tensor, got one on {t.device}")
    if t.dtype != torch.int64 or not t.is_contiguous():
        raise ValueError(f"{what}: want a contiguous int64 tensor, got {t.dtype} "
                         f"contiguous={t.is_contiguous()}")


def tac_eval(words: torch.Tensor, cols: torch.Tensor, scalars: torch.Tensor, n: int,
             n_slots: int) -> None:
    """Run the instructions `words` ((k, 5) int64, torch_tac's encoding) on
    rows 0..n-1.  `cols` holds the device address of every column the
    instructions name (written buffers included), `scalars` the scalar
    table.  Writes go to the addresses in `cols`."""
    _check(words, "tac_eval words")
    device = words.device
    _check(cols, "tac_eval cols", device)
    _check(scalars, "tac_eval scalars", device)
    if words.dim() != 2 or words.shape[1] != 5:
        raise ValueError(f"tac_eval: words of shape {tuple(words.shape)}, want (k, 5)")
    cap = next((c for c in SLOT_CAPS if c >= n_slots), None)
    if cap is None:
        raise ValueError(f"tac_eval: {n_slots} slots, the kernel holds at most {SLOT_CAPS[-1]}")
    if not 1 <= n < 1 << 32:
        raise ValueError(f"tac_eval: {n} rows")
    if words.shape[0] == 0:
        return
    rc = _lib().tac_eval(words.data_ptr(), words.shape[0], cols.data_ptr(), cols.numel(),
                         scalars.data_ptr(), scalars.numel(), n, cap, _stream(words))
    if rc != 0:
        raise RuntimeError(f"tac_eval launch failed: CUDA error {rc}")
    tac_eval.launches += 1


tac_eval.launches = 0


def gl_xdiv(x_ext: torch.Tensor, xi_list) -> torch.Tensor:
    """(nOpenings, 3, extN): x/(x − xi) for each opening point xi (a
    3-tuple of ints) at each point x of x_ext; 0 where x − xi is 0.  The
    kernel refuses more openings than it holds (kMaxOpenings)."""
    _check(x_ext, "gl_xdiv x")
    if x_ext.dim() != 1:
        raise ValueError(f"gl_xdiv: x of shape {tuple(x_ext.shape)}, want (extN,)")
    n = x_ext.shape[0]
    out = torch.empty((len(xi_list), 3, n), dtype=torch.int64, device=x_ext.device)
    if n == 0 or not xi_list:
        return out
    xis = (ctypes.c_longlong * (3 * len(xi_list)))(
        *[gl.i64(int(v)) for xi in xi_list for v in xi])
    rc = _lib().gl_xdiv(x_ext.data_ptr(), ctypes.cast(xis, ctypes.c_void_p), len(xi_list),
                        out.data_ptr(), n, _stream(x_ext))
    if rc != 0:
        raise RuntimeError(f"gl_xdiv with {len(xi_list)} openings failed: CUDA error {rc} "
                           "(csrc/tac.cu kMaxOpenings bounds the openings)")
    gl_xdiv.launches += 1
    return out


gl_xdiv.launches = 0
