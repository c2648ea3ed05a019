"""Kernels T1 and T2: the constraint and FRI arithmetic of the prove.

  * ``tac_program`` (T1) runs the kernels ops/tac_codegen.py generates for
    one compiled TAC program (ops/torch_tac.py), one per segment, over every
    row of its domain.  T1 is the counterpart of the XLA computation the
    JAX package traces and jits per program in jax_tac.make_executor
    (pil2_stark_tpu/ops/jax_tac.py:53), not of a ``pallas_call``; its plain
    version is ``torch_tac.run_plain``.
  * ``gl_xdiv`` (T2, csrc/tac.cu) computes the xDivXSubXi table
    x/(x − xi_o) over the extended coset, the counterpart of the jitted
    elementwise program pil2_stark_tpu/stark/device.py:349 ``_jit_xdiv``,
    as 1 + (xi·x² + B1·x + c0)/N(x) with per-opening coefficients from
    ``xdiv_coefficients``; its plain version is
    ``stark/device.py::compute_xdiv_plain``.

Both launch only on CUDA tensors (building their library at first use)
and raise on anything else; each counts its kernel launches in
``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from ..field import f3
from ..field import torch_gl as gl
from ..utils import cuda_build

_program_libs: dict = {}  # generated source -> its loaded, checked library


def _lib():
    lib = cuda_build.lib("tac")
    if not getattr(lib, "_typed", False):
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.gl_xdiv.argtypes = [vp, vp, ci, vp, cll, vp]
        lib.gl_xdiv.restype = ci
        lib._typed = True
    return lib


def _stream(t: torch.Tensor):
    """The current stream of t's card; the caller launches under
    torch.cuda.device(t.device), so that the kernel runs on that card."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _check(t: torch.Tensor, what: str, device=None):
    if t.device.type != "cuda" or (device is not None and t.device != device):
        raise ValueError(f"{what}: want a CUDA tensor, got one on {t.device}")
    if t.dtype != torch.int64 or not t.is_contiguous():
        raise ValueError(f"{what}: want a contiguous int64 tensor, got {t.dtype} "
                         f"contiguous={t.is_contiguous()}")


def program_library(gen) -> ctypes.CDLL:
    """The built library of a generated program (tac_codegen.Generated),
    checked against the layout the generator stated."""
    lib = _program_libs.get(gen.source)
    if lib is None:
        lib = cuda_build.lib(cuda_build.add_generated(gen.source))
        vp, cll = ctypes.c_void_p, ctypes.c_longlong
        lib.tac_run.argtypes = [vp, vp, vp, cll, cll, cll, vp]
        lib.tac_run.restype = ctypes.c_int
        lib.tac_layout.argtypes = [vp]
        lib.tac_layout.restype = ctypes.c_int
        layout = (ctypes.c_longlong * 5)()
        lib.tac_layout(ctypes.cast(layout, vp))
        want = (gen.n_cols, len(gen.shifts), gen.n_base_scalars, gen.n_scalars, gen.n_segments)
        if tuple(layout) != want:
            raise RuntimeError(f"T1 library {gen.digest}: layout {tuple(layout)}, want {want}")
        _program_libs[gen.source] = lib
    return lib


def tac_program(gen, cols, scalars: torch.Tensor, n: int, base: int = 0, rows=None,
                shifts=None) -> None:
    """Run the generated program `gen` (tac_codegen.Generated) on rows
    [base, base + rows) of columns of n rows (default all n): `cols` holds
    the device address of every column it names (written buffers included),
    `scalars` the scalar table (its first ``gen.n_base_scalars`` entries;
    the launch fills the rest in place), `shifts` the row shifts (default
    ``gen.shifts``, taken mod n; a shard's launch passes them signed, and
    then no row it computes may read outside [0, n)).  Writes go to the
    addresses in `cols`.  One kernel launch per segment, after one
    single-thread launch for the table when it derives values."""
    _check(scalars, "tac_program scalars")
    if len(cols) != gen.n_cols:
        raise ValueError(f"tac_program: {len(cols)} column addresses, the program names "
                         f"{gen.n_cols}")
    if scalars.numel() != gen.n_scalars:
        raise ValueError(f"tac_program: a table of {scalars.numel()} scalars, the program "
                         f"takes {gen.n_scalars}")
    rows = n - base if rows is None else rows
    shifts = gen.shifts if shifts is None else tuple(shifts)
    if not 1 <= n < 1 << 40 or base < 0 or rows < 1 or base + rows > n:
        raise ValueError(f"tac_program: rows [{base}, {base + rows}) of {n}")
    if len(shifts) != len(gen.shifts):
        raise ValueError(f"tac_program: {len(shifts)} shifts, the program takes "
                         f"{len(gen.shifts)}")
    if (base, rows) != (0, n) and shifts and (base + min(shifts) < 0
                                              or base + rows - 1 + max(shifts) >= n):
        raise ValueError(f"tac_program: shifts {shifts} read outside the {n} rows from "
                         f"rows [{base}, {base + rows})")
    lib = program_library(gen)
    c_cols = (ctypes.c_longlong * max(len(cols), 1))(*cols)
    c_shifts = (ctypes.c_longlong * max(len(shifts), 1))(*shifts)
    with torch.cuda.device(scalars.device):
        rc = lib.tac_run(ctypes.cast(c_cols, ctypes.c_void_p),
                         ctypes.cast(c_shifts, ctypes.c_void_p), scalars.data_ptr(), n,
                         base, rows, _stream(scalars))
    if rc != 0:
        raise RuntimeError(f"tac_program {gen.digest} launch failed: CUDA error {rc}")
    tac_program.launches += gen.n_segments


tac_program.launches = 0


def xdiv_coefficients(xi) -> tuple:
    """(xi, B1, c2, c1, c0) of one opening point xi (a 3-tuple of ints)
    over F_p[t]/(t³ − t − 1): N(x) = Norm(x − xi) = x³ − c2·x² + c1·x − c0
    for a base point x, from the matrix of multiplication by xi (its trace,
    the sum of its principal 2 × 2 minors, its determinant), and
    B1 = xi·(xi − c2), so that x/(x − xi) = 1 + (xi·x² + B1·x + c0)/N(x)
    wherever N(x) is not 0."""
    a0, a1, a2 = (int(v) % f3.P for v in xi)
    m = [[a0, a2, a1], [a1, a0 + a2, a1 + a2], [a2, a1, a0 + a2]]
    c2 = (m[0][0] + m[1][1] + m[2][2]) % f3.P
    c1 = sum(m[i][i] * m[j][j] - m[i][j] * m[j][i]
             for i, j in ((0, 1), (0, 2), (1, 2))) % f3.P
    c0 = (m[0][0] * (m[1][1] * m[2][2] - m[1][2] * m[2][1])
          - m[0][1] * (m[1][0] * m[2][2] - m[1][2] * m[2][0])
          + m[0][2] * (m[1][0] * m[2][1] - m[1][1] * m[2][0])) % f3.P
    xi3 = (a0, a1, a2)
    return xi3, f3.mul(xi3, f3.sub(xi3, c2)), c2, c1, c0


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
    words = []
    for xi in xi_list:
        xi3, b1, c2, c1, c0 = xdiv_coefficients(xi)
        words += [*xi3, *b1, c2, c1, c0]
    coefs = (ctypes.c_longlong * len(words))(*[gl.i64(v) for v in words])
    with torch.cuda.device(x_ext.device):
        rc = _lib().gl_xdiv(x_ext.data_ptr(), ctypes.cast(coefs, ctypes.c_void_p),
                            len(xi_list), out.data_ptr(), n, _stream(x_ext))
    if rc != 0:
        raise RuntimeError(f"gl_xdiv with {len(xi_list)} openings failed: CUDA error {rc} "
                           "(csrc/tac.cu kMaxOpenings bounds the openings)")
    gl_xdiv.launches += 1
    return out


gl_xdiv.launches = 0
