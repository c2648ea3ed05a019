"""ctypes bindings of the port's host C++ runtime (csrc/host/runtime.cpp).

Counterpart of pil2_stark_tpu/runtime/native.py: Goldilocks vector ops, a
batched Poseidon permutation, the linear hash and Merkle levels, over
numpy uint64 arrays.  utils/host_build.py builds the library at first use
into ``_build/host/``.  Unlike the JAX package, which falls back to numpy
when the build fails, a failed build raises here: the plain versions
(field/gl64.py, hash/poseidon_gl.py, hash/linearhash.py) are what the
tests hold these functions against, not a silent second path.
``plain_hashing()`` runs the host trees, path checks and transcripts on
them for as long as it lasts.
"""
from __future__ import annotations

import contextlib
import ctypes
import types

import numpy as np

from ..utils import host_build

_u64p = ctypes.POINTER(ctypes.c_uint64)
_lib = None


def lib() -> ctypes.CDLL:
    """The loaded runtime, built at the first call."""
    global _lib
    if _lib is None:
        l = host_build.lib("runtime")
        for fn in ("gl64_add_vec", "gl64_sub_vec", "gl64_mul_vec"):
            getattr(l, fn).argtypes = [_u64p, _u64p, _u64p, ctypes.c_size_t]
        l.poseidon_permute_batch.argtypes = [_u64p, ctypes.c_size_t]
        l.linear_hash.argtypes = [_u64p, ctypes.c_size_t, ctypes.c_size_t, _u64p]
        l.merkle_level.argtypes = [_u64p, ctypes.c_size_t, _u64p]
        _lib = l
    return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_u64p)


def _vec(fn: str, a, b) -> np.ndarray:
    a = np.ascontiguousarray(a, dtype=np.uint64)
    b = np.ascontiguousarray(b, dtype=np.uint64)
    if a.shape != b.shape:
        raise ValueError(f"shapes differ: {a.shape} and {b.shape}")
    out = np.empty_like(a)
    getattr(lib(), fn)(_ptr(a), _ptr(b), _ptr(out), a.size)
    return out


def gl64_add(a, b) -> np.ndarray:
    return _vec("gl64_add_vec", a, b)


def gl64_sub(a, b) -> np.ndarray:
    return _vec("gl64_sub_vec", a, b)


def gl64_mul(a, b) -> np.ndarray:
    return _vec("gl64_mul_vec", a, b)


def poseidon_permute(states) -> np.ndarray:
    """The permutation of each of (n, 12) states (a copy)."""
    out = np.array(states, dtype=np.uint64, order="C", copy=True)
    if out.ndim != 2 or out.shape[1] != 12:
        raise ValueError(f"states must be (n, 12), got {out.shape}")
    lib().poseidon_permute_batch(_ptr(out), out.shape[0])
    return out


def permute_int(state) -> list:
    """The permutation of one state of 12 python ints."""
    return [int(v) for v in poseidon_permute(np.array([state], dtype=np.uint64))[0]]


def linear_hash(rows) -> np.ndarray:
    """(height, width) rows -> (height, 4) digests (linearhash.linear_hash)."""
    rows = np.ascontiguousarray(rows, dtype=np.uint64)
    h, w = rows.shape
    out = np.empty((h, 4), dtype=np.uint64)
    lib().linear_hash(_ptr(rows), h, w, _ptr(out))
    return out


def merkle_level(level) -> np.ndarray:
    """(2m, 4) digests -> (m, 4): each pair hashed with a zero capacity."""
    level = np.ascontiguousarray(level, dtype=np.uint64)
    if level.ndim != 2 or level.shape[1] != 4 or level.shape[0] % 2:
        raise ValueError(f"a level is (2m, 4), got {level.shape}")
    m = level.shape[0] // 2
    out = np.empty((m, 4), dtype=np.uint64)
    lib().merkle_level(_ptr(level), m, _ptr(out))
    return out


@contextlib.contextmanager
def plain_hashing():
    """hash/merkle.py and hash/transcript.py on the python-int permutation
    (hash/poseidon_gl.permute_int, what they ran on before this runtime)
    in place of the runtime while the context lasts: the version the
    runtime is held against, and timed beside."""
    from ..hash import merkle, poseidon_gl, transcript

    def linear_hash(rows):
        return np.array([merkle._sponge_int([int(v) for v in row], poseidon_gl.permute_int)
                         for row in rows], dtype=np.uint64).reshape(-1, 4)

    def merkle_level(level):
        pairs = np.asarray(level).reshape(-1, 8)
        return np.array([poseidon_gl.permute_int([int(v) for v in pair] + [0] * 4)[:4]
                         for pair in pairs], dtype=np.uint64).reshape(-1, 4)

    plain = types.SimpleNamespace(permute_int=poseidon_gl.permute_int,
                                  linear_hash=linear_hash, merkle_level=merkle_level)
    saved = merkle.native, transcript.native
    merkle.native = transcript.native = plain
    try:
        yield
    finally:
        merkle.native, transcript.native = saved
