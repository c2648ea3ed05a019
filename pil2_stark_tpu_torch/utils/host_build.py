"""Builds the port's host C++ sources (``csrc/host/*.cpp``) into shared
libraries, the host-side sibling of utils/cuda_build.py.

Each source is compiled on its own by the host's C++ compiler (``$CXX``,
else ``g++``, else ``c++``) into ``_build/host/<name>-<digest>.so`` at its
first use, then loaded with ctypes.  The digest covers the source, every
header under ``csrc/host/`` and the flags, so an edited source rebuilds and
an unchanged one is reused.  The flags leave out ``-march=native``: a
library built on one host may be loaded on another that shares the
checkout.  A missing compiler or a failed build raises with the
compiler's output; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from .cuda_build import BUILD_DIR, CSRC

HOST_SRC = CSRC / "host"
HOST_BUILD = BUILD_DIR / "host"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def cxx() -> str:
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    raise RuntimeError("no host C++ compiler ($CXX, g++ or c++): "
                       "the port's host runtime cannot be built")


def library_path(name: str) -> Path:
    src = HOST_SRC / f"{name}.cpp"
    h = hashlib.sha256(src.read_bytes())
    for path in sorted(HOST_SRC.glob("*.h")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return HOST_BUILD / f"{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile csrc/host/<name>.cpp unless its library exists."""
    out = library_path(name)
    if out.exists():
        return out
    HOST_BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx(), *CXX_FLAGS, "-I", str(HOST_SRC), "-o", str(tmp),
           str(HOST_SRC / f"{name}.cpp")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"host build of {name} failed ({' '.join(cmd)}):\n"
                           f"{(res.stdout + res.stderr)[-4000:]}")
    os.replace(tmp, out)
    return out


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/host/<name>.cpp, built first if missing."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(build(name)))
        return _libs[name]
