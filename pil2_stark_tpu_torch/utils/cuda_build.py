"""Builds the port's CUDA sources into shared libraries.

Each source has a plain C interface and is compiled on its own by ``nvcc``
into ``_build/<name>-<digest>.so``, then loaded with ctypes.  A source
whose template instantiations take one ``nvcc`` too long is split: it is
compiled several times, each time with other ``-D`` defines that select
a share of its instantiations, into libraries named ``<source>.<part>``.
The digest covers the source, its defines and every header under
``csrc/``, so an edited source rebuilds and an unchanged one is reused.

Generated sources (kernel T1, one per compiled TAC program, written by
ops/tac_codegen.py) go to ``_build/gen/<digest>.cu`` and build into
``_build/gen/<digest>.so``; their digest covers the text, every header
under ``csrc/`` and the flags, so programs with the same text share a
library, across processes too.

A library is built at its first use; ``build()`` starts every missing one
at once (one nvcc process per library, run in parallel).  A failed build
raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
GEN_DIR = BUILD_DIR / "gen"
# poseidon_variants.cu holds 20 instantiations of the X2 kernel: one nvcc
# over all of them takes about 150 s, over the 5 of one sq/dual choice up
# to 73 s (the dual ones), so each part holds 2 or 3.
SPLITS = {
    "poseidon_variants": {
        f"sq{sq}_ns{ns}_{group}": [f"-DX2_SQ={sq}", f"-DX2_NS={ns}", f"-DX2_PROBES={probes}"]
        for sq in (0, 1) for ns in (1, 2) for probes, group in ((0, "perm"), (1, "probes"))},
}
SOURCES = ("ntt", "poseidon", "poseidon_stream", "tac") + tuple(
    f"{src}.{part}" for src, parts in SPLITS.items() for part in parts)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def _source(name: str) -> tuple[Path, list[str]]:
    """The .cu file and the extra defines of library `name`."""
    src, _, part = name.partition(".")
    return CSRC / f"{src}.cu", SPLITS[src][part] if part else []


_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}  # wall seconds of each compile this process ran


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _headers_digest(h) -> None:
    for path in sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())


def _digest(name: str) -> str:
    src, defines = _source(name)
    h = hashlib.sha256()
    h.update(src.name.encode())
    h.update(src.read_bytes())
    _headers_digest(h)
    h.update(" ".join(NVCC_FLAGS + defines).encode())
    return h.hexdigest()[:16]


def generated_digest(text: str) -> str:
    """The digest of a generated source: its text, every csrc header and
    the flags."""
    h = hashlib.sha256(text.encode())
    _headers_digest(h)
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    """The library of csrc/<name>.cu (or a part of a split source), or of
    a generated source when `name` is ``gen/<digest>``."""
    if name.startswith("gen/"):
        return GEN_DIR / f"{name[4:]}.so"
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def _log_path(name: str) -> Path:
    if name.startswith("gen/"):
        return GEN_DIR / f"{name[4:]}.log"
    return BUILD_DIR / f"{name}.log"


def add_generated(text: str) -> str:
    """Write a generated source to _build/gen (once) and return its
    library name, ``gen/<digest>``."""
    digest = generated_digest(text)
    path = GEN_DIR / f"{digest}.cu"
    if not path.exists():
        GEN_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_text(text)
        os.replace(tmp, path)
    return f"gen/{digest}"


def build(names=SOURCES) -> dict[str, float]:
    """Compile every missing library in `names` (generated ones named by
    add_generated) in parallel; returns the wall seconds of each compile
    (0.0 for one already built)."""
    times = {name: 0.0 for name in names if library_path(name).exists()}
    missing = [name for name in dict.fromkeys(names) if name not in times]
    if missing:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        compiler = nvcc()
    procs = {}
    for name in missing:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(_log_path(name), "w")
        if name.startswith("gen/"):
            src, defines = GEN_DIR / f"{name[4:]}.cu", []
        else:
            src, defines = _source(name)
        cmd = [compiler, *NVCC_FLAGS, *defines, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                       time.perf_counter(), tmp, out, log)
    failed = []
    while procs:
        for name, (proc, t0, tmp, out, log) in list(procs.items()):
            rc = proc.poll()
            if rc is None:
                continue
            del procs[name]
            log.close()
            times[name] = build_seconds[name] = time.perf_counter() - t0
            if rc != 0:
                failed.append(name)
            else:
                os.replace(tmp, out)
        if procs:
            time.sleep(0.05)
    if failed:
        logs = "\n".join(_log_path(n).read_text()[-4000:] for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return times


def lib(name: str) -> ctypes.CDLL:
    """The loaded library `name` (csrc/<name>.cu, a part of a split
    source, or ``gen/<digest>``), built first if missing."""
    with _lock:
        if name not in _libs:
            build([name])
            _libs[name] = ctypes.CDLL(str(library_path(name)))
        return _libs[name]


def build_log(name: str) -> str:
    """nvcc's output (with ptxas register/spill counts) of the last build."""
    path = _log_path(name)
    return path.read_text() if path.exists() else ""
