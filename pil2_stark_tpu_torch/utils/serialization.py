"""Artifact serialization: proof, starkinfo and verkey JSON files and the
binary consts-pols container.

Copy of pil2_stark_tpu/utils/serialization.py: the same bytes for the same
inputs.  JSON follows the reference's artifacts (field elements as decimal
strings, as json-bigint writes them; extension values as 3-element
arrays).  The consts container (magic ``PSTC``) mirrors the sections of
pil2-stark-js src/stark/stark_constsPolsFile.js, fixed evaluations on the
base domain then on the extended one, as a little-endian u64 layout behind
a JSON header.  ``read_const_file`` also reads a headerless pilcom
``.const`` file when it is given the column count.
"""
from __future__ import annotations

import json

import numpy as np


def _encode(obj):
    if isinstance(obj, np.ndarray):
        return [_encode(x) for x in obj.tolist()]
    if isinstance(obj, (np.integer,)):
        return str(int(obj))
    if isinstance(obj, int):
        return str(obj)
    if isinstance(obj, (list, tuple)):
        return [_encode(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _encode(v) for k, v in obj.items()}
    return obj


def _decode(obj):
    if isinstance(obj, str) and obj.isdigit():
        return int(obj)
    if isinstance(obj, list):
        return [_decode(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _decode(v) for k, v in obj.items()}
    return obj


def dump_proof(res: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(_encode(res), f)


def load_proof(path: str) -> dict:
    with open(path) as f:
        return _decode(json.load(f))


def dump_json(obj: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def dump_verkey(const_root, path: str) -> None:
    """A GL root's four elements.  An int BN128 root is refused here, as in
    the JAX package (its BN128 setups go through the library, not files)."""
    with open(path, "w") as f:
        json.dump({"constRoot": [str(int(x)) for x in const_root]}, f)


def load_verkey(path: str):
    with open(path) as f:
        return [int(x) for x in json.load(f)["constRoot"]]


# -- consts binary container -------------------------------------------------

MAGIC = b"PSTC"  # pil2_stark_tpu consts
VERSION = 1


def _write_u64(f, arr: np.ndarray) -> None:
    """Little-endian u64 words, with no copy of a contiguous u64 array."""
    np.ascontiguousarray(arr, dtype="<u8").tofile(f)


def write_const_file(path: str, const_n: np.ndarray, const_ext: np.ndarray | None = None) -> None:
    header = {
        "version": VERSION,
        "nBits": int(const_n.shape[0]).bit_length() - 1,
        "nConstants": int(const_n.shape[1]),
        "hasExt": const_ext is not None,
    }
    if const_ext is not None:
        header["nBitsExt"] = int(const_ext.shape[0]).bit_length() - 1
    hjson = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(len(hjson).to_bytes(4, "little"))
        f.write(hjson)
        _write_u64(f, const_n)
        if const_ext is not None:
            _write_u64(f, const_ext)


def _read_pols(f, rows: int, cols: int, path: str, what: str) -> np.ndarray:
    arr = np.fromfile(f, dtype="<u8", count=rows * cols)
    if arr.size != rows * cols:
        raise ValueError(
            f"truncated consts file {path!r}: {what} has {arr.size} of "
            f"{rows * cols} expected u64 values"
        )
    return arr.reshape(rows, cols)


def read_const_file(path: str, n_pols: int | None = None):
    """Reads this framework's consts container.  For a headerless pilcom
    ``.const`` file (the reference's constPols.loadFromFile input,
    main_buildconsttree.js:60) pass n_pols; the rows are inferred and must
    be a power of two."""
    with open(path, "rb") as f:
        if f.read(4) != MAGIC:
            if n_pols is not None:
                from . import binfile

                pols = binfile.read_pilcom_const(path, n_pols)
                rows = pols.shape[0]
                if rows & (rows - 1):
                    raise ValueError(
                        f"pilcom const file {path!r}: {rows} rows is not a "
                        f"power of two for nPols={n_pols}")
                header = {
                    "version": VERSION,
                    "nBits": rows.bit_length() - 1,
                    "nConstants": n_pols,
                    "hasExt": False,
                    "pilcom": True,
                }
                return header, pols, None
            raise ValueError(f"not a consts file (bad magic): {path!r}")
        hlen = int.from_bytes(f.read(4), "little")
        raw = f.read(hlen)
        if len(raw) != hlen:
            raise ValueError(f"truncated consts file header: {path!r}")
        try:
            header = json.loads(raw)
            n = 1 << header["nBits"]
            nc = header["nConstants"]
        except (ValueError, KeyError, TypeError) as e:
            raise ValueError(f"malformed consts file header: {path!r}") from e
        const_n = _read_pols(f, n, nc, path, "base domain")
        const_ext = None
        if header["hasExt"]:
            ext_n = 1 << header["nBitsExt"]
            const_ext = _read_pols(f, ext_n, nc, path, "extended domain")
    return header, const_n.astype(np.uint64), (
        const_ext.astype(np.uint64) if const_ext is not None else None
    )
