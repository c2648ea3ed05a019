"""Reference-compatible binary artifact formats (the interop layer).

Copy of pil2_stark_tpu/utils/binfile.py without its "exec" file, which
belongs to the final recursion tier and is not ported yet.  pil2-stark-js
writes its setup artifacts through @iden3/binfileutils containers and
pilcom raw buffers; this module writes those byte layouts:

- the iden3 binfile container: 4-byte magic, ULE32 version, ULE32
  nSections, then per written section [ULE32 id, ULE64 byteLength,
  payload] (src/stark/chelpers/binFile.js, createBinFile and
  startWriteSection);
- pilcom ``.const`` fixed-column files: headerless row-major interleaved
  u64 LE, value(row i, pol p) at word i*nPols + p (the polsarray layout
  constPols.loadFromFile reads, src/main_buildconsttree.js:60);
- the node count of a merklehash consttree file (``get_n_nodes``,
  merklehash_p.js:28-42), whose bytes hash/merkle.write_tree writes;
- the "cnts" consts file: sections 2-5 = fixed evals (extended), const
  tree, x_n, x_ext (src/stark/stark_constsPolsFile.js:18-96,
  stark_constsPols_constants.js).
"""
from __future__ import annotations

import struct

import numpy as np


# ---------------------------------------------------------------------------
# iden3 binfile container


def write_bin_file(path: str, magic: bytes, version: int,
                   sections: list, n_sections: int | None = None) -> None:
    """sections: [(section_id, payload_bytes)].  n_sections is the count
    DECLARED in the header — the reference sometimes declares more than it
    writes (e.g. exec files declare 5, write ids 2..5)."""
    if len(magic) != 4:
        raise ValueError("binfile magic must be 4 bytes")
    with open(path, "wb") as f:
        f.write(magic)
        f.write(struct.pack("<II", version,
                            n_sections if n_sections is not None else len(sections)))
        for sid, payload in sections:
            f.write(struct.pack("<IQ", sid, len(payload)))
            f.write(payload)


def read_bin_file(path: str, magic: bytes | None = None):
    """-> (magic, version, {section_id: payload_bytes})."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 12:
        raise ValueError(f"{path}: too short for a binfile container")
    got = data[:4]
    if magic is not None and got != magic:
        raise ValueError(f"{path}: bad magic {got!r}, expected {magic!r}")
    version, n_sections = struct.unpack_from("<II", data, 4)
    pos = 12
    sections = {}
    while pos < len(data):
        if pos + 12 > len(data):
            raise ValueError(f"{path}: truncated section header at {pos}")
        sid, size = struct.unpack_from("<IQ", data, pos)
        pos += 12
        if pos + size > len(data):
            raise ValueError(f"{path}: section {sid} overruns file "
                             f"({size} bytes at {pos}, file {len(data)})")
        if sid in sections:
            raise ValueError(f"{path}: duplicate section id {sid}")
        sections[sid] = data[pos:pos + size]
        pos += size
    return got, version, sections


def is_bin_file(path: str, magic: bytes) -> bool:
    with open(path, "rb") as f:
        return f.read(4) == magic


# ---------------------------------------------------------------------------
# pilcom .const raw fixed-column files


def write_pilcom_const(path: str, pols: np.ndarray) -> None:
    """pols (nRows, nPols) u64 -> headerless interleaved LE dump."""
    np.ascontiguousarray(np.asarray(pols, dtype=np.uint64)).astype(
        "<u8").tofile(path)


def read_pilcom_const(path: str, n_pols: int) -> np.ndarray:
    arr = np.fromfile(path, dtype="<u8")
    if n_pols <= 0 or arr.size % n_pols:
        raise ValueError(
            f"{path}: {arr.size} u64 words is not a multiple of nPols={n_pols}")
    return arr.reshape(-1, n_pols).astype(np.uint64)


# ---------------------------------------------------------------------------
# merklehash consttree node-count formula (layout check for write_tree)


def get_n_nodes(height: int) -> int:
    """u64 node-buffer length for a GL merkle tree with `height` leaves —
    merklehash_p.js:28-42 _getNNodes(height*4), used to cross-check that
    hash/merkle.MerkleTree.nodes_flat() matches the reference layout."""
    n = height * 4
    next_n = ((n - 1) // 8 + 1) * 4
    acc = next_n * 2
    while n > 4:
        n = next_n
        next_n = ((n - 1) // 8 + 1) * 4
        acc += next_n * 2 if n > 4 else 4
    return acc


# ---------------------------------------------------------------------------
# "cnts" consts file (stark_constsPolsFile.js)

CNTS_MAGIC = b"cnts"
_CNTS_EVALS, _CNTS_TREE, _CNTS_XN, _CNTS_XEXT = 2, 3, 4, 5


def _u64_block(arr: np.ndarray) -> bytes:
    """ULE32 length-in-words prefix + LE u64 payload (the writeULE32 +
    writeBigBuffer pattern of stark_constsPolsFile.js)."""
    flat = np.ascontiguousarray(np.asarray(arr, dtype=np.uint64)).reshape(-1)
    return struct.pack("<I", flat.size) + flat.astype("<u8").tobytes()


def _read_u64_block(buf: bytes, pos: int):
    (n,) = struct.unpack_from("<I", buf, pos)
    pos += 4
    end = pos + 8 * n
    if end > len(buf):
        raise ValueError("truncated u64 block in consts section")
    return np.frombuffer(buf[pos:end], dtype="<u8").astype(np.uint64), end


def write_consts_binfile(path: str, fixed_ext: np.ndarray, tree,
                         x_n: np.ndarray, x_ext: np.ndarray) -> None:
    """fixed_ext (extN, nConstants) interleaved evals on the extended
    domain; tree a hash.merkle.MerkleTree; x_n / x_ext domain points."""
    tree_payload = (
        struct.pack("<II", tree.width, tree.height)
        + _u64_block(tree.elements)
        + _u64_block(tree.nodes_flat())
    )
    write_bin_file(path, CNTS_MAGIC, 1, [
        (_CNTS_EVALS, _u64_block(fixed_ext)),
        (_CNTS_TREE, tree_payload),
        (_CNTS_XN, _u64_block(x_n)),
        (_CNTS_XEXT, _u64_block(x_ext)),
    ], n_sections=5)


def read_consts_binfile(path: str):
    """-> dict(fixedPolsEvals (flat), tree=(width, height, elements,
    nodes), x_n, x_ext).  Caller reshapes by starkinfo widths."""
    _, _, sections = read_bin_file(path, CNTS_MAGIC)
    for sid in (_CNTS_EVALS, _CNTS_TREE, _CNTS_XN, _CNTS_XEXT):
        if sid not in sections:
            raise ValueError(f"{path}: missing consts section {sid}")
    evals, _ = _read_u64_block(sections[_CNTS_EVALS], 0)
    tbuf = sections[_CNTS_TREE]
    width, height = struct.unpack_from("<II", tbuf, 0)
    elements, pos = _read_u64_block(tbuf, 8)
    nodes, _ = _read_u64_block(tbuf, pos)
    x_n, _ = _read_u64_block(sections[_CNTS_XN], 0)
    x_ext, _ = _read_u64_block(sections[_CNTS_XEXT], 0)
    return {
        "fixedPolsEvals": evals,
        "tree": (width, height, elements, nodes),
        "x_n": x_n,
        "x_ext": x_ext,
    }


def tree_from_consts(width: int, height: int, elements: np.ndarray,
                     nodes: np.ndarray):
    """Rebuild a hash.merkle.MerkleTree from the (elements, nodes) flat
    buffers of a consts/consttree file (reference node layout: each level
    padded to an even digest count, root last)."""
    from ..hash import merkle

    return merkle.MerkleTree(
        width=width, height=height,
        elements=elements.reshape(height, width).astype(np.uint64),
        levels=merkle.levels_from_nodes(nodes, height),
    )
