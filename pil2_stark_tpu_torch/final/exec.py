"""Final-tier exec: witness → committed columns, and the `.exec` artifact.

Counterpart of pil2-stark-js src/final/{main_final_exec.js:55-72,
exec_helpers.js}: extend the circuit witness with the plonk addition
chain (adds are (sl, sr, kl, kr) with kl/kr full Fr scalars, stored in
separate u64-index / 32-byte-Fr sections in the binary format), then
scatter through sMap into the machine's committed columns.
"""
from __future__ import annotations

import numpy as np

from .plonksetup import FR

_EXEC_MAGIC = b"p2sTexeF"  # this framework's container tag (Fr exec)


def exec_witness(witness, plonk_additions, s_map):
    """Returns (N, nCols) object array of Fr values."""
    w = [int(x) % FR for x in witness]
    for sl, sr, kl, kr in plonk_additions:
        w.append((w[int(sl)] * int(kl) + w[int(sr)] * int(kr)) % FR)
    n = s_map[0].shape[0]
    n_cols = len(s_map)
    cm = np.zeros((n, n_cols), dtype=object)
    for j in range(n_cols):
        col = s_map[j]
        for i in range(n):
            s = int(col[i])
            cm[i, j] = w[s] if s else 0
    return cm


def _fr_bytes(v: int) -> bytes:
    return int(v % FR).to_bytes(32, "little")


def write_exec_file(path, plonk_additions, s_map, ref_format=False):
    """exec_helpers.js writeExecFile layout: info (nAdds, nSMap), adds
    signal-index pairs (u64), adds Fr coefficient pairs (32-byte LE),
    sMap row-major (u64).  ref_format=True writes the reference's iden3
    "exec" binfile container instead of this framework's flat one."""
    if ref_format:
        from ..utils import binfile

        binfile.write_exec_binfile(path, plonk_additions, s_map)
        return
    n_adds = len(plonk_additions)
    n_smap = int(s_map[0].shape[0])
    with open(path, "wb") as f:
        f.write(_EXEC_MAGIC)
        np.array([n_adds, n_smap, len(s_map)], dtype="<u8").tofile(f)
        for sl, sr, kl, kr in plonk_additions:
            np.array([int(sl), int(sr)], dtype="<u8").tofile(f)
        for sl, sr, kl, kr in plonk_additions:
            f.write(_fr_bytes(kl))
            f.write(_fr_bytes(kr))
        np.stack([np.asarray(c, dtype="<u8") for c in s_map], axis=1).reshape(
            -1
        ).tofile(f)


def read_exec_file(path, n_cols=None):
    """Auto-detects the container: this framework's flat format or the
    reference's "exec" binfile (which carries no column count — pass
    n_cols for those, as the reference's readExecFile does)."""
    with open(path, "rb") as f:
        magic = f.read(8)
        if magic[:4] == b"exec":
            from ..utils import binfile

            if n_cols is None:
                raise ValueError(
                    f"{path}: reference exec binfile needs n_cols")
            return binfile.read_exec_binfile(path, n_cols)
        if magic != _EXEC_MAGIC:
            raise ValueError(
                f"{path}: not a final-tier exec file (bad magic {magic!r})"
            )
        n_adds, n_smap, n_cols = (
            int(x) for x in np.fromfile(f, dtype="<u8", count=3)
        )
        idx = np.fromfile(f, dtype="<u8", count=n_adds * 2).reshape(n_adds, 2)
        coefs = []
        for _ in range(n_adds):
            kl = int.from_bytes(f.read(32), "little")
            kr = int.from_bytes(f.read(32), "little")
            coefs.append((kl, kr))
        smap = np.fromfile(f, dtype="<u8", count=n_smap * n_cols)
        if smap.size != n_smap * n_cols:
            raise ValueError(f"{path}: truncated sMap section")
        smap = smap.reshape(n_smap, n_cols)
    adds = [
        [int(idx[i, 0]), int(idx[i, 1]), coefs[i][0], coefs[i][1]]
        for i in range(n_adds)
    ]
    s_map = [smap[:, j].copy() for j in range(n_cols)]
    return adds, s_map
