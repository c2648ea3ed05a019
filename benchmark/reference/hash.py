"""Poseidon-GL, its linear hash, Merkle trees and the Fiat-Shamir
transcript of pil2-stark-js, in plain torch and python ints.

The permutation follows pil2-stark-js src/helpers/hash/poseidon/
poseidon.js:57-108 (width 12, 8 full and 22 partial rounds, x^7, the
C/S/M/P constant schedule); poseidon_gl_constants.npz is a frozen copy of
pil2_stark_tpu_torch/hash/poseidon_gl_constants.npz at commit a529475.
``permute`` is a copy of the plain version cuda_poseidon.permute_plain of
that commit, run on batches of at most CHUNK states so that a tree of
2^25 leaves fits beside the sections; ``permute_int`` of
hash/poseidon_gl.permute_int.  The tree and transcript rules are
merklehash_p.js:28-42 and 142-168, linearhash.js:8-42 and transcript.js.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from . import field as F

T = 12
HALF_F = 4
RP = 22
CHUNK = 1 << 24

_z = np.load(os.path.join(os.path.dirname(__file__), "poseidon_gl_constants.npz"))
_C, _S, _M, _P = _z["C"], _z["S"], _z["M"], _z["P"]
_C_INT = [int(x) for x in _C]
_S_INT = [int(x) for x in _S]
_M_INT = [[int(x) for x in row] for row in _M]
_P_INT = [[int(x) for x in row] for row in _P]
_TABLES: dict = {}


def _tables(device):
    k = _TABLES.get(str(device))
    if k is None:
        k = {"C": F.from_u64(_C, device), "S": F.from_u64(_S, device),
             "MT": torch.as_tensor(_M.astype("int64").T.copy(), device=device),
             "P": F.from_u64(_P, device)}
        _TABLES[str(device)] = k
    return k


def _mds_small(s, mt):
    lo = torch.zeros_like(s)
    hi = torch.zeros_like(s)
    for j in range(T):
        lo += mt[:, j, None] * (s[j] & F.MASK32)[None]
        hi += mt[:, j, None] * ((s[j] >> 32) & F.MASK32)[None]
    return F.combine_sums(lo, hi)


def _mat_full(s, mat):
    acc = F.mul(s[0][None, :], mat[0][:, None])
    for j in range(1, T):
        acc = F.add(acc, F.mul(s[j][None, :], mat[j][:, None]))
    return acc


def _permute(s):
    k = _tables(s.device)
    c = k["C"]
    s = F.add(s, c[:T, None])
    for r in range(HALF_F - 1):
        s = _mds_small(F.add(F.pow7(s), c[(r + 1) * T:(r + 2) * T, None]), k["MT"])
    s = _mat_full(F.add(F.pow7(s), c[HALF_F * T:(HALF_F + 1) * T, None]), k["P"])
    for r in range(RP):
        srow = k["S"][(2 * T - 1) * r:(2 * T - 1) * (r + 1)]
        s0 = F.add(F.pow7(s[0]), c[(HALF_F + 1) * T + r])
        rows = torch.cat([s0[None], s[1:]])
        new0 = F.gl_sum(F.mul(rows, srow[:T, None]), 0)
        s = torch.cat([new0[None], F.add(s[1:], F.mul(s0[None], srow[T:, None]))])
    base = (HALF_F + 1) * T + RP
    for r in range(HALF_F - 1):
        s = _mds_small(F.add(F.pow7(s), c[base + r * T:base + (r + 1) * T, None]), k["MT"])
    return _mds_small(F.pow7(s), k["MT"])


def permute(state: torch.Tensor) -> torch.Tensor:
    """(12, B) canonical states -> their permutations."""
    b = state.shape[1]
    if b <= CHUNK:
        return _permute(state)
    return torch.cat([_permute(state[:, i:i + CHUNK]) for i in range(0, b, CHUNK)], dim=1)


def permute_int(state) -> list:
    """The permutation of one state of 12 python ints."""
    p = F.P

    def pow7(x):
        x2 = x * x % p
        return x2 * x2 % p * x2 % p * x % p

    def mat(s, m):
        return [sum(s[j] * m[j][i] for j in range(T)) % p for i in range(T)]

    s = [(int(v) + _C_INT[i]) % p for i, v in enumerate(state)]
    for r in range(HALF_F - 1):
        s = mat([(pow7(v) + _C_INT[(r + 1) * T + i]) % p for i, v in enumerate(s)], _M_INT)
    s = mat([(pow7(v) + _C_INT[HALF_F * T + i]) % p for i, v in enumerate(s)], _P_INT)
    for r in range(RP):
        srow = _S_INT[(2 * T - 1) * r:(2 * T - 1) * (r + 1)]
        s[0] = (pow7(s[0]) + _C_INT[(HALF_F + 1) * T + r]) % p
        new0 = sum(s[j] * srow[j] for j in range(T)) % p
        for k in range(1, T):
            s[k] = (s[k] + s[0] * srow[T + k - 1]) % p
        s[0] = new0
    base = (HALF_F + 1) * T + RP
    for r in range(HALF_F - 1):
        s = mat([(pow7(v) + _C_INT[base + r * T + i]) % p for i, v in enumerate(s)], _M_INT)
    return mat([pow7(v) for v in s], _M_INT)


# -- trees ------------------------------------------------------------------


def leaf_digests(cols: torch.Tensor) -> torch.Tensor:
    """Linear hash of each row of planar (width, B) columns -> (4, B): rows
    of 4 or fewer values are their values padded with zeros; wider rows are
    absorbed 8 at a time."""
    width, b = cols.shape
    if width <= 4:
        out = torch.zeros((4, b), dtype=torch.int64, device=cols.device)
        out[:width] = cols
        return out
    st = torch.zeros((4, b), dtype=torch.int64, device=cols.device)
    for c in range(0, width, 8):
        state = torch.zeros((12, b), dtype=torch.int64, device=cols.device)
        state[:min(8, width - c)] = cols[c:c + 8]
        state[8:] = st
        st = permute(state)[:4]
    return st


class Tree:
    """A Poseidon-GL Merkle tree of planar (width, height) elements: the
    digest levels from the leaves up, each padded to an even count, the
    root last."""

    def __init__(self, elements: torch.Tensor, width: int, height: int):
        self.elements, self.width = elements, width
        if width == 0:  # every leaf the zero digest
            d = [0, 0, 0, 0]
            self.levels = []
            for _ in range(height.bit_length()):
                self.levels.append(torch.tensor([F.i64(v) for v in d], dtype=torch.int64,
                                                device=elements.device).reshape(4, 1))
                d = permute_int(d + d + [0, 0, 0, 0])[:4]
            self.uniform = True
            return
        self.uniform = False
        d = leaf_digests(elements)
        self.levels = []
        while d.shape[1] > 1:
            if d.shape[1] % 2:
                d = torch.cat([d, torch.zeros((4, 1), dtype=torch.int64, device=d.device)], 1)
            self.levels.append(d)
            m = d.shape[1] // 2
            state = torch.zeros((12, m), dtype=torch.int64, device=d.device)
            pairs = d.reshape(4, m, 2)
            state[:4], state[4:8] = pairs[:, :, 0], pairs[:, :, 1]
            d = permute(state)[:4]
        self.levels.append(d)

    @property
    def root(self) -> list:
        return [int(x) for x in F.to_u64(self.levels[-1][:, 0])]

    def group_proof(self, idx: int):
        """[leaf values, sibling digests from the leaves up] of row idx."""
        values = [int(x) for x in F.to_u64(self.elements[:, idx])] if self.width else []
        path = []
        for lvl in self.levels[:-1]:
            sib = 0 if self.uniform else idx ^ 1
            path.append([int(x) for x in F.to_u64(lvl[:, sib])])
            idx >>= 1
        return [values, path]


class Transcript:
    """The GL sponge of transcript.js: 8 pending inputs per permutation,
    a state of 4, squeezed one element at a time from the last output."""

    def __init__(self):
        self.state, self.pending, self.out = [0] * 4, [], []

    def put(self, values) -> None:
        for v in values:
            self.out = []
            self.pending.append(int(v))
            if len(self.pending) == 8:
                self._update()

    def _update(self) -> None:
        self.out = permute_int(self.pending + [0] * (8 - len(self.pending)) + self.state)
        self.pending, self.state = [], self.out[:4]

    def field1(self) -> int:
        if not self.out:
            self._update()
        return self.out.pop(0)

    def field3(self) -> tuple:
        return (self.field1(), self.field1(), self.field1())

    def permutations(self, n: int, n_bits: int) -> list:
        """n query indices of n_bits each, 63 bits used of each element."""
        fields = [self.field1() for _ in range((n * n_bits - 1) // 63 + 1)]
        bits = [(fields[k // 63] >> (k % 63)) & 1 for k in range(n * n_bits)]
        return [sum(bits[q * n_bits + j] << j for j in range(n_bits)) for q in range(n)]
