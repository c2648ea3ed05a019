"""Device-resident prover primitives: domain constants, DEEP evals,
xDivXSubXi, device Merkle trees and the batched query gather.

Counterpart of pil2_stark_tpu/stark/device.py in its single-device planar
form (``domain_consts`` :206, ``make_evals_executor`` :261,
``compute_xdiv`` :370, on kernel T2, ``DeviceTree`` :383, ``merkelize``
:419 with the zero-width uniform trees :405-450,
``gather_group_proofs_multi`` :512), and ``to_host_tree``, which turns a
device tree into the host hash.merkle.MerkleTree that the tree files are
written from.
Layouts are planar: a section is (cols, rows), a cubic-extension vector
(3, N).  Host↔device traffic is limited to witness uploads, roots, the
evals vector and one query gather per proof.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..field import f3, gl64
from ..field import torch_gl as gl
from ..field import torch_f3 as f3g
from ..hash import merkle, poseidon_gl, torch_poseidon
from ..ops import cuda_tac
from ..ops import ntt as ntt_ops


# ---------------------------------------------------------------------------
# domain constants (x_n, x_ext, zerofier rows) built on the device


def domain_consts(n_bits: int, n_bits_ext: int, boundaries, device):
    """(x_n (N,), x_ext (extN,), Zi (nBoundaries, extN)), bit-exact with the
    numpy tables of ops/polutils.py."""
    n, ext_n = 1 << n_bits, 1 << n_bits_ext
    extend_bits = n_bits_ext - n_bits
    x_n = gl.powers(gl64.w(n_bits), n, device)
    x_ext = gl.powers(gl64.w(n_bits_ext), ext_n, device, start=gl64.SHIFT_INT)
    sn = pow(gl64.SHIFT_INT, n, gl64.P_INT)
    zh_pat = gl64.inv(gl64.sub(
        gl64.mul(np.uint64(sn), gl64.powers(gl64.w(extend_bits), 1 << extend_bits)),
        np.uint64(1),
    ))
    zh_row = gl.from_u64(zh_pat, device).repeat(ext_n >> extend_bits)
    wn = gl64.w(n_bits)
    rows = []
    for b in boundaries:
        name = b["name"]
        if name == "everyRow":
            rows.append(zh_row)
        elif name in ("firstRow", "lastRow"):
            root = 1 if name == "firstRow" else pow(wn, n - 1, gl64.P_INT)
            rows.append(gl.inv(gl.mul(gl.sub(x_ext, gl.i64(root)), zh_row)))
        elif name == "everyFrame":
            roots = [pow(wn, i, gl64.P_INT) for i in range(b["offsetMin"])]
            roots += [pow(wn, n - i - 1, gl64.P_INT) for i in range(b["offsetMax"])]
            row = torch.ones(ext_n, dtype=torch.int64, device=device)
            for r in roots:
                row = gl.mul(row, gl.sub(x_ext, gl.i64(r)))
            rows.append(row)
        else:
            raise ValueError(f"Invalid boundary {name}")
    zi = torch.stack(rows) if rows else torch.zeros((0, ext_n), dtype=torch.int64, device=device)
    return x_n, x_ext, zi


# ---------------------------------------------------------------------------
# DEEP evals and xDivXSubXi


def _f3_geometric(pows2: np.ndarray, bits: int, device) -> torch.Tensor:
    """1, xi, …, xi^(2^bits - 1) as (3, 2^bits) by log-doubling; pows2 is
    (bits, 3) u64 holding xi^(2^k)."""
    acc = torch.tensor([[1], [0], [0]], dtype=torch.int64, device=device)
    steps = gl.from_u64(pows2, device)
    for k in range(bits):
        acc = torch.cat([acc, f3g.mul(acc, steps[k].reshape(3, 1))], dim=1)
    return acc


def _lev(xis, n_bits: int, device) -> list:
    """LEv of each opening: the iNTT of the geometric series of its xi,
    (3, N) on the device."""
    lev = []
    for xi in xis:
        pows2 = np.zeros((n_bits, 3), dtype=np.uint64)
        s = xi
        for k in range(n_bits):
            pows2[k] = _as3(s)
            s = f3.square(s)
        lev.append(ntt_ops.intt(_f3_geometric(pows2, n_bits, device), n_bits))
    return lev


def compute_evals(pil_info, sections, xis, n_bits: int, stride: int, device):
    """evals[k] = Σ_i pol_k[i·stride] · LEv_opening(k)[i] for every evMap
    entry (stark_gen_helpers.js:210-273); LEv = iNTT of the geometric
    series of the opening's xi.  Entries sharing an opening and a dim are
    reduced in one batch.  Returns a list of 3-tuples."""
    out = _eval_sums(pil_info, sections, _lev(xis, n_bits, device), stride, device)
    return [tuple(int(x) for x in row) for row in gl.to_u64(out)]


def compute_evals_sharded(pil_info, shards, xis, n_bits: int, stride: int, mesh):
    """compute_evals over a mesh: shards {section: sharded array of its
    extended rows}.  Rank r sums over its own decimated rows with its slice
    of each LEv; the partial sums are added in GL on each process's lead,
    exactly, so the evals are those of one device."""
    d = mesh.size
    lev = _lev(xis, n_bits, mesh.lead)
    nd = (1 << n_bits) // d
    parts = [None] * d
    for r in mesh.local_ranks:
        dv = mesh.device(r)
        lev_r = [x[:, r * nd:(r + 1) * nd].to(dv) for x in lev]
        parts[r] = _eval_sums(pil_info, {k: v[r] for k, v in shards.items()}, lev_r, stride,
                              dv).reshape(-1)
    total = None
    for p in mesh.gather_list(parts):
        total = p if total is None else gl.add(total, p)
    return [tuple(int(x) for x in row) for row in gl.to_u64(total.reshape(-1, 3))]


def _eval_sums(pil_info, sections, lev, stride: int, device) -> torch.Tensor:
    """(len(evMap), 3): Σ_i pol_k[i·stride] · lev[opening(k)][i] over the
    rows the sections hold."""
    ev_map = pil_info["evMap"]
    openings = list(pil_info["openingPoints"])
    cm_map = pil_info["cmPolsMap"]
    dec = {}
    groups = {}
    for k, ev in enumerate(ev_map):
        if ev["type"] == "const":
            sec, off, dim = "const", ev["id"], 1
        elif ev["type"] == "cm":
            p = cm_map[ev["id"]]
            sec, off, dim = f"cm{p['stage']}", p["stagePos"], p["dim"]
        else:
            raise ValueError(f"Invalid ev type: {ev['type']}")
        if sec not in dec:
            dec[sec] = sections[sec][:, ::stride]
        groups.setdefault((openings.index(ev["prime"]), dim), []).append((k, sec, off))

    out = torch.zeros((len(ev_map), 3), dtype=torch.int64, device=device)
    for (o, dim), items in groups.items():
        idx = [k for k, _, _ in items]
        if dim == 1:
            cols = torch.stack([dec[sec][off] for _, sec, off in items])  # (m, N)
            prod = gl.mul(lev[o][:, None, :], cols[None])  # (3, m, N)
        else:
            cols = torch.stack([dec[sec][off:off + 3] for _, sec, off in items], dim=1)
            prod = f3g.mul(cols, lev[o][:, None, :])  # (3, m, N)
        out[idx] = gl.gl_sum(prod, 2).T
    return out


def _as3(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (int(v) % gl64.P_INT, 0, 0)


def compute_xdiv(x_ext: torch.Tensor, xi_list) -> torch.Tensor:
    """x/(x − xi·w^opening) per opening over the extended coset
    (stark_gen_helpers.js:292-323); returns (nOpenings, 3, extN).  A CUDA
    x_ext runs kernel T2 (ops/cuda_tac.py::gl_xdiv), a CPU one the plain
    version."""
    if x_ext.device.type == "cpu":
        return compute_xdiv_plain(x_ext, xi_list)
    return cuda_tac.gl_xdiv(x_ext, xi_list)


def compute_xdiv_plain(x_ext: torch.Tensor, xi_list) -> torch.Tensor:
    """T2's plain version: the closed-form cubic inverse on whole columns."""
    outs = []
    x = x_ext[None, :]
    for xi3 in xi_list:
        xi = f3g.from_scalar(tuple(int(v) for v in xi3), x_ext.device)
        den = f3g.sub(x, xi)  # (3, extN)
        outs.append(f3g.mul(f3g.inv(den), x))
    return torch.stack(outs)


# ---------------------------------------------------------------------------
# device Merkle tree


@dataclasses.dataclass
class DeviceTree:
    """Poseidon-GL Merkle tree whose elements (width, height) and digest
    levels (4, n) stay on the device; same shape as hash.merkle.MerkleTree.
    uniform=True: a zero-width power-of-two tree, every node of a level the
    same digest, each level stored as one (4, 1) column.  base: the planar
    (width, N) base-domain columns the elements were extended from, where
    the tree keeps them (the const tree of stark.setup.load_setup, so that
    no prove uploads the fixed columns again); proves only read it."""

    width: int
    height: int
    elements: torch.Tensor
    levels: list
    uniform: bool = False
    base: torch.Tensor | None = None

    @functools.cached_property
    def root(self) -> np.ndarray:
        return gl.to_u64(self.levels[-1][:, 0])


@functools.lru_cache(maxsize=None)
def _zero_digest_chain(height: int) -> np.ndarray:
    """Per-level digests of the all-zero-leaf tree (constant per height)."""
    n_levels = height.bit_length()
    digests = np.zeros((n_levels, 4), dtype=np.uint64)
    for lvl in range(1, n_levels):
        prev = [int(v) for v in digests[lvl - 1]]
        digests[lvl] = poseidon_gl.permute_int(prev + prev + [0, 0, 0, 0])[:4]
    return digests


def merkelize(elements: torch.Tensor, width: int, height: int, split: bool = False) -> DeviceTree:
    """elements: planar (width, height) tensor on the device."""
    if width > 0:
        levels = torch_poseidon.merkle_levels_planar(elements, width, height, split)
        return DeviceTree(width=width, height=height, elements=elements, levels=levels)
    if height & (height - 1):
        raise ValueError("zero-width trees need a power-of-two height")
    chain = gl.from_u64(_zero_digest_chain(height), elements.device)
    levels = [chain[lvl].reshape(4, 1) for lvl in range(chain.shape[0])]
    return DeviceTree(width=0, height=height, elements=elements, levels=levels, uniform=True)


def gather_group_proofs_multi(trees, idxs_list):
    """Values and sibling paths of every query of every tree, in one device
    gather and one host transfer; returns one [(values, proof)] list per
    tree, matching merkle.get_group_proof (merklehash_p.js:142-168)."""
    parts = []
    for t, idxs in zip(trees, idxs_list):
        dev = t.elements.device
        cur = torch.as_tensor(np.asarray(idxs, dtype=np.int64), device=dev)
        parts.append(t.elements[:, cur])
        for lvl in t.levels[:-1]:
            sib = torch.zeros_like(cur) if t.uniform else cur ^ 1
            parts.append(lvl[:, sib])
            cur = cur >> 1
    flat = gl.to_u64(torch.cat(parts).T)  # (Q, Σ spans)
    results = []
    off = 0
    for t, idxs in zip(trees, idxs_list):
        w = t.width
        n_levels = len(t.levels) - 1
        span = w + 4 * n_levels
        out = []
        for qi in range(len(idxs)):
            row = flat[qi, off:off + span]
            proof = [row[w + 4 * lvl: w + 4 * (lvl + 1)].copy() for lvl in range(n_levels)]
            out.append((row[:w].copy(), proof))
        results.append(out)
        off += span
    return results


def to_host_tree(tree: DeviceTree) -> merkle.MerkleTree:
    """The host MerkleTree of a device tree, byte-equal through
    merkle.write_tree to the JAX package's tree of the same columns: the
    planar (width, height) elements become row-major (height, width),
    transposed on the device, so that the host holds them once; each (4, n)
    level becomes (n, 4), and a uniform tree's one-digest levels are
    expanded to their padded sizes."""
    levels = [gl.to_u64(lvl.T) for lvl in tree.levels]
    if tree.uniform:
        levels = [np.repeat(lvl, n, axis=0)
                  for lvl, n in zip(levels, merkle.level_sizes(tree.height))]
    return merkle.MerkleTree(width=tree.width, height=tree.height,
                             elements=gl.to_u64(tree.elements.T), levels=levels)
