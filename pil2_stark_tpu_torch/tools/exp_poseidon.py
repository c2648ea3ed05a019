"""Kernel X2: the Poseidon experiment variants (csrc/poseidon_variants.cu),
beside their plain PyTorch version, and the tool that times them.

Counterpart of tools/exp_poseidon.py (``build`` :431, ``run_variant``
:477, ``run_sustained`` :527).  A variant is named as there, by the
tokens its name contains; on the card each is an instance of kernel B4's
schedule (csrc/poseidon_fast.cuh), and ``packed-nosq-lazy`` is B4's
schedule itself, the control:

  nosq   x^7 by four general multiplies (otherwise dedicated squarings);
  lazy   any-u64 representatives between operations, one canon at exit
         (otherwise every reduction is canonicalised);
  dual   two independent states per thread (two lane halves on the TPU);
  p4x, psl   the TPU's register layout of the partial-round S-box: the
         same function, and on the card the base schedule;
  nomxu, nops, nofs   ceiling probes: every matrix product becomes
         ``x ^= 1``; the partial rounds skip x^7; the full rounds skip x^7
         (the S-box before the last matrix still runs).

Without a probe every variant computes the Poseidon permutation and its
output is canonical.  A probe combined with ``lazy`` raises ValueError: its
output would depend on the representatives the implementation keeps.  So
does a name with two probes.

``build(variant, n_blocks, block)`` returns a callable on planar
``(12, n_blocks·block)`` int64 tensors.  On a CUDA tensor it launches X2
(building it at first use) and counts ``permute_variant.launches``; on a
CPU tensor it runs ``permute_variant_plain``; any other device raises.

    python -m pil2_stark_tpu_torch.tools.exp_poseidon [variant[:block] ...]
    python -m pil2_stark_tpu_torch.tools.exp_poseidon decompose  # one JSON line
"""
from __future__ import annotations

import ctypes
import json
import sys
from dataclasses import dataclass

import numpy as np
import torch

from ..field import torch_gl as gl
from ..hash import cuda_poseidon as cp
from ..hash import poseidon_gl as ref
from ..stark.context import resolve_device
from ..utils import cuda_build
from ..utils.timing import chain_ms

P = gl.P_INT
T = cp.T
PROBES = ("nomxu", "nops", "nofs")
CONTROL = "packed-nosq-lazy"  # B4's schedule, one state a thread
# decompose's bases and their probes: the matrices (nomxu), the partial
# S-boxes (nops) and the full S-boxes (nofs) dropped from the squaring and
# the general-multiply schedule
DECOMPOSITION = {"packed": ("nomxu", "packed-nops", "packed-nofs"),
                 "packed-nosq": ("nosq-nomxu", "packed-nosq-nops", "packed-nosq-nofs")}
# csrc/poseidon_variants.cu's mode argument
_MODES = {None: 0, "nomxu": 1, "nops": 2, "nofs": 3}
_MODE_LAZY = 4


@dataclass(frozen=True)
class Variant:
    sq: bool
    lazy: bool
    dual: bool
    probe: str | None


def parse(variant: str) -> Variant:
    """The flags of a variant name, as tools/exp_poseidon.py:432-445 reads
    them."""
    probes = [p for p in PROBES if p in variant]
    lazy = "lazy" in variant
    if len(probes) > 1:
        raise ValueError(f"{variant}: one probe at a time, got {probes}")
    if lazy and probes:
        raise ValueError(f"{variant}: a probe on lazy representatives has no "
                         "implementation-independent output")
    return Variant(sq="nosq" not in variant, lazy=lazy, dual="dual" in variant,
                   probe=probes[0] if probes else None)


def _add_fold(a, b):
    """pallas_poseidon._add: a + b for any u64 representatives, the carry
    out of 2^64 folded as 2^64 ≡ EPS (twice if the fold carries), no canon."""
    s = a + b
    c = gl.ult(s, a)
    t = torch.where(c, s + gl.EPS, s)
    return torch.where(c & gl.ult(t, s), t + gl.EPS, t)


def permute_variant_plain(state: torch.Tensor, variant: str) -> torch.Tensor:
    """(12, B) -> (12, B): the function of `variant`, in plain torch ops.

    Round-constant adds are pallas_poseidon._add (folded, not canonical);
    products and matrix products are canonical, so the representatives
    that a nomxu flip sees are the kernel's and the JAX body's.  ``sq``,
    ``lazy``, ``dual``, ``p4x`` and ``psl`` change how the kernel computes,
    not what: they share this schedule."""
    v = parse(variant)
    k = cp._consts(state.device)
    c = k["C"]

    def linear(s, product):
        return s ^ 1 if v.probe == "nomxu" else product(s)

    def mds(s):
        return cp._mds_small(s, k["MT"])

    def full(s, off, product):
        if v.probe != "nofs":
            s = gl.pow7(s)
        return linear(_add_fold(s, c[off:off + T, None]), product)

    s = _add_fold(state, c[:T, None])
    for r in range(cp.HALF_F - 1):
        s = full(s, (r + 1) * T, mds)
    s = full(s, cp.HALF_F * T, lambda x: cp._mat_full(x, k["P"]))
    for r in range(cp.RP):
        x0 = s[0] if v.probe == "nops" else gl.pow7(s[0])
        s0 = _add_fold(x0, c[(cp.HALF_F + 1) * T + r])
        if v.probe == "nomxu":
            s = torch.cat([s0[None], s[1:]]) ^ 1
            continue
        srow = k["S"][(2 * T - 1) * r:(2 * T - 1) * (r + 1)]
        new0 = gl.gl_sum(gl.mul(torch.cat([s0[None], s[1:]]), srow[:T, None]), 0)
        rest = gl.add(s[1:], gl.mul(s0[None], srow[T:, None]))
        s = torch.cat([new0[None], rest])
    base = (cp.HALF_F + 1) * T + cp.RP
    for r in range(cp.HALF_F - 1):
        s = full(s, base + r * T, mds)
    # the S-box before the last matrix runs under every probe
    return linear(gl.pow7(s), mds)


def permute_variant_int(state, variant: str) -> list:
    """One state (12 ints, any u64) through the kernel's instance of B4's
    schedule for `variant`, on python ints (cuda_poseidon's twin): the
    kernel's representative at every step.  Equal to permute_variant_plain
    word for word, the nomxu flips included."""
    v = parse(variant)
    return cp.permute_schedule_int(state, canonical=not v.lazy, sq=v.sq, probe=v.probe)


def _lib(v: Variant):
    """The part of csrc/poseidon_variants.cu that holds v's instantiation."""
    group = "perm" if v.probe is None else "probes"
    lib = cuda_build.lib(f"poseidon_variants.sq{int(v.sq)}_ns{2 if v.dual else 1}_{group}")
    if not getattr(lib, "_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.poseidon_variant.argtypes = [vp, vp, ctypes.c_longlong, i, i, i, i, vp]
        lib.poseidon_variant.restype = i
        lib._typed = True
    return lib


def permute_variant(state: torch.Tensor, variant: str, block: int) -> torch.Tensor:
    """X2 on a CUDA tensor, its plain version on a CPU tensor.  `block` is
    the number of states one CTA owns; the batch must be a multiple of it."""
    v = parse(variant)
    if state.dim() != 2 or state.shape[0] != T or block < 1 or state.shape[1] % block:
        raise ValueError(f"poseidon variant: want (12, a multiple of block={block}), "
                         f"got {tuple(state.shape)}")
    if v.dual and block % 2:
        raise ValueError(f"poseidon variant {variant}: block {block} must be even")
    if state.device.type == "cpu":
        return permute_variant_plain(state, variant)
    if state.device.type != "cuda":
        raise ValueError(f"poseidon variant: unsupported device {state.device}")
    if state.dtype != torch.int64:
        raise ValueError(f"poseidon variant: want int64, got {state.dtype}")
    if state.shape[1] // block >= 1 << 31:
        raise ValueError(f"poseidon variant: {state.shape[1] // block} blocks exceed the grid")
    state = state.contiguous()
    out = torch.empty_like(state)
    mode = _MODE_LAZY if v.lazy else _MODES[v.probe]
    stream = ctypes.c_void_p(torch.cuda.current_stream(state.device).cuda_stream)
    rc = _lib(v).poseidon_variant(state.data_ptr(), out.data_ptr(), state.shape[1], block,
                                 int(v.sq), int(v.dual), mode, stream)
    if rc != 0:
        raise RuntimeError(f"poseidon_variant launch failed: CUDA error {rc}")
    permute_variant.launches += 1
    return out


permute_variant.launches = 0


def build(variant: str, n_blocks: int, block: int):
    """A callable on (12, n_blocks·block) int64 tensors computing `variant`."""
    parse(variant)
    batch = n_blocks * block
    if n_blocks < 1 or block < 1:
        raise ValueError(f"build: n_blocks={n_blocks}, block={block}")

    def fn(state: torch.Tensor) -> torch.Tensor:
        if tuple(state.shape) != (T, batch):
            raise ValueError(f"{variant}: want (12, {batch}), got {tuple(state.shape)}")
        return permute_variant(state, variant, block)

    return fn


def _states(batch: int, device):
    rng = np.random.default_rng(0)
    states = rng.integers(0, P, size=(batch, T), dtype=np.uint64)
    return states, gl.from_u64(states.T.copy(), device)


def _check(variant: str, states: np.ndarray, x: torch.Tensor, out: torch.Tensor) -> bool:
    """The first 64 outputs against the numpy oracle, or for a probe
    against its plain version on the CPU."""
    n = min(64, states.shape[0])
    if parse(variant).probe is None:
        return bool(np.array_equal(gl.to_u64(out[:, :n]).T, ref.permute(states[:n])))
    want = permute_variant_plain(x[:, :n].cpu(), variant)
    return bool(torch.equal(out[:, :n].cpu(), want))


def _device_name(dev) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def run_variant(variant: str, block: int = 512, batch: int = 1 << 16, device=None) -> dict:
    """Check and time one variant: chains of 5 calls, the best of 3."""
    dev = resolve_device(device)
    states, x = _states(batch, dev)
    fn = build(variant, batch // block, block)
    before = permute_variant.launches
    ok = _check(variant, states, x, fn(x))
    ms = chain_ms(fn, x, 5, 3)
    res = {"variant": variant, "block": block, "batch": batch, "ok": ok, "ms": ms,
           "perms_per_s": batch / ms * 1e3, "launches": permute_variant.launches - before,
           "device": _device_name(dev)}
    print(f"{variant:28s} block={block:5d} ok={ok} {res['perms_per_s'] / 1e6:9.1f}M perms/s "
          f"({ms:.3f} ms, {res['device']})", flush=True)
    return res


def run_sustained(variant: str, block: int = 2048, batch: int = 1 << 16, device=None) -> dict:
    """Sustained rate: chains of 30 calls, the best of 2."""
    dev = resolve_device(device)
    _, x = _states(batch, dev)
    fn = build(variant, batch // block, block)
    before = permute_variant.launches
    ms = chain_ms(fn, x, 30, 2)
    res = {"variant": variant, "block": block, "batch": batch, "ms": ms,
           "perms_per_s": batch / ms * 1e3, "launches": permute_variant.launches - before,
           "device": _device_name(dev)}
    print(f"{variant:28s} block={block:5d} sustained {res['perms_per_s'] / 1e6:9.1f}M perms/s "
          f"({ms:.3f} ms, {res['device']})", flush=True)
    return res


def decompose(device=None, bits=(22, 25), block: int = 256, chain=(5, 3),
              seed: int = 0) -> dict:
    """The permutation's time split by the probes.  At each 2^bits random
    states, in one run, at one state a thread by default (block 256, B4's
    geometry): B4 (before and after the rest), the control,
    ``packed-lazy``, each base of DECOMPOSITION and each of its probes, as
    chains of chain[0] calls, the best of chain[1].  A base minus its probe
    is the time of the work the probe drops, given in ms and as a share of
    that base.  The bases are canonical (a probe on ``lazy`` is refused),
    so the dropped time includes the canons that follow the dropped
    reductions: of B4's lazy schedule it is an upper bound.  The control
    minus the probe stands beside it."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    res = {"device": _device_name(dev), "block": block, "sizes": {}}
    names = [CONTROL, "packed-lazy"] + [v for base, probes in DECOMPOSITION.items()
                                        for v in (base, *probes)]
    for b in bits:
        n = 1 << b
        x = gl.from_u64(rng.integers(0, P, size=(T, n), dtype=np.uint64), dev)
        b4 = [chain_ms(cp.permute, x, *chain)]
        ms = {v: chain_ms(build(v, n // block, block), x, *chain) for v in names}
        b4.append(chain_ms(cp.permute, x, *chain))
        mean = sum(b4) / 2
        drops = {probe: {"base": base, "dropped_ms": ms[base] - ms[probe],
                         "share_of_base": (ms[base] - ms[probe]) / ms[base],
                         "control_minus_probe_ms": ms[CONTROL] - ms[probe]}
                 for base, probes in DECOMPOSITION.items() for probe in probes}
        res["sizes"][b] = {"b4_ms": b4, "ms": ms, "vs_b4": {v: t / mean for v, t in ms.items()},
                           "drops": drops}
        print(f"decompose 2^{b}: B4 {b4[0]:.3f}/{b4[1]:.3f} ms, control {ms[CONTROL]:.3f} ms, "
              + ", ".join(f"{p} drops {d['share_of_base']:.1%} of {d['base']}"
                         for p, d in drops.items())
              + f" ({res['device']})", flush=True)
        del x
    return res


def main(argv=None, batch: int = 1 << 16, device=None) -> list[dict]:
    """run_variant for each `variant[:block]` of argv (default: packed-nosq,
    packed, packed-p4x at block 512)."""
    args = list(argv) if argv else ["packed-nosq", "packed", "packed-p4x"]
    out = []
    for a in args:
        variant, _, block = a.partition(":")
        out.append(run_variant(variant, block=int(block) if block else 512, batch=batch,
                               device=device))
    return out


if __name__ == "__main__":
    if sys.argv[1:] == ["decompose"]:
        print(json.dumps(decompose()))
        sys.exit(0)
    sys.exit(0 if all(r["ok"] for r in main(sys.argv[1:])) else 1)
