"""Prover context: host trace buffers, device sections, symbol tracking.

Counterpart of pil2_stark_tpu/stark/context.py in its single-device planar
form (:108-198).  Stage witnesses are host numpy (N, w) buffers, filled by
the inputs and the hint engine (stark/hints.py, stark/expr_eval.py), as on
the JAX device path.  Everything on the extended domain lives on the
device as planar (cols, rows) int64 tensors: ``dsections[dom][section]``,
x (``dx``), the zerofier rows (``dZi``), xDivXSubXi (``dxdiv``), Q
(``dq``) and the FRI polynomial (``df``).  The symbol tracker mirrors
pil2-stark-js src/prover/symbols_helpers.js:3-120.
"""
from __future__ import annotations

import numpy as np
import torch

from ..field import gl64
from ..field import torch_gl as gl
from ..hash.mh import MerkleHashGL, build_mh
from . import device as dev


class ProverCtx:
    """debug=True (pil2_stark_tpu/stark/context.py:18-63, :200): the base
    domain only, for the constraint check of a debug setup: no extended
    domain, no const tree, and the default GL transcript."""

    def __init__(self, pil_info, expressions_info, const_pols, const_tree, device, debug=False):
        self.pil_info = pil_info
        self.expressions_info = expressions_info
        self.const_tree = const_tree
        self.device = device
        self.debug = debug
        self.mesh = None  # the parallel.distributed.Mesh a sharded prove runs over
        self.dshards = {}  # on a mesh: {section: its extended rows, one block per rank}
        self.padded_bytes = {}  # on a mesh: {rank: the largest halo-padded copy it made}
        self.trees = {}

        ss = pil_info["starkStruct"]
        self.n_bits = ss["nBits"]
        self.N = 1 << self.n_bits
        if not debug:
            self.n_bits_ext = ss["nBitsExt"]
            self.ext_N = 1 << self.n_bits_ext
            self.extend_bits = self.n_bits_ext - self.n_bits
        else:
            self.n_bits_ext = self.ext_N = self.extend_bits = None
        self.external_challenges = None
        self.errors = []
        self.tmp = []
        self.challenges = []
        self.challenges_fri_steps = []
        self.publics = [None] * pil_info["nPublics"]
        self.subproof_values = [0] * pil_info.get("nSubproofValues", 0)
        self.evals = []
        self.calculated = _init_calculated(pil_info)

        n_constants = pil_info["nConstants"]
        self.const_n = np.asarray(const_pols, dtype=np.uint64).reshape(self.N, n_constants)
        for i in range(n_constants):
            self.calculated["const"][i] = True

        self.buffers = {}
        for i in range(pil_info["nStages"]):
            w = pil_info["mapSectionsN"][f"cm{i + 1}"]
            self.buffers[f"cm{i + 1}_n"] = np.zeros((self.N, w), dtype=np.uint64)
        self._x_n = None

        # the const tree keeps the base-domain columns on the device
        # (setup.load_setup): proves from one setup share them, read only
        const_n = None if const_tree is None else const_tree.base
        if const_n is None or const_n.device != device:
            const_n = gl.from_u64(np.ascontiguousarray(self.const_n.T), device)
        if debug:
            self.dx = {"n": gl.powers(gl64.w(self.n_bits), self.N, device)}
            self.dsections = {"n": {"const": const_n}}
        else:
            dx_n, dx_ext, self.dZi = dev.domain_consts(
                self.n_bits, self.n_bits_ext, pil_info["boundaries"], device)
            self.dx = {"n": dx_n, "ext": dx_ext}
            ext_const = getattr(const_tree, "elements", None)  # a ShardedTree has shards
            self.dsections = {"n": {"const": const_n},
                              "ext": {} if ext_const is None else {"const": ext_const}}
        self.dpending = {}
        self.dxdiv = None
        self.dq = None
        self.df = None

        self.mh = MerkleHashGL() if debug else build_mh(ss)
        self.transcript = self.mh.new_transcript()

    # -- host addressing (hints / expr_eval) ---------------------------------

    @property
    def x_n(self) -> np.ndarray:
        if self._x_n is None:
            self._x_n = gl64.powers(gl64.w(self.n_bits), self.N)
        return self._x_n

    def buffer(self, section: str, dom: str) -> np.ndarray:
        if dom != "n":
            raise ValueError("host buffers exist on the base domain only")
        if section == "const":
            return self.const_n
        return self.buffers[f"{section}_{dom}"]

    def get_pol_ref(self, pol_id: int, dom: str, is_fixed=False):
        """prover_helpers.js:305-321 getPolRef."""
        if is_fixed:
            return {"buffer": self.buffer("const", dom), "deg": self.N,
                    "offset": pol_id, "dim": 1, "stage": "const"}
        p = self.pil_info["cmPolsMap"][pol_id]
        section = f"cm{p['stage']}"
        return {"buffer": self.buffer(section, dom), "deg": self.N,
                "offset": p["stagePos"], "dim": p["dim"], "stage": section}

    def get_pol(self, pol_id: int, dom: str, is_fixed=False) -> np.ndarray:
        p = self.get_pol_ref(pol_id, dom, is_fixed)
        if p["dim"] == 1:
            return p["buffer"][:, p["offset"]].copy()
        return p["buffer"][:, p["offset"]: p["offset"] + p["dim"]].copy()

    def set_pol(self, pol_id: int, values, dom: str) -> None:
        p = self.get_pol_ref(pol_id, dom)
        arr = _to_array(values, p["dim"])
        if p["dim"] == 1:
            p["buffer"][:, p["offset"]] = arr
        else:
            p["buffer"][:, p["offset"]: p["offset"] + p["dim"]] = arr
        self.calculated["cm"][pol_id] = True

    # -- symbol tracking (symbols_helpers.js) -------------------------------

    def is_symbol_calculated(self, ref) -> bool:
        if ref["op"] == "tmp":
            return True
        return self.calculated[ref["op"]][ref["id"]]

    def set_symbol_calculated(self, ref) -> None:
        if ref["op"] == "tmp":
            return
        self.calculated[ref["op"]][ref["id"]] = True

    def stage_symbols_missing(self, stage: int) -> int:
        missing = 0
        for i, p in enumerate(self.pil_info["cmPolsMap"]):
            if p["stage"] == stage and not p.get("imPol") and not self.calculated["cm"][i]:
                missing += 1
        for i, c in enumerate(self.pil_info["challengesMap"]):
            if c["stage"] == stage and not self.calculated["challenge"][i]:
                missing += 1
        if stage == 1:
            missing += sum(not v for v in self.calculated["const"])
            missing += sum(not v for v in self.calculated["public"])
        if stage == self.pil_info["nStages"]:
            missing += sum(not v for v in self.calculated["subproofValue"])
        return missing


def _init_calculated(pil_info):
    return {
        "public": [False] * pil_info["nPublics"],
        "const": [False] * pil_info["nConstants"],
        "subproofValue": [False] * pil_info.get("nSubproofValues", 0),
        "challenge": [False] * len(pil_info["challengesMap"]),
        "cm": [False] * len(pil_info["cmPolsMap"]),
    }


def _to_array(values, dim) -> np.ndarray:
    """Accept list of scalars / tuples or numpy arrays; promote dim-1
    entries of a dim-3 pol to (v, 0, 0) (prover_helpers.js setPol)."""
    if isinstance(values, np.ndarray):
        if dim == 3 and values.ndim == 1:
            out = np.zeros((values.shape[0], 3), dtype=np.uint64)
            out[:, 0] = values
            return out
        return values.astype(np.uint64, copy=False)
    n = len(values)
    if dim == 1:
        return np.array([int(v) % gl64.P_INT for v in values], dtype=np.uint64)
    out = np.zeros((n, 3), dtype=np.uint64)
    for i, v in enumerate(values):
        if isinstance(v, (tuple, list)):
            out[i] = [int(x) % gl64.P_INT for x in v]
        else:
            out[i, 0] = int(v) % gl64.P_INT
    return out


def resolve_device(device) -> torch.device:
    """None means the card: raises when CUDA is unavailable, never falls
    back to the CPU.  A card without an index is the current one, so that
    the result equals the device of the tensors made on it."""
    dev_ = torch.device("cuda" if device is None else device)
    if dev_.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to prove on the CPU")
        if dev_.index is None:
            dev_ = torch.device("cuda", torch.cuda.current_device())
    return dev_
