"""FRI low-degree test: device folds, query extraction, verification.

Counterpart of pil2_stark_tpu/stark/fri.py (planar device fold
``_fold_device`` :100 with ``_jit_fold_eval`` :283 and
``_transposed_device_planar`` :360; ``proof_queries``/``_gather_jobs``
:155-211; ``verify`` :213), itself pil2-stark-js src/stark/fri.js.  A
fold groups the (3, n) polynomial by the next step size, runs the
per-group iNTT (a small axis-0 transform, kernel B1 on the card), de-scales by
shiftInv·w^-g powers and evaluates at the challenge by Horner; every
non-final step re-Merkelizes the transposed groups 3-wide through the hash
backend (hash/mh.py: on the device for GL trees, on the host for BN128).
"""
from __future__ import annotations

import numpy as np
import torch

from ..field import f3, gl64
from ..field import torch_gl as gl
from ..field import torch_f3 as f3g
from ..hash.mh import MerkleHashGL
from ..ops import ntt as ntt_ops


def _log2(n):
    return n.bit_length() - 1


class FRI:
    def __init__(self, stark_struct, mh=None):
        self.in_n_bits = stark_struct["nBitsExt"]
        self.max_deg_n_bits = stark_struct["nBits"]
        self.n_queries = stark_struct["nQueries"]
        self.steps = stark_struct["steps"]
        self.mh = mh if mh is not None else MerkleHashGL(
            stark_struct.get("splitLinearHash", False))

    def fold(self, step: int, pol: torch.Tensor, challenge):
        """pol: (3, n) device tensor.  Returns {pol, tree, proof}; the final
        step's pol is a host (m, 3) u64 array (its values feed the
        transcript)."""
        pol_bits = _log2(pol.shape[1])
        if step == 0 and pol_bits != self.in_n_bits:
            raise ValueError("Invalid polynomial size")

        shift_inv = gl64.SHIFT_INV_INT
        if step > 0:
            for _ in range(self.steps[0]["nBits"] - self.steps[step - 1]["nBits"]):
                shift_inv = (shift_inv * shift_inv) % gl64.P_INT

        reduction_bits = pol_bits - self.steps[step]["nBits"]
        pol2_n = 1 << (pol_bits - reduction_bits)
        n_x = pol.shape[1] // pol2_n

        if step == 0:
            pol2 = pol
        else:
            pol2 = _fold_eval(pol, pol_bits, pol2_n, n_x, shift_inv, challenge)

        if step != len(self.steps) - 1:
            n_groups = 1 << self.steps[step + 1]["nBits"]
            group_size = (1 << self.steps[step]["nBits"]) // n_groups
            h = pol2.shape[1] // n_groups
            buff = pol2.reshape(3, h, n_groups).permute(1, 0, 2).reshape(3 * h, n_groups)
            tree = self.mh.merkelize(buff.contiguous(), 3 * group_size, n_groups)
            return {"pol": pol2, "tree": tree, "proof": {"root": self.mh.root(tree)}}

        pol2_np = np.ascontiguousarray(gl.to_u64(pol2).T)  # (m, 3)
        proof = [tuple(int(x) for x in pol2_np[i]) for i in range(pol2_np.shape[0])]
        return {"pol": pol2_np, "tree": None, "proof": proof}

    def proof_queries(self, proof, trees, fri_queries, gather=None):
        """fri.js:83-105 — mutates fri_queries (index folding) like the JS.
        Every (tree, folded-index) job is extracted in ONE device gather:
        gather(trees, idxs_list), the hash backend's unless given (a mesh
        prove gives parallel/merkle_sharded's)."""
        jobs = []
        for step in range(len(self.steps)):
            if step == 0:
                for t in trees[step]:
                    jobs.append((t, list(fri_queries)))
            else:
                for i in range(len(fri_queries)):
                    fri_queries[i] = fri_queries[i] % (1 << self.steps[step]["nBits"])
                jobs.append((trees[step], list(fri_queries)))

        gather = gather or self.mh.get_group_proofs_multi
        res = gather([t for t, _ in jobs], [i for _, i in jobs])
        per_job = [[[v, p] for v, p in r] for r in res]

        n_t = len(trees[0])
        proof[0]["polQueries"] = [
            [per_job[t][qi] for t in range(n_t)] for qi in range(len(fri_queries))
        ]
        for step in range(1, len(self.steps)):
            proof[step]["polQueries"] = per_job[n_t + step - 1]

    def verify(self, fri_challenges, fri_queries, proof, check_query):
        """fri.js:107-174.  proof is the prover's fri list: [step0, step1,
        ..., lastPol]."""
        if len(proof) != len(self.steps) + 1:
            return False
        fri_queries = list(fri_queries)

        pol_bits = self.in_n_bits
        shift = gl64.SHIFT_INT
        for si in range(len(self.steps)):
            proof_item = proof[si]
            reduction_bits = pol_bits - self.steps[si]["nBits"]
            for i in range(self.n_queries):
                pgroup_e = check_query(proof_item["polQueries"][i], fri_queries[i])
                if not pgroup_e:
                    return False
                pgroup_c = _ifft_scalars(pgroup_e)
                sinv = f3.inv1(
                    (shift * pow(gl64.w(pol_bits), fri_queries[i], gl64.P_INT)) % gl64.P_INT
                )
                ev = _eval_pol_scalar(pgroup_c, f3.mul(fri_challenges[si], sinv))

                if si < len(self.steps) - 1:
                    next_n_groups = 1 << self.steps[si + 1]["nBits"]
                    group_idx = fri_queries[i] // next_n_groups
                    vals = proof[si + 1]["polQueries"][i][0]
                    got = (int(vals[group_idx * 3]), int(vals[group_idx * 3 + 1]),
                           int(vals[group_idx * 3 + 2]))
                    if not f3.eq(got, ev):
                        return False
                elif not f3.eq(_as_tuple(proof[si + 1][fri_queries[i]]), ev):
                    return False

            def check_query_next(query, idx, _si=si):
                if not self.mh.verify_group_proof(proof[_si + 1]["root"], query[1], idx, query[0]):
                    return False
                return _split3(query[0])

            check_query = check_query_next

            pol_bits = self.steps[si]["nBits"]
            for _ in range(reduction_bits):
                shift = (shift * shift) % gl64.P_INT

            if si < len(self.steps) - 1:
                for i in range(len(fri_queries)):
                    fri_queries[i] = fri_queries[i] % (1 << self.steps[si + 1]["nBits"])

        last_pol_e = proof[-1]
        deg_shift = self.in_n_bits - self.max_deg_n_bits
        max_deg = 0 if pol_bits - deg_shift < 0 else 1 << (pol_bits - deg_shift)

        last_pol_c = _ifft_scalars([_as_tuple(v) for v in last_pol_e])
        for i in range(max_deg + 1, len(last_pol_c)):
            if not f3.is_zero(last_pol_c[i]):
                return False
        return True


def _fold_eval(pol, pol_bits: int, pol2_n: int, n_x: int, shift_inv: int, challenge):
    """Grouped iNTT + de-scale + Horner: (3, n) -> (3, pol2_n).  Group g of
    the polynomial is the contiguous lane block [g·pol2_n, (g+1)·pol2_n)."""
    device = pol.device
    g = pol.reshape(3, n_x, pol2_n).permute(1, 0, 2).reshape(n_x, 3 * pol2_n)
    coefs = ntt_ops.intt_rows(g, _log2(n_x)).reshape(n_x, 3, pol2_n)
    sinv = gl.powers(gl64.w_inv(pol_bits), pol2_n, device, start=shift_inv)
    scale = [torch.ones_like(sinv)]
    for _ in range(1, n_x):
        scale.append(gl.mul(scale[-1], sinv))
    coefs = gl.mul(coefs, torch.stack(scale)[:, None, :])
    ch = f3g.from_scalar(tuple(challenge), device)
    res = coefs[n_x - 1]
    for k in range(n_x - 2, -1, -1):
        res = f3g.add(f3g.mul(res, ch), coefs[k])
    return res


def _as_tuple(v):
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    arr = np.asarray(v)
    return (int(arr[0]), int(arr[1]), int(arr[2]))


def _split3(arr):
    return [(int(arr[i]), int(arr[i + 1]), int(arr[i + 2])) for i in range(0, len(arr), 3)]


def _ifft_scalars(vals):
    """Scalar iNTT over extension values (small n), matching F.ifft
    (fft.js:165-174)."""
    n = len(vals)
    arr = np.array([f3.as3(v) for v in vals], dtype=np.uint64)
    out = ntt_ops.ntt_host_u64(arr.reshape(n, 3), _log2(n), inverse=True)
    return [tuple(int(x) for x in out[i]) for i in range(n)]


def _eval_pol_scalar(p, x):
    if len(p) == 0:
        return 0
    res = p[-1]
    for c in reversed(p[:-1]):
        res = f3.add(f3.mul(res, x), c)
    return res
