"""shplonk: batched multi-polynomial multi-point KZG openings over BN254.

Host counterpart (a copy of the JAX package's protocol/shplonk.py) of the `shplonkjs` package the reference's
fflonk tier delegates to (see
pil2-stark-js src/fflonk/helpers/fflonk_shkey.js:1,
fflonk_prover_helpers.js:2, fflonk_verify.js:1).  Implements the BDFG20
two-commitment scheme used by fflonk:

  * polynomials opened at the same point set are packed into composed
    commitments  f_i(X) = sum_j p_j(X^c) X^j  (c = slot count), so one
    G1 point commits a whole stage;
  * opening all p_j at s = xi*w^prime becomes opening f_i at the c-th
    roots of s; the verifier reconstructs f_i(r) = sum_j p_j(s) r^j from
    the claimed evaluations;
  * all openings are batched with two witness commitments W1, W2 and a
    single pairing check  e([L] + y*[W2], G2) == e([W2], X_2).

Design divergence from shplonkjs (deliberate, self-consistent): the slot
count c is rounded up to a power of two (empty slots are zero
polynomials), so every root set is computable from the 2-adic root
tower — shplonkjs instead tunes composite c values via `extraMuls`.
Fiat-Shamir uses Keccak-256 over 32-byte big-endian scalars and
uncompressed G1 points, like shplonkjs' Keccak256Transcript; exact byte
compatibility with shplonkjs cannot be verified in this environment (no
node) and is not claimed — prover and verifier here are a matched pair.
"""
from __future__ import annotations

from ..curve.bn254 import (
    G1,
    G2,
    g1_add,
    g1_msm,
    g1_mul,
    g1_neg,
    g2_mul,
    pairing_check,
)
from ..ops.fft_bn128 import FR
from .keccak import keccak256
from .poly_fr import (
    poly_degree,
    poly_divmod,
    poly_eval,
    poly_interpolate,
    poly_mul,
    poly_scale,
    poly_sub,
    poly_trim,
    poly_zerofier,
    domain_w,
)

# ---------------------------------------------------------------------------
# Transcript
# ---------------------------------------------------------------------------


class Keccak256Transcript:
    """Fiat-Shamir transcript: scalars as 32-byte BE, G1 commitments as
    affine (x, y) 64 bytes BE; challenge = keccak256(buffer) mod FR."""

    def __init__(self):
        self._buf = b""

    def reset(self):
        self._buf = b""

    def add_scalar(self, v: int):
        self._buf += (v % FR).to_bytes(32, "big")

    def add_commit(self, pt):
        if pt is None:
            self._buf += b"\x00" * 64
        else:
            self._buf += pt[0].to_bytes(32, "big") + pt[1].to_bytes(32, "big")

    def get_challenge(self) -> int:
        return int.from_bytes(keccak256(self._buf), "big") % FR


# ---------------------------------------------------------------------------
# Powers of tau (dev-mode ceremony)
# ---------------------------------------------------------------------------


def dev_ptau(max_degree: int, tau: int = None, seed: bytes = b"pil2_stark_tpu dev ptau"):
    """Generate a powers-of-tau reference string of G1 size `max_degree`.

    Development/testing substitute for a real ceremony file (the
    reference reads .ptau files from the hermez ceremony;
    fflonk_setup.js:14).  The toxic scalar is derived from `seed` unless
    given explicitly, and discarded.
    """
    if tau is None:
        tau = int.from_bytes(keccak256(seed), "big") % FR
    g1s = []
    acc = G1
    for _ in range(max_degree):
        g1s.append(acc)
        acc = g1_mul(acc, tau)
    return {"g1": g1s, "X_2": g2_mul(G2, tau)}


# ---------------------------------------------------------------------------
# Setup
# ---------------------------------------------------------------------------


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def shplonk_setup(config: dict, ptau: dict) -> dict:
    """Group polynomial definitions into composed commitments.

    config: {"power": int, "polDefs": {opening: [{name, stage, degree, fi}]}}
    (the fi grouping indexes are assigned by the caller — the fflonk
    shkey builder; fflonk_shkey.js fixFIndex).
    Returns the zkey dict used by commit/open/verify.
    """
    power = config["power"]
    fmap = {}
    for opening in sorted(config["polDefs"].keys()):
        for e in config["polDefs"][opening]:
            fi = fmap.setdefault(
                e["fi"],
                {"index": e["fi"], "pols": [], "polDegrees": {}, "stages": {},
                 "openingPoints": []},
            )
            if e["name"] not in fi["pols"]:
                fi["pols"].append(e["name"])
                fi["stages"].setdefault(e["stage"], []).append(e["name"])
            fi["polDegrees"][e["name"]] = max(
                fi["polDegrees"].get(e["name"], 0), e["degree"]
            )
            if opening not in fi["openingPoints"]:
                fi["openingPoints"].append(opening)

    f = []
    for idx in sorted(fmap.keys()):
        fi = fmap[idx]
        fi["openingPoints"].sort()
        c = _next_pow2(len(fi["pols"]))
        fi["c"] = c
        max_len = max(fi["polDegrees"].values())
        fi["composedLen"] = c * max_len
        fi["stages"] = [
            {"stage": s, "pols": fi["stages"][s]} for s in sorted(fi["stages"])
        ]
        f.append(fi)

    power_w = max((fi["c"] for fi in f), default=1)
    max_len = max((fi["composedLen"] for fi in f), default=1)
    if len(ptau["g1"]) < max_len:
        raise ValueError(
            f"ptau too small: need {max_len} G1 powers, have {len(ptau['g1'])}"
        )
    return {
        "power": power,
        "powerW": power_w,
        "f": f,
        "X_2": ptau["X_2"],
    }


# ---------------------------------------------------------------------------
# Composition helpers
# ---------------------------------------------------------------------------


def _compose(fi: dict, pols: dict, only_stage=None) -> list:
    """f_i(X) = sum_j p_j(X^c) X^j, restricted to one stage's slots if
    only_stage is given (for partial per-stage commitments)."""
    c = fi["c"]
    names = fi["pols"]
    if only_stage is not None:
        stage_pols = next(
            (s["pols"] for s in fi["stages"] if s["stage"] == only_stage), []
        )
    max_len = max(
        [fi["composedLen"]]
        + [c * len(pols[n]) for n in names
           if n in pols and (only_stage is None or n in stage_pols)]
    )
    out = [0] * max_len
    for j, name in enumerate(names):
        if only_stage is not None and name not in stage_pols:
            continue
        coefs = pols[name]
        for t, v in enumerate(coefs):
            if v:
                out[c * t + j] = v
    return out


def _root_sets(zkey: dict, xi_seed: int):
    """Per-f_i opening root sets: the c-th roots of xi * w^prime.

    xi = xi_seed^powerW; with c = 2^a the roots are
    xi_seed^(powerW/c) * w_{2^(power+a)}^prime * w_{c}^j,  j in [0, c).
    Returns (xi, {f index: {prime: [roots]}}).
    """
    power = zkey["power"]
    power_w = zkey["powerW"]
    xi = pow(xi_seed, power_w, FR)
    sets = {}
    for fi in zkey["f"]:
        c = fi["c"]
        a = c.bit_length() - 1
        base = pow(xi_seed, power_w // c, FR)
        wc = domain_w(a) if a else 1
        wfine = domain_w(power + a)
        by_prime = {}
        for prime in fi["openingPoints"]:
            anchor = base * pow(wfine, prime, FR) % FR
            roots = []
            r = anchor
            for _ in range(c):
                roots.append(r)
                r = r * wc % FR
            by_prime[prime] = roots
        sets[fi["index"]] = by_prime
    return xi, sets


def eval_suffix(prime: int) -> str:
    return "" if prime == 0 else ("w" if prime == 1 else f"w{prime}")


def _ordered_eval_names(zkey: dict):
    out = []
    for fi in zkey["f"]:
        for name in fi["pols"]:
            for prime in fi["openingPoints"]:
                out.append((name + eval_suffix(prime), name, prime, fi["index"]))
    return out


# ---------------------------------------------------------------------------
# Commit / Open / Verify
# ---------------------------------------------------------------------------


def shplonk_commit(stage: int, zkey: dict, pols: dict, ptau: dict):
    """Commit the `stage` slots of every composed f_i containing that
    stage.  Returns [{index: "f{i}_{stage}", fIndex, commit, pol}]."""
    out = []
    for fi in zkey["f"]:
        if not any(s["stage"] == stage for s in fi["stages"]):
            continue
        part = _compose(fi, pols, only_stage=stage)
        part = poly_trim(part)
        cm = g1_msm(ptau["g1"][: len(part)], part)
        out.append(
            {"index": f"f{fi['index']}_{stage}", "fIndex": fi["index"],
             "commit": cm, "pol": part}
        )
    return out


def shplonk_open(zkey, ptau, pols, committed_pols, xi_seed, logger=None):
    """Produce the batched opening proof.

    pols: name -> coefficient list for every polynomial in the zkey.
    committed_pols: {"f{i}_{stage}": {"commit": G1, ...}} partial commits.
    Returns (cmts, evaluations): cmts has f{i} (summed), W1, W2.
    """
    xi, root_sets = _root_sets(zkey, xi_seed)

    # summed commitments per f_i
    cmts = {}
    for fi in zkey["f"]:
        acc = None
        for key, ent in committed_pols.items():
            if key.startswith(f"f{fi['index']}_"):
                acc = g1_add(acc, ent["commit"])
        cmts[f"f{fi['index']}"] = acc

    # claimed evaluations
    w_n = domain_w(zkey["power"])
    evaluations = {}
    for ev_name, name, prime, _ in _ordered_eval_names(zkey):
        point = xi * pow(w_n, prime, FR) % FR
        evaluations[ev_name] = poly_eval(pols[name], point)

    # alpha
    tr = Keccak256Transcript()
    tr.add_scalar(xi_seed)
    for ev_name, _, _, _ in _ordered_eval_names(zkey):
        tr.add_scalar(evaluations[ev_name])
    alpha = tr.get_challenge()

    # W1 = sum alpha^i (f_i - r_i) / Z_{T_i}
    composed, r_pols, t_roots = {}, {}, {}
    w1 = [0]
    alpha_pow = 1
    for fi in zkey["f"]:
        idx = fi["index"]
        fpol = poly_trim(_compose(fi, pols))
        composed[idx] = fpol
        roots = [r for prime in fi["openingPoints"]
                 for r in root_sets[idx][prime]]
        t_roots[idx] = roots
        pts = [(r, poly_eval(fpol, r)) for r in roots]
        r_pols[idx] = poly_interpolate(pts)
        num = poly_sub(fpol, r_pols[idx])
        quo, rem = poly_divmod(num, poly_zerofier(roots))
        assert poly_degree(rem) == 0 and rem[0] == 0, \
            f"f{idx} does not open to its claimed evaluations"
        w1 = [(a + alpha_pow * b) % FR for a, b in
              zip(w1 + [0] * max(0, len(quo) - len(w1)),
                  quo + [0] * max(0, len(w1) - len(quo)))]
        alpha_pow = alpha_pow * alpha % FR
    w1 = poly_trim(w1)
    cmts["W1"] = g1_msm(ptau["g1"][: len(w1)], w1)

    # y
    tr.reset()
    tr.add_scalar(alpha)
    tr.add_commit(cmts["W1"])
    y = tr.get_challenge()

    # L(X) = sum alpha^i Z_{T \ T_i}(y) (f_i(X) - r_i(y)) - Z_T(y) W1(X)
    all_roots = sorted({r for roots in t_roots.values() for r in roots})
    z_t_y = 1
    for r in all_roots:
        z_t_y = z_t_y * ((y - r) % FR) % FR
    big_l = [0]
    alpha_pow = 1
    denom_prod = 1
    for fi in zkey["f"]:
        idx = fi["index"]
        z_ti_y = 1
        for r in t_roots[idx]:
            z_ti_y = z_ti_y * ((y - r) % FR) % FR
        denom_prod = denom_prod * z_ti_y % FR
        z_diff = 1
        t_i = set(t_roots[idx])
        for r in all_roots:
            if r not in t_i:
                z_diff = z_diff * ((y - r) % FR) % FR
        term = poly_sub(composed[idx], [poly_eval(r_pols[idx], y)])
        big_l = poly_add_scaled(big_l, term, alpha_pow * z_diff % FR)
        alpha_pow = alpha_pow * alpha % FR
    big_l = poly_sub(big_l, poly_scale(w1, z_t_y))
    # W2 = L / (X - y): exact by construction (L(y) == 0)
    w2, rem = poly_divmod(big_l, [(-y) % FR, 1])
    assert poly_degree(rem) == 0 and rem[0] == 0, "L(y) != 0"
    cmts["W2"] = g1_msm(ptau["g1"][: len(w2)], w2)

    evaluations["inv"] = pow(denom_prod, FR - 2, FR)
    return cmts, evaluations


def poly_add_scaled(a: list, b: list, k: int) -> list:
    n = max(len(a), len(b))
    return [((a[i] if i < len(a) else 0) + k * (b[i] if i < len(b) else 0)) % FR
            for i in range(n)]


def shplonk_verify(vk, polynomials, evaluations, xi_seed, ptau_x2=None, logger=None):
    """Verify a batched opening: one pairing check.

    vk: the zkey structure (with X_2).  polynomials: {"f{i}": G1, "W1":
    G1, "W2": G1}.  evaluations: claimed values keyed name+suffix (any
    non-committed evaluations must already be filled in by the caller —
    fflonk_verify.js:88 does the same for Q).
    """
    xi, root_sets = _root_sets(vk, xi_seed)

    # recompute alpha / y from the transcript
    tr = Keccak256Transcript()
    tr.add_scalar(xi_seed)
    for ev_name, _, _, _ in _ordered_eval_names(vk):
        if ev_name not in evaluations:
            if logger:
                logger.warning(f"missing evaluation {ev_name}")
            return False
        tr.add_scalar(evaluations[ev_name])
    alpha = tr.get_challenge()
    tr.reset()
    tr.add_scalar(alpha)
    tr.add_commit(polynomials["W1"])
    y = tr.get_challenge()

    # reconstruct r_i from the claimed evaluations and accumulate
    # F = sum alpha^i Z_{T\T_i}(y) (C_i - [r_i(y)]) - Z_T(y) [W1]
    t_roots = {}
    for fi in vk["f"]:
        t_roots[fi["index"]] = [
            r for prime in fi["openingPoints"] for r in root_sets[fi["index"]][prime]
        ]
    all_roots = sorted({r for roots in t_roots.values() for r in roots})
    z_t_y = 1
    for r in all_roots:
        z_t_y = z_t_y * ((y - r) % FR) % FR

    f_acc = None
    const_acc = 0  # scalar multiple of G1 generator
    alpha_pow = 1
    denom_prod = 1
    for fi in vk["f"]:
        idx = fi["index"]
        c = fi["c"]
        pts = []
        for prime in fi["openingPoints"]:
            suffix = eval_suffix(prime)
            for r in root_sets[idx][prime]:
                # f_i(r) = sum_j p_j(xi w^prime) r^j
                acc, rp = 0, 1
                for name in fi["pols"]:
                    acc = (acc + evaluations[name + suffix] * rp) % FR
                    rp = rp * r % FR
                pts.append((r, acc))
        r_y = poly_eval(poly_interpolate(pts), y)
        z_ti_y = 1
        for r in t_roots[idx]:
            z_ti_y = z_ti_y * ((y - r) % FR) % FR
        denom_prod = denom_prod * z_ti_y % FR
        z_diff = 1
        t_i = set(t_roots[idx])
        for r in all_roots:
            if r not in t_i:
                z_diff = z_diff * ((y - r) % FR) % FR
        coef = alpha_pow * z_diff % FR
        cm = polynomials.get(f"f{idx}")
        if cm is None:
            if logger:
                logger.warning(f"f{idx} commit missing")
            return False
        f_acc = g1_add(f_acc, g1_mul(cm, coef))
        const_acc = (const_acc + coef * r_y) % FR
        alpha_pow = alpha_pow * alpha % FR

    if "inv" in evaluations and evaluations["inv"] * denom_prod % FR != 1:
        if logger:
            logger.warning("invalid batched-inverse hint")
        return False

    f_acc = g1_add(f_acc, g1_neg(g1_mul(G1, const_acc)))
    f_acc = g1_add(f_acc, g1_neg(g1_mul(polynomials["W1"], z_t_y)))

    # e([L] + y [W2], G2) == e([W2], X_2)
    lhs = g1_add(f_acc, g1_mul(polynomials["W2"], y))
    x2 = ptau_x2 if ptau_x2 is not None else vk["X_2"]
    return pairing_check([(lhs, G2), (g1_neg(polynomials["W2"]), x2)])
