"""fflonk zkey construction: polynomial→commitment grouping + const-pols
setup.

Counterpart of pil2-stark-js src/fflonk/helpers/fflonk_shkey.js (the
polDefs builder with its fixFIndex regrouping heuristic) and
fflonk_setup.js (constant-polynomial interpolation, extension and
commitment, x_n/x_ext tables).  The shplonk grouping itself is
protocol/shplonk.py.

Grouping semantics (fflonk_shkey.js:100-175): every opened polynomial is
keyed by (stage, opening-point set); each distinct key becomes one
composed commitment f_i.  Groups at a stage with fewer than `min_pols`
members whose key is {0} or {1} are widened to {0,1} and merged so tiny
commitments don't proliferate (fixFIndex, minPols=3).  The quotient Q is
always its own f at the final stage.
"""
from __future__ import annotations

from ..ops.fft_bn128 import FR, interpolate, intt, w
from ..protocol.shplonk import shplonk_commit, shplonk_setup
from .fr_ctx import fr_powers


def build_shkey(fflonk_info, ptau, max_q_degree=0):
    """fflonkShkey: group pols into composed commitments, run the shplonk
    setup.  Returns the zkey dict (without const commitments — see
    fflonk_setup)."""
    n_stages = fflonk_info["nStages"] + 1
    pil_power = fflonk_info["pilPower"]
    domain_size = 1 << pil_power

    ev_map = fflonk_info["evMap"]

    def openings_of(typ, pid):
        return sorted(
            {ev["prime"] for ev in ev_map if ev["type"] == typ and ev["id"] == pid}
        )

    # entries: (stage, name, degree, openings tuple), in map order
    entries = []
    for i, pol in enumerate(fflonk_info["constPolsMap"]):
        opens = openings_of("const", i)
        if not opens:
            continue
        entries.append({"stage": 0, "name": pol["name"], "degree": domain_size,
                        "opens": tuple(opens)})
    for i, pol in enumerate(fflonk_info["cmPolsMap"]):
        stage = pol["stage"]
        if stage == fflonk_info["nStages"] + 1:
            continue  # Q handled below
        opens = openings_of("cm", i)
        if not opens:
            continue
        entries.append({"stage": stage, "name": pol["name"],
                        "degree": domain_size + len(opens) + 1,
                        "opens": tuple(opens)})

    _fix_f_index(entries, min_pols=3)

    # assign fi indexes in scan order over (opening, entry) like
    # fixFIndex's final loop: per opening point, per polDef
    fi_names = {}
    fi_counter = 0
    for opening in fflonk_info["openingPoints"]:
        for e in entries:
            if opening not in e["opens"]:
                continue
            key = (e["stage"], e["opens"])
            if key not in fi_names:
                fi_names[key] = fi_counter
                fi_counter += 1

    pol_defs = {op: [] for op in fflonk_info["openingPoints"]}
    for e in entries:
        fi = fi_names[(e["stage"], e["opens"])]
        for op in e["opens"]:
            pol_defs[op].append(
                {"name": e["name"], "stage": e["stage"], "degree": e["degree"],
                 "fi": fi}
            )

    # quotient polynomial: always opened at 0, own commitment
    blind_coefs = fflonk_info["maxPolsOpenings"] * (fflonk_info["qDeg"] + 1)
    domain_size_q = fflonk_info["qDeg"] * domain_size + blind_coefs
    q_names = []
    if not max_q_degree or (domain_size_q - blind_coefs) <= max_q_degree * domain_size:
        max_q_degree = 0
        pol_defs[0].append({"name": "Q", "stage": n_stages,
                            "degree": domain_size_q, "fi": fi_counter})
        q_names = ["Q"]
    else:
        n_q = -(-(domain_size_q - blind_coefs) // (max_q_degree * domain_size))
        for i in range(n_q):
            degree = (domain_size_q - i * max_q_degree * domain_size
                      if i == n_q - 1 else max_q_degree * domain_size + 2)
            pol_defs[0].append({"name": f"Q{i}", "stage": n_stages,
                                "degree": degree, "fi": fi_counter + i})
            q_names.append(f"Q{i}")

    zkey = shplonk_setup({"power": pil_power, "polDefs": pol_defs}, ptau)
    zkey["maxQDegree"] = max_q_degree
    zkey["qNames"] = q_names
    zkey["nPublics"] = fflonk_info["nPublics"]
    zkey["primeR"] = FR
    return zkey


def _fix_f_index(entries, min_pols=3):
    """fixFIndex (fflonk_shkey.js:133-175): per stage, if the {0} or {1}
    opening groups are too small (< min_pols) and no {0,1} group forces a
    merge anyway, widen them to {0,1} (which raises the cm degree by one
    extra blinding slot)."""
    stages = sorted({e["stage"] for e in entries})
    for stage in stages:
        group_sizes = {}
        for e in entries:
            if e["stage"] == stage:
                group_sizes[e["opens"]] = group_sizes.get(e["opens"], 0) + 1
        if len(group_sizes) <= 1:
            continue
        if ((0, 1) not in group_sizes
                and group_sizes.get((0,), 0) >= min_pols
                and group_sizes.get((1,), 0) >= min_pols):
            continue
        for e in entries:
            if e["stage"] == stage and e["opens"] in ((0,), (1,)):
                e["opens"] = (0, 1)
                if stage != 0:
                    e["degree"] += 1


def fflonk_setup(const_pols, fflonk_info, ptau, max_q_degree=0, logger=None):
    """fflonkSetup (fflonk_setup.js:8-95): build the shkey, interpolate +
    extend the constant polynomials, commit stage 0.

    const_pols: (N, nConstants) column-major-agnostic nested list/array of
    Fr values.  Returns the full zkey (prover side; verification_key()
    extracts the public part).
    """
    zkey = build_shkey(fflonk_info, ptau, max_q_degree=max_q_degree)
    n_constants = fflonk_info["nConstants"]
    pil_power = fflonk_info["pilPower"]
    n = 1 << pil_power

    ext_bits = (fflonk_info["qDeg"]).bit_length() + fflonk_info["nBitsZK"]
    n_bits_ext = pil_power + ext_bits

    zkey["X_2"] = ptau["X_2"]

    evals_flat = []
    coefs_flat = []
    evals_ext_flat = []
    const_names = [p["name"] for p in fflonk_info["constPolsMap"]]
    pols = {}
    if n_constants:
        cols = [[int(const_pols[r][i]) % FR for r in range(n)]
                for i in range(n_constants)]
        for i, col in enumerate(cols):
            coefs = intt(col)
            pols[const_names[i]] = coefs
            ext = interpolate(col, pil_power, n_bits_ext, shift=1)
            evals_flat.append(col)
            coefs_flat.append(coefs)
            evals_ext_flat.append(ext)

        committed = shplonk_commit(0, zkey, pols, ptau)
        zkey["constCommits"] = {
            ent["index"]: {"commit": ent["commit"], "pol": ent["pol"]}
            for ent in committed
        }
    else:
        zkey["constCommits"] = {}

    # row-major interleaved storage (what FrProverCtx reshapes)
    zkey["constPolsEvals"] = [
        evals_flat[i][r] for r in range(n) for i in range(n_constants)
    ]
    zkey["constPolsCoefs"] = {name: pols[name] for name in pols}
    ext_n = 1 << n_bits_ext
    zkey["constPolsEvalsExt"] = [
        evals_ext_flat[i][r] for r in range(ext_n) for i in range(n_constants)
    ]
    zkey["x_n"] = fr_powers(w(pil_power), n)
    zkey["x_ext"] = fr_powers(w(n_bits_ext), ext_n)
    return zkey


def verification_key(zkey, fflonk_info):
    """Public verification key: f grouping, const commits, X_2
    (fflonk_verification_key.js)."""
    return {
        "protocol": "pilfflonk",
        "curve": "bn128",
        "power": zkey["power"],
        "powerW": zkey["powerW"],
        "f": zkey["f"],
        "maxQDegree": zkey["maxQDegree"],
        "qNames": zkey["qNames"],
        "X_2": zkey["X_2"],
        "nPublics": zkey["nPublics"],
        "constCommits": {k: v["commit"] for k, v in zkey["constCommits"].items()},
    }
