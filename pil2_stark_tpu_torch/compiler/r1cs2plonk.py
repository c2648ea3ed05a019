"""R1CS → PlonK gate decomposition (recursion/compressor front-end).

Mirrors pil2-stark-js src/r1cs2plonk.js:3-151: each R1CS constraint
A·B = C (linear combinations) becomes plonk gates (qm,ql,qr,qo,qc) over at
most 3 wires, with long linear combinations folded through addition-chain
helper gates recorded as plonkAdditions [sl, sr, kl, kr] (so = kl·sl+kr·sr).

Field-generic (prime passed in): the compressor tier uses Goldilocks, the
final tier BN254.
"""
from __future__ import annotations


def r1cs2plonk(prime: int, constraints, n_vars: int):
    """constraints: list of (lcA, lcB, lcC), each lc a dict {signal: coef}.
    Returns (plonk_constraints, plonk_additions, n_vars)."""
    p = prime
    plonk_constraints = []
    plonk_additions = []
    state = {"n_vars": n_vars}

    def normalize(lc):
        for s in [s for s, v in lc.items() if v % p == 0]:
            del lc[s]

    def join(lc1, k, lc2):
        res = {}
        for s, v in lc1.items():
            res[s] = (k * v) % p
        for s, v in lc2.items():
            res[s] = (res.get(s, 0) + v) % p
        normalize(res)
        return res

    def reduce_coefs(lc, max_c):
        k = 0
        cs = []
        for s, v in lc.items():
            if int(s) == 0:
                k = (k + v) % p
            elif v % p != 0:
                cs.append([int(s), v % p])
        while len(cs) > max_c:
            c1 = cs.pop(0)
            c2 = cs.pop(0)
            so = state["n_vars"]
            state["n_vars"] += 1
            plonk_constraints.append(
                [c1[0], c2[0], so, 0, (-c1[1]) % p, (-c2[1]) % p, 1, 0]
            )
            plonk_additions.append([c1[0], c2[0], c1[1], c2[1]])
            cs.append([so, 1])
        s_list = [c[0] for c in cs]
        coefs = [c[1] for c in cs]
        while len(coefs) < max_c:
            s_list.append(0)
            coefs.append(0)
        return k, s_list, coefs

    def add_constraint_sum(lc):
        k, s, coefs = reduce_coefs(lc, 3)
        plonk_constraints.append(
            [s[0], s[1], s[2], 0, coefs[0], coefs[1], coefs[2], k]
        )

    def add_constraint_mul(lc_a, lc_b, lc_c):
        ka, sa, ca = reduce_coefs(lc_a, 1)
        kb, sb, cb = reduce_coefs(lc_b, 1)
        kc, sc, cc = reduce_coefs(lc_c, 1)
        plonk_constraints.append(
            [
                sa[0],
                sb[0],
                sc[0],
                (ca[0] * cb[0]) % p,
                (ca[0] * kb) % p,
                (ka * cb[0]) % p,
                (-cc[0]) % p,
                (ka * kb - kc) % p,
            ]
        )

    def lc_type(lc):
        k = 0
        n = 0
        for s in list(lc.keys()):
            if lc[s] % p == 0:
                del lc[s]
            elif int(s) == 0:
                k = (k + lc[s]) % p
            else:
                n += 1
        if n > 0:
            return str(n)
        if k != 0:
            return "k"
        return "0"

    for lc_a, lc_b, lc_c in constraints:
        lc_a = {int(s): v % p for s, v in lc_a.items()}
        lc_b = {int(s): v % p for s, v in lc_b.items()}
        lc_c = {int(s): v % p for s, v in lc_c.items()}
        ta = lc_type(lc_a)
        tb = lc_type(lc_b)
        if ta == "0" or tb == "0":
            normalize(lc_c)
            add_constraint_sum(lc_c)
        elif ta == "k":
            add_constraint_sum(join(lc_b, lc_a[0], lc_c))
        elif tb == "k":
            add_constraint_sum(join(lc_a, lc_b[0], lc_c))
        else:
            add_constraint_mul(lc_a, lc_b, lc_c)

    return plonk_constraints, plonk_additions, state["n_vars"]
