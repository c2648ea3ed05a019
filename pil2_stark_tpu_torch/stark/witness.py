"""Named fixed/witness column helpers.

Counterpart of pil2-stark-js src/witness/witnessCalculator.js
(generateFixedCols/generateWtnsCols): builds name-addressable numpy column
views over the (N, nPols) buffers, so state-machine witness generators can
write `pols.Namespace.name[i] = v` style.
"""
from __future__ import annotations

import numpy as np


class Namespace:
    def __init__(self):
        self._cols = {}

    def __getattr__(self, name):
        try:
            return self.__dict__["_cols"][name]
        except KeyError:
            raise AttributeError(name)

    def add(self, name, col):
        self._cols[name] = col


class Cols:
    """Column collection over a single backing buffer (N, width)."""

    def __init__(self, references: dict, n: int, kind: str):
        ref_type = "constP" if kind == "fixed" else "cmP"
        refs = [
            (name, r) for name, r in references.items() if r["type"] == ref_type
        ]
        refs.sort(key=lambda kv: kv[1]["id"])
        width = sum(r.get("len", 1) for _, r in refs)
        self.buffer = np.zeros((n, width), dtype=np.uint64)
        self.n = n
        self.namespaces = {}
        for name, r in refs:
            ns_name, pol_name = name.split(".", 1)
            ns = self.namespaces.setdefault(ns_name, Namespace())
            if r.get("isArray"):
                ns.add(
                    pol_name,
                    [self.buffer[:, r["id"] + k] for k in range(r["len"])],
                )
            else:
                ns.add(pol_name, self.buffer[:, r["id"]])

    def __getattr__(self, name):
        try:
            return self.__dict__["namespaces"][name]
        except KeyError:
            raise AttributeError(name)


def generate_fixed_cols(references: dict, n: int) -> Cols:
    return Cols(references, n, "fixed")


def generate_wtns_cols(references: dict, n: int) -> Cols:
    return Cols(references, n, "witness")
