"""Fiat-Shamir transcript over Poseidon-BN254 (the recursion tier).

Host copy of pil2_stark_tpu/hash/transcript_bn128.py, itself pil2-stark-js
src/helpers/transcript/transcript.bn128.js: a one-Fr state; up to nInputs
(16 by default) pending elements are absorbed by poseidon(pending, state,
nInputs + 1); a GL challenge takes three 64-bit limbs of each 253-bit
output, query indices 253 usable bits of each.
"""
from __future__ import annotations

from . import poseidon_bn128


class TranscriptBN128:
    def __init__(self, n_inputs: int = 16, custom: bool = False):
        self.n_inputs = n_inputs
        self.custom = custom
        self.state = 0
        self.pending: list[int] = []
        self.out: list[int] = []
        self.out3: list[int] = []

    def put(self, a) -> None:
        if isinstance(a, (list, tuple)):
            for x in a:
                self.put(x)
        else:
            self._add1(int(a))

    def _add1(self, a: int) -> None:
        self.out = []
        self.pending.append(a % poseidon_bn128.P)
        if len(self.pending) == self.n_inputs:
            self._update_state()

    def _update_state(self) -> None:
        while len(self.pending) < self.n_inputs:
            self.pending.append(0)
        self.out = poseidon_bn128.poseidon(self.pending, self.state, self.n_inputs + 1,
                                           custom=self.custom)
        self.out3 = []
        self.pending = []
        self.state = self.out[0]

    def get_state(self) -> int:
        if self.pending:
            self._update_state()
        return self.state

    def get_fields1(self) -> int:
        if self.out3:
            return self.out3.pop(0)
        if self.out:
            v = self.out.pop(0)
            self.out3 = [v & 0xFFFFFFFFFFFFFFFF, (v >> 64) & 0xFFFFFFFFFFFFFFFF,
                         (v >> 128) & 0xFFFFFFFFFFFFFFFF]
            return self.get_fields1()
        self._update_state()
        return self.get_fields1()

    def get_field(self):
        return (self.get_fields1(), self.get_fields1(), self.get_fields1())

    def get_fields253(self) -> int:
        if self.out:
            return self.out.pop(0)
        self._update_state()
        return self.get_fields253()

    def get_permutations(self, n: int, n_bits: int):
        n_fields = (n * n_bits - 1) // 253 + 1
        fields = [self.get_fields253() for _ in range(n_fields)]
        res = []
        cur_field = 0
        cur_bit = 0
        for _ in range(n):
            a = 0
            for j in range(n_bits):
                if (fields[cur_field] >> cur_bit) & 1:
                    a += 1 << j
                cur_bit += 1
                if cur_bit == 253:
                    cur_bit = 0
                    cur_field += 1
            res.append(a)
        return res
