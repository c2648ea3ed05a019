"""Fiat-Shamir transcript over Poseidon-GL — host code (tiny state).

Bit-exact port of the sponge protocol in
pil2-stark-js src/helpers/transcript/transcript.js: 4-element GL state,
absorb up to 8 pending elements then permute with nOuts=12; `get_field()`
squeezes 3 base elements (a cubic-extension challenge); `get_permutations`
extracts FRI query indices 63 bits per squeezed element (transcript.js:59-84).
As in the JAX package, each permutation runs on the host C++ runtime
(runtime/native.py; ``native.plain_hashing()`` swaps in the python-int
permutation it is held against).
"""
from __future__ import annotations

import numpy as np

from ..runtime import native


class Transcript:
    def __init__(self):
        self.state = [0, 0, 0, 0]
        self.pending: list[int] = []
        self.out: list[int] = []

    def put(self, a) -> None:
        if isinstance(a, (list, tuple, np.ndarray)):
            for x in a:
                self.put(x)
        else:
            self._add1(int(a))

    def _add1(self, a: int) -> None:
        self.out = []
        self.pending.append(a)
        if len(self.pending) == 8:
            self._update_state()

    def _update_state(self) -> None:
        while len(self.pending) < 8:
            self.pending.append(0)
        self.out = native.permute_int(self.pending + self.state)
        self.pending = []
        self.state = self.out[:4]

    def get_state(self):
        if self.pending:
            self._update_state()
        return list(self.state)

    def get_fields1(self) -> int:
        if not self.out:
            self._update_state()
        return self.out.pop(0)

    def get_field(self):
        """One cubic-extension challenge = 3 squeezed base elements."""
        return (self.get_fields1(), self.get_fields1(), self.get_fields1())

    def get_permutations(self, n: int, n_bits: int):
        """n query indices of n_bits each, 63 usable bits per element."""
        total_bits = n * n_bits
        n_fields = (total_bits - 1) // 63 + 1
        fields = [self.get_fields1() for _ in range(n_fields)]
        res = []
        cur_field = 0
        cur_bit = 0
        for _ in range(n):
            a = 0
            for j in range(n_bits):
                if (fields[cur_field] >> cur_bit) & 1:
                    a += 1 << j
                cur_bit += 1
                if cur_bit == 63:
                    cur_bit = 0
                    cur_field += 1
            res.append(a)
        return res
