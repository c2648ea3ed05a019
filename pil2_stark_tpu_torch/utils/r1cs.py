"""R1CS binary file reader (iden3 .r1cs format).

The recursion tier consumes circom-compiled verifier circuits: the
compressor setup reads the circuit's R1CS and converts it to a PIL machine
(cf. pil2-stark-js src/compressor/compressor12_setup.js which uses the
external r1csfile package).  Format: magic "r1cs", version, sections
(1 = header with field prime/wire counts, 2 = constraints as per-LC coefficient
lists, 3 = wire-to-label map).
"""
from __future__ import annotations

import dataclasses
import struct


@dataclasses.dataclass
class R1CS:
    prime: int
    n_vars: int
    n_outputs: int
    n_pub_inputs: int
    n_prv_inputs: int
    n_labels: int
    n_constraints: int
    constraints: list  # [(lcA, lcB, lcC)] dicts {wire: coef}
    wire2label: list


def read_r1cs(path: str) -> R1CS:
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"r1cs":
        raise ValueError("Not an r1cs file")
    (version,) = struct.unpack_from("<I", data, 4)
    (n_sections,) = struct.unpack_from("<I", data, 8)
    pos = 12
    sections = {}
    for _ in range(n_sections):
        (stype,) = struct.unpack_from("<I", data, pos)
        (size,) = struct.unpack_from("<Q", data, pos + 4)
        sections[stype] = (pos + 12, size)
        pos += 12 + size

    # header
    hpos, _ = sections[1]
    (n8,) = struct.unpack_from("<I", data, hpos)
    prime = int.from_bytes(data[hpos + 4 : hpos + 4 + n8], "little")
    (
        n_vars,
        n_outputs,
        n_pub_inputs,
        n_prv_inputs,
    ) = struct.unpack_from("<IIII", data, hpos + 4 + n8)
    (n_labels,) = struct.unpack_from("<Q", data, hpos + 20 + n8)
    (n_constraints,) = struct.unpack_from("<I", data, hpos + 28 + n8)

    # constraints
    constraints = []
    cpos, csize = sections[2]
    pos = cpos
    end = cpos + csize
    for _ in range(n_constraints):
        lcs = []
        for _ in range(3):
            (n_coefs,) = struct.unpack_from("<I", data, pos)
            pos += 4
            lc = {}
            for _ in range(n_coefs):
                (wire,) = struct.unpack_from("<I", data, pos)
                coef = int.from_bytes(data[pos + 4 : pos + 4 + n8], "little")
                lc[wire] = coef
                pos += 4 + n8
            lcs.append(lc)
        constraints.append(tuple(lcs))
    assert pos <= end

    wire2label = []
    if 3 in sections:
        wpos, wsize = sections[3]
        n_entries = wsize // 8
        wire2label = list(struct.unpack_from(f"<{n_entries}Q", data, wpos))

    return R1CS(
        prime=prime,
        n_vars=n_vars,
        n_outputs=n_outputs,
        n_pub_inputs=n_pub_inputs,
        n_prv_inputs=n_prv_inputs,
        n_labels=n_labels,
        n_constraints=n_constraints,
        constraints=constraints,
        wire2label=wire2label,
    )
