"""Pil-fflonk zkey binary file — the reference's setup artifact format.

Byte-layout counterpart of pil2-stark-js src/fflonk/zkey/zkey_pilfflonk.js
(sections per zkey_pilfflonk_constants.js): an iden3 "zkey" binfile with
protocol id 12 and sections

  1  zkey header        ULE32 protocol id (12 = pil-fflonk)
  2  pil-fflonk header  n8q+q, n8r+r, power, powerW, nPublics, maxQDegree,
                        X_2 (G2, 128 bytes)
  3  f                  composed-commitment grouping descriptors
  4  f commitments      stage-0 (const) commitments + coefficient buffers
  5  polsNamesStage     per-stage polynomial name lists
  6/7/8                 const pols evals / coefs / extended evals (Fr)
  9/10                  x_n / x_ext domain points (Fr)
  11 omegas             named roots of unity ("w<c>" keys)
  12 ptau               powers-of-tau G1 buffer

Field/point encodings follow ffjavascript's buffer conventions: Fr and Fq
values inside buffers are little-endian Montgomery form (v·2^256 mod p);
the header primes are plain little-endian (writeBigInt).  G1 points are
64-byte X||Y, G2 128-byte X.c0||X.c1||Y.c0||Y.c1, infinity all-zero.

The omegas section's key set comes from the external shplonkjs setup in
the reference; here it carries "w<c>" = the c-th root of unity for every
composition arity c used by an f entry (the values this framework's
shplonk layer derives on the fly), matching the ^w\\d pattern the
reference readers filter on.
"""
from __future__ import annotations

import struct

from ..curve.bn254 import Q as _FQ
from ..utils import binfile
from ..ops.fft_bn128 import FR

ZKEY_MAGIC = b"zkey"
PILFFLONK_PROTOCOL_ID = 12
_S_PROTO, _S_HEADER, _S_F, _S_FCOMMIT = 1, 2, 3, 4
_S_POLSNAMES, _S_EVALS, _S_COEFS, _S_EVALS_EXT = 5, 6, 7, 8
_S_XN, _S_XEXT, _S_OMEGAS, _S_PTAU = 9, 10, 11, 12

_R_MONT = 1 << 256


def _mont_fr(v: int) -> bytes:
    return (int(v) % FR * _R_MONT % FR).to_bytes(32, "little")


def _unmont_fr(b: bytes) -> int:
    return int.from_bytes(b, "little") * pow(_R_MONT, FR - 2, FR) % FR


def _mont_fq(v: int) -> bytes:
    return (int(v) % _FQ * _R_MONT % _FQ).to_bytes(32, "little")


_FQ_RINV = None


def _unmont_fq(b: bytes) -> int:
    global _FQ_RINV
    if _FQ_RINV is None:
        _FQ_RINV = pow(_R_MONT, _FQ - 2, _FQ)
    return int.from_bytes(b, "little") * _FQ_RINV % _FQ


def _g1_bytes(p) -> bytes:
    if p is None:
        return bytes(64)
    return _mont_fq(p[0]) + _mont_fq(p[1])


def _g1_from(b: bytes):
    if b == bytes(64):
        return None
    return (_unmont_fq(b[:32]), _unmont_fq(b[32:64]))


def _g2_bytes(p) -> bytes:
    if p is None:
        return bytes(128)
    (x0, x1), (y0, y1) = p
    return _mont_fq(x0) + _mont_fq(x1) + _mont_fq(y0) + _mont_fq(y1)


def _g2_from(b: bytes):
    if b == bytes(128):
        return None
    return ((_unmont_fq(b[:32]), _unmont_fq(b[32:64])),
            (_unmont_fq(b[64:96]), _unmont_fq(b[96:128])))


def _cstr(s: str) -> bytes:
    return s.encode() + b"\0"


def _read_cstr(buf: bytes, pos: int):
    end = buf.index(b"\0", pos)
    return buf[pos:end].decode(), end + 1


def _fr_buf(values) -> bytes:
    return b"".join(_mont_fr(v) for v in values)


def _fr_list(buf: bytes) -> list:
    return [_unmont_fr(buf[i:i + 32]) for i in range(0, len(buf), 32)]


# ---------------------------------------------------------------------------


def _f_section(f_entries) -> bytes:
    out = bytearray(struct.pack("<I", len(f_entries)))
    for fi in f_entries:
        out += struct.pack("<II", fi["index"], fi["composedLen"])
        out += struct.pack("<I", len(fi["openingPoints"]))
        for op in fi["openingPoints"]:
            out += struct.pack("<I", op)
        out += struct.pack("<I", len(fi["pols"]))
        for name in fi["pols"]:
            out += _cstr(name)
        out += struct.pack("<I", len(fi["stages"]))
        for st in fi["stages"]:
            out += struct.pack("<II", st["stage"], len(st["pols"]))
            for name in st["pols"]:
                out += _cstr(name)
                out += struct.pack("<I", fi["polDegrees"][name])
    return bytes(out)


def _parse_f_section(buf: bytes):
    (n,) = struct.unpack_from("<I", buf, 0)
    pos = 4
    f = [None] * n
    for _ in range(n):
        index, degree = struct.unpack_from("<II", buf, pos)
        pos += 8
        (n_op,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        opens = list(struct.unpack_from(f"<{n_op}I", buf, pos))
        pos += 4 * n_op
        (n_pols,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        pols = []
        for _ in range(n_pols):
            name, pos = _read_cstr(buf, pos)
            pols.append(name)
        (n_st,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        stages, pol_degrees = [], {}
        for _ in range(n_st):
            stage, n_sp = struct.unpack_from("<II", buf, pos)
            pos += 8
            spols = []
            for _ in range(n_sp):
                name, pos = _read_cstr(buf, pos)
                (deg,) = struct.unpack_from("<I", buf, pos)
                pos += 4
                spols.append(name)
                pol_degrees[name] = deg
            stages.append({"stage": stage, "pols": spols})
        c = 1 << max(0, (len(pols) - 1).bit_length())
        f[index] = {
            "index": index, "pols": pols, "polDegrees": pol_degrees,
            "stages": stages, "openingPoints": opens, "c": c,
            "composedLen": degree,
        }
    return f


def write_zkey(path: str, zkey: dict, ptau: dict) -> None:
    """zkey: the dict produced by fflonk.shkey.fflonk_setup; ptau: the
    powers-of-tau dict ({g1: [G1...], X_2: G2})."""
    header = struct.pack("<I", 32) + _FQ.to_bytes(32, "little")
    header += struct.pack("<I", 32) + FR.to_bytes(32, "little")
    header += struct.pack(
        "<IIII", zkey["power"], zkey["powerW"], zkey["nPublics"],
        zkey["maxQDegree"],
    )
    header += _g2_bytes(zkey["X_2"])

    fcommit = bytearray(struct.pack("<I", len(zkey["constCommits"])))
    for idx in sorted(zkey["constCommits"]):
        ent = zkey["constCommits"][idx]
        pol_buf = _fr_buf(ent["pol"])
        fcommit += _cstr(str(idx))
        fcommit += _g1_bytes(ent["commit"])
        fcommit += struct.pack("<I", len(pol_buf))
        fcommit += pol_buf

    # per-stage name lists: stage 0 = consts (from the f grouping); later
    # stages from the f stage entries, in f-index order
    stages_names: dict[int, list] = {}
    for fi in zkey["f"]:
        for st in fi["stages"]:
            lst = stages_names.setdefault(st["stage"], [])
            for name in st["pols"]:
                if name not in lst:
                    lst.append(name)
    polsnames = bytearray(struct.pack("<I", len(stages_names)))
    for stage in sorted(stages_names):
        polsnames += struct.pack("<II", stage, len(stages_names[stage]))
        for name in stages_names[stage]:
            polsnames += _cstr(name)

    coefs_names = stages_names.get(0, [])
    coefs_cols = [zkey["constPolsCoefs"][n] for n in coefs_names]
    max_len = max((len(c) for c in coefs_cols), default=0)
    coefs_flat = [
        coefs_cols[i][r] if r < len(coefs_cols[i]) else 0
        for r in range(max_len) for i in range(len(coefs_cols))
    ]

    omegas = bytearray()
    from ..ops.fft_bn128 import w as _fr_w  # root-of-unity chain

    cs = sorted({fi["c"] for fi in zkey["f"]})
    omegas += struct.pack("<I", len(cs))
    for c in cs:
        omegas += _cstr(f"w{c}")
        omegas += _mont_fr(_fr_w(max(0, (c - 1).bit_length())))

    binfile.write_bin_file(path, ZKEY_MAGIC, 1, [
        (_S_PROTO, struct.pack("<I", PILFFLONK_PROTOCOL_ID)),
        (_S_HEADER, header),
        (_S_F, _f_section(zkey["f"])),
        (_S_FCOMMIT, bytes(fcommit)),
        (_S_POLSNAMES, bytes(polsnames)),
        (_S_EVALS, _fr_buf(zkey["constPolsEvals"])),
        (_S_COEFS, _fr_buf(coefs_flat)),
        (_S_EVALS_EXT, _fr_buf(zkey["constPolsEvalsExt"])),
        (_S_XN, _fr_buf(zkey["x_n"])),
        (_S_XEXT, _fr_buf(zkey["x_ext"])),
        (_S_OMEGAS, bytes(omegas)),
        (_S_PTAU, b"".join(_g1_bytes(p) for p in ptau["g1"])),
    ])


def read_zkey(path: str, vk_only: bool = False):
    """-> (zkey dict in this framework's shape, ptau dict).  vk_only skips
    the large prover-side sections (readPilFflonkZkeyFile's vk option)."""
    magic, _, sections = binfile.read_bin_file(path, ZKEY_MAGIC)
    (proto,) = struct.unpack_from("<I", sections[_S_PROTO], 0)
    if proto != PILFFLONK_PROTOCOL_ID:
        raise ValueError(f"{path}: protocol id {proto}, expected "
                         f"{PILFFLONK_PROTOCOL_ID} (pil-fflonk)")
    h = sections[_S_HEADER]
    (n8q,) = struct.unpack_from("<I", h, 0)
    q = int.from_bytes(h[4:4 + n8q], "little")
    pos = 4 + n8q
    (n8r,) = struct.unpack_from("<I", h, pos)
    r = int.from_bytes(h[pos + 4:pos + 4 + n8r], "little")
    pos += 4 + n8r
    power, power_w, n_publics, max_q_degree = struct.unpack_from(
        "<IIII", h, pos)
    pos += 16
    x_2 = _g2_from(h[pos:pos + 128])
    if q != _FQ or r != FR:
        raise ValueError(f"{path}: unexpected curve primes (not bn128)")

    f = _parse_f_section(sections[_S_F])

    fc = sections[_S_FCOMMIT]
    (n_fc,) = struct.unpack_from("<I", fc, 0)
    pos = 4
    const_commits = {}
    for _ in range(n_fc):
        name, pos = _read_cstr(fc, pos)
        commit = _g1_from(fc[pos:pos + 64])
        pos += 64
        (blen,) = struct.unpack_from("<I", fc, pos)
        pos += 4
        pol = _fr_list(fc[pos:pos + blen])
        pos += blen
        const_commits[name] = {"commit": commit, "pol": pol}

    pn = sections[_S_POLSNAMES]
    (n_st,) = struct.unpack_from("<I", pn, 0)
    pos = 4
    pols_names_stage = {}
    for _ in range(n_st):
        stage, n_names = struct.unpack_from("<II", pn, pos)
        pos += 8
        names = []
        for _ in range(n_names):
            name, pos = _read_cstr(pn, pos)
            names.append(name)
        pols_names_stage[stage] = names

    om = sections[_S_OMEGAS]
    (n_om,) = struct.unpack_from("<I", om, 0)
    pos = 4
    omegas = {}
    for _ in range(n_om):
        name, pos = _read_cstr(om, pos)
        omegas[name] = _unmont_fr(om[pos:pos + 32])
        pos += 32

    q_names = [n for n in pols_names_stage.get(max(pols_names_stage or [0]), [])
               if n == "Q" or (n.startswith("Q") and n[1:].isdigit())]

    zkey = {
        "power": power, "powerW": power_w, "nPublics": n_publics,
        "maxQDegree": max_q_degree, "X_2": x_2, "f": f,
        "constCommits": const_commits, "polsNamesStage": pols_names_stage,
        "omegas": omegas, "qNames": q_names, "primeR": FR,
    }
    ptau = {"X_2": x_2}
    if not vk_only:
        zkey["constPolsEvals"] = _fr_list(sections[_S_EVALS])
        zkey["constPolsEvalsExt"] = _fr_list(sections[_S_EVALS_EXT])
        zkey["x_n"] = _fr_list(sections[_S_XN])
        zkey["x_ext"] = _fr_list(sections[_S_XEXT])
        coefs_flat = _fr_list(sections[_S_COEFS])
        const_names = pols_names_stage.get(0, [])
        nc = len(const_names)
        zkey["constPolsCoefs"] = {
            name: coefs_flat[i::nc] for i, name in enumerate(const_names)
        } if nc else {}
        pt = sections[_S_PTAU]
        ptau["g1"] = [_g1_from(pt[i:i + 64]) for i in range(0, len(pt), 64)]
    return zkey, ptau
