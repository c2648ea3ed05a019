"""Expression AST node builders — the compiler's IR vocabulary.

Nodes are plain dicts, mirroring the shape used throughout the reference's
setup pipeline (pil2-stark-js src/pil_info/expressionops.js): binary ops
{op: add|sub|mul, values: [a, b]} over leaves cm/const/exp/challenge/public/
number/eval/xDivXSubXi/Zi/x/q/f.  Keeping dict-shaped nodes (rather than
classes) makes the starkinfo/expressionsinfo artifacts directly
JSON-serializable for cross-checking against reference artifacts.
"""
from __future__ import annotations


def add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return {"op": "add", "values": [a, b]}


def sub(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return {"op": "sub", "values": [a, b]}


def mul(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return {"op": "mul", "values": [a, b]}


def neg(a):
    return {"op": "neg", "values": [a]}


def exp(expr_id: int, row_offset: int = 0, stage=None):
    return {"op": "exp", "id": expr_id, "rowOffset": row_offset, "stage": stage}


def cm(pol_id: int, row_offset: int = 0, stage: int = 1, dim: int = 1):
    if stage is None:
        raise ValueError(f"Stage not defined for cm {pol_id}")
    return {"op": "cm", "id": pol_id, "stage": stage, "dim": dim, "rowOffset": row_offset}


def const(pol_id: int, row_offset: int = 0, stage: int = 0, dim: int = 1):
    if stage != 0:
        raise ValueError("Const must be declared in stage 0")
    return {"op": "const", "id": pol_id, "rowOffset": row_offset, "dim": dim, "stage": stage}


def challenge(name: str, stage: int, dim: int, stage_id: int, cid: int):
    return {
        "op": "challenge",
        "name": name,
        "stageId": stage_id,
        "id": cid,
        "stage": stage,
        "dim": dim,
    }


def number(n) -> dict:
    return {"op": "number", "value": str(n)}


def public(pub_id: int):
    return {"op": "public", "id": pub_id}


def eval_(eval_id: int, dim: int):
    return {"op": "eval", "id": eval_id, "dim": dim}


def x_div_x_sub_xi(opening: int, idx: int):
    return {"op": "xDivXSubXi", "opening": opening, "id": idx}


def zi(boundary_id: int):
    return {"op": "Zi", "boundaryId": boundary_id}


def x():
    return {"op": "x"}


def q(q_dim: int):
    return {"op": "q", "id": 0, "dim": q_dim}


def f():
    return {"op": "f", "id": 0, "dim": 3}


def by_type(kind: str, *args, **kwargs):
    """Dispatch used when rebuilding nodes from evMap entries."""
    return {"cm": cm, "const": const}[kind](*args, **kwargs)
