"""Stage/slot assignment for witness & fixed columns.

Mirrors pil2-stark-js src/pil_info/map.js: fills cmPolsMap/constPolsMap/
challengesMap/publicsMap, accumulates mapSectionsN (base-field column count
per stage section) and assigns (stageId, stagePos) to every witness symbol.
"""
from __future__ import annotations


def map_info(res, symbols, expressions, constraints, options=None):
    _map_symbols(res, symbols)
    _set_stage_info(res, symbols)
    res["nCommitmentsStage1"] = sum(
        1 for p in res["cmPolsMap"] if p and p["stage"] == 1 and not p.get("imPol")
    )
    _dedupe_names(res["cmPolsMap"])
    _dedupe_names(res["constPolsMap"])


def _dedupe_names(pols_map):
    """Intermediate polynomials are all created as `<Name>.ImPol`
    (imPolynomials.js:46 does the same).  The STARK side addresses columns
    by id so collisions are harmless there, but the fflonk tier keys its
    coefficient store and proof evaluations by NAME (fflonk_shkey.js:117,
    fflonk_prover_helpers.js) — make names unique here, once, so every
    downstream consumer agrees."""
    seen = {}
    for p in pols_map:
        if not p:
            continue
        n = p["name"]
        if n in seen:
            seen[n] += 1
            p["name"] = f"{n}_{seen[n]}"
        else:
            seen[n] = 0


def _set_map(lst, idx, value):
    while len(lst) <= idx:
        lst.append(None)
    lst[idx] = value


def _map_symbols(res, symbols):
    for symbol in symbols:
        t = symbol["type"]
        if t in ("witness", "fixed"):
            if t == "fixed":
                symbol["stageId"] = symbol["polId"]
            elif symbol.get("stage") in (None, 0):
                raise ValueError("Invalid witness stage")
            _add_pol(res, symbol)
        elif t == "challenge":
            _set_map(
                res["challengesMap"],
                symbol["id"],
                {
                    "name": symbol["name"],
                    "stage": symbol["stage"],
                    "dim": symbol["dim"],
                    "stageId": symbol["stageId"],
                },
            )
        elif t == "public":
            _set_map(
                res["publicsMap"],
                symbol["id"],
                {"name": symbol.get("name"), "stage": symbol["stage"]},
            )
        elif t == "subproofValue":
            _set_map(res["subproofValuesMap"], symbol["id"], {"name": symbol.get("name")})


def _add_pol(res, symbol):
    ref = res["constPolsMap"] if symbol["type"] == "fixed" else res["cmPolsMap"]
    pos = symbol["polId"]
    entry = {
        "stage": symbol["stage"],
        "name": symbol["name"],
        "dim": symbol["dim"],
        "polsMapId": pos,
    }
    if symbol.get("stageId") is not None and symbol["stageId"] >= 0:
        entry["stageId"] = symbol["stageId"]
    if symbol["type"] == "fixed":
        res["mapSectionsN"]["const"] += symbol["dim"]
    else:
        res["mapSectionsN"][f"cm{symbol['stage']}"] += symbol["dim"]
    if symbol.get("lengths"):
        entry["lengths"] = symbol["lengths"]
    if symbol.get("imPol"):
        entry["imPol"] = True
        entry["expId"] = symbol["expId"]
    _set_map(ref, pos, entry)


def _set_stage_info(res, symbols):
    q_stage = res["nStages"] + 1
    for symbol in symbols:
        if symbol["type"] != "witness":
            continue
        prev = [
            p
            for i, p in enumerate(res["cmPolsMap"])
            if p and p["stage"] == symbol["stage"] and i < symbol["polId"]
        ]
        symbol["stagePos"] = sum(p["dim"] for p in prev)
        res["cmPolsMap"][symbol["polId"]]["stagePos"] = symbol["stagePos"]
        if not symbol.get("stageId"):
            if symbol["stage"] == q_stage:
                stage_id = len(prev)
            else:
                same_stage = [
                    p for p in res["cmPolsMap"] if p and p["stage"] == symbol["stage"]
                ]
                stage_id = next(
                    i for i, p in enumerate(same_stage) if p["name"] == symbol["name"]
                )
            symbol["stageId"] = stage_id
            res["cmPolsMap"][symbol["polId"]]["stageId"] = stage_id
