"""CLI of the PyTorch/CUDA port: the core subcommands of
pil2_stark_tpu/__main__.py, themselves the counterparts of pil2-stark-js's
src/main_*.js entry points:

  genstarkinfo     PIL + starkstruct -> starkinfo/expressionsinfo/verifierinfo
  preparepil       PIL + starkstruct -> prepared-pil summary (split pipeline)
  genpilcode       PIL + starkstruct -> TAC code artifacts only
  calculateimpols  report the im-pols selection (heuristic vs optimal)
  buildconsttree   const pols -> const tree file + verification key
  prove            setup artifacts + witness -> proof.json / zkin.json / publics
  verify           proof + verkey -> accept (exit 0) / reject (exit 1)
  pilverify        debug constraint check of a witness (no commitments)
  buildchelpers    PIL + starkstruct -> .chelpers.bin (binary TAC streams)

The Goldilocks recursion tier (main_pil2circom.js,
compressor/main_compressor_setup.js, compressor/main_compressor_exec.js):

  pil2circom       starkinfo + verkey -> verifier circuit files
  compressor-setup circuit + zkin -> C12/C18 pil/const/exec/witness files
  compressor-exec  exec + witness -> committed-polynomial buffer + publics

so a proof is verified inside a C12 or C18 machine that `prove
--pil-json/--const/--commit/--publics` proves.  The BN128 tier
(final/main_final_setup.js, main_final_exec.js, fflonk/main_*.js):

  final-setup      circuit over BN254-Fr + inputs -> final9/final6/finalfflonk
                   pil/const/exec/witness files
  final-exec       exec + witness -> Fr committed buffer + publics
  fflonkinfo       PIL -> fflonkinfo/expressionsinfo/verifierinfo (Fr)
  fflonk-setup     constants + fflonkinfo -> zkey, powers of tau, verification key
  fflonk-prove     zkey + committed buffer -> fflonk proof + publics
  fflonk-chelpers  fflonkinfo -> .fflonkchelpers.bin (flattened stage TACs)
  fflonk-verify    verification key + proof -> accept (exit 0) / reject (exit 1)

Every file equals the JAX package's for the same arguments.  ``--device``
takes the place of the JAX CLI's ``--backend``: by default the card
(``prove``, ``buildconsttree`` and ``pilverify`` raise when there is none),
``--device cpu`` runs the kernels' plain versions.  ``buildconsttree``
extends and Merkelizes on the device, as stark.setup.load_setup does.
``pil2circom`` sends a BN128 starkinfo to the BN128 circuit, as the JAX
CLI does; as there, a verkey file holds no BN128 root, so that call fails
and the BN128 circuit is emitted through the library.  The export
subcommands (exportverificationkey, exportsolidityverifier,
exportcalldata) are not ported yet.

Artifact containers are the JAX package's own formats (.npy for u64
buffers, JSON with stringified big ints, the PSTC consts container).

Example (the bundled fibonacci model, on the card):

  python -m pil2_stark_tpu_torch prove --model fibonacci --tmp /tmp/fib
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import sys

import numpy as np


def _compile_pil(args):
    from .compiler import pil1_parser

    if getattr(args, "pilout", None):
        from .compiler import pil2_frontend

        pilout = pil2_frontend.load_pilout(args.pilout)
        pil = pil2_frontend.select_air(
            pilout, int(args.subproof_id or 0), int(args.air_id or 0)
        )
        return pil, True
    if args.model:
        from .models import fibonacci

        assert args.model == "fibonacci", "bundled models: fibonacci"
        pil = pil1_parser.compile_pil_source(fibonacci.pil_source(args.nbits or 6))
        pil["name"] = "Fibonacci"
    else:
        pil = pil1_parser.compile_pil(args.pil)
        pil["name"] = os.path.splitext(os.path.basename(args.pil))[0]
    return pil, False


def _stark_struct(args, default=None):
    if args.starkstruct:
        with open(args.starkstruct) as f:
            return json.load(f)
    if default is not None:
        return copy.deepcopy(default)
    raise SystemExit("--starkstruct required")


def _fibonacci(n_bits, inputs=None):
    """(pil, fixed columns, witness columns, publics) of the bundled model."""
    from .compiler import pil1_parser
    from .models import fibonacci

    pil = pil1_parser.compile_pil_source(fibonacci.pil_source(n_bits))
    pil["name"] = "Fibonacci"
    const_cols, cm_cols, publics = fibonacci.build(pil["references"], 1 << n_bits,
                                                   list(inputs or [1, 2]))
    return pil, const_cols.buffer, cm_cols.buffer, publics


def _load_machine(args):
    """(pil, fixed columns, witness columns, publics) of the file-based
    path: any machine given as pil JSON and .npy buffers."""
    from .utils import serialization

    pil = serialization.load_json(args.pil_json)
    publics = [int(x) for x in serialization.load_json(args.publics)] if args.publics else []
    return pil, np.load(args.const), np.load(args.commit), publics


def cmd_genstarkinfo(args):
    from .compiler.pilinfo import pil_info
    from .utils import serialization

    pil, pil2 = _compile_pil(args)
    ss = _stark_struct(args)
    out = pil_info(pil, stark=True, stark_struct=ss, pil2=pil2)
    serialization.dump_json(out["pilInfo"], args.starkinfo)
    serialization.dump_json(out["expressionsInfo"], args.expressionsinfo)
    serialization.dump_json(out["verifierInfo"], args.verifierinfo)
    print(f"wrote {args.starkinfo}, {args.expressionsinfo}, {args.verifierinfo}")


def cmd_buildchelpers(args):
    """main_buildchelpers.js: emit the .chelpers.bin artifact (binary TAC
    streams for pil2-stark-js's external C++ prover)."""
    from .compiler.chelpers_bin import write_chelpers_file
    from .compiler.pilinfo import pil_info

    pil, pil2 = _compile_pil(args)
    ss = _stark_struct(args)
    out = pil_info(pil, stark=True, stark_struct=ss, pil2=pil2)
    built = write_chelpers_file(args.chelpers, out["pilInfo"],
                                out["expressionsInfo"])
    print(f"wrote {args.chelpers} ({len(built['opsUsed'])} ops used, "
          f"{len(built['expsInfo'])} expressions, "
          f"{len(built['constraintsInfo'])} constraints)")


def cmd_prove(args):
    from .models import fibonacci
    from .stark import prover, setup
    from .utils import proof2zkin, serialization

    tmp = args.tmp
    os.makedirs(tmp, exist_ok=True)

    if args.model == "fibonacci":
        n_bits = args.nbits or 6
        pil, const_buffer, cm_buffer, publics = _fibonacci(n_bits, args.inputs)
        ss = _stark_struct(args, fibonacci.STARK_STRUCT if n_bits == 6 else None)
    elif args.pil_json and args.const and args.commit:
        # file-based path: prove any machine (main_prover.js)
        pil, const_buffer, cm_buffer, publics = _load_machine(args)
        ss = _stark_struct(args)
    else:
        raise SystemExit("pass --model, or --pil-json/--const/--commit")

    s = setup.stark_setup(const_buffer, pil, ss, device=args.device)
    res = prover.prove(
        s["starkInfo"], s["expressionsInfo"], const_buffer, s["constTree"],
        (cm_buffer, publics), device=args.device, profile_dir=args.profile_dir,
    )

    serialization.dump_proof(res["proof"], os.path.join(tmp, "proof.json"))
    serialization.dump_json(
        [str(int(p)) for p in res["publics"]], os.path.join(tmp, "publics.json")
    )
    zkin = proof2zkin.proof2zkin(res["proof"], s["starkInfo"])
    zkin["publics"] = [int(p) for p in res["publics"]]
    serialization.dump_json(
        json.loads(json.dumps(zkin, default=str)), os.path.join(tmp, "zkin.json")
    )
    serialization.dump_verkey(s["constRoot"], os.path.join(tmp, "verkey.json"))
    serialization.dump_json(s["starkInfo"], os.path.join(tmp, "starkinfo.json"))
    serialization.dump_json(s["verifierInfo"], os.path.join(tmp, "verifierinfo.json"))
    print(f"proof written to {tmp}/proof.json; verified inputs: {publics}")


def cmd_buildconsttree(args):
    """main_buildconsttree.js: const pols -> extended consts + tree file +
    verification key.  The LDE and the GL tree are built on the device
    (stark.setup.const_tree), then copied to the host once
    (stark.device.to_host_tree) and written from there."""
    from .field import gl64
    from .hash import merkle
    from .hash.mh import MerkleHashGL
    from .stark import context, setup
    from .stark import device as dev
    from .utils import binfile, serialization

    ss = _stark_struct(args)
    if args.model == "fibonacci":
        _, const_buffer, _, _ = _fibonacci(args.nbits or ss["nBits"])
    elif args.const_file:
        _, const_buffer, _ = serialization.read_const_file(args.const_file, n_pols=args.npols)
    else:
        raise SystemExit("--model or --const-file required")

    device = context.resolve_device(args.device)
    tree = setup.const_tree(const_buffer, ss["nBits"], ss["nBitsExt"],
                            MerkleHashGL(ss.get("splitLinearHash", False)), device)
    host = dev.to_host_tree(tree)
    del tree
    merkle.write_tree(host, args.consttree)
    serialization.dump_verkey(host.root, args.verkey)
    serialization.write_const_file(args.constsfile, const_buffer, host.elements)
    if args.ref_consts:
        binfile.write_consts_binfile(
            args.ref_consts, host.elements, host,
            gl64.powers(gl64.w(ss["nBits"]), 1 << ss["nBits"]),
            gl64.powers(gl64.w(ss["nBitsExt"]), 1 << ss["nBitsExt"], start=gl64.SHIFT_INT),
        )
    if args.pilcom_const:
        binfile.write_pilcom_const(args.pilcom_const, const_buffer)
    print(f"wrote {args.consttree}, {args.verkey}, {args.constsfile}")


def cmd_verify(args):
    from .stark import verifier
    from .utils import serialization

    proof = serialization.load_proof(args.proof)
    publics = [int(x) for x in serialization.load_json(args.publics)]
    const_root = serialization.load_verkey(args.verkey)
    stark_info = serialization.load_json(args.starkinfo)
    verifier_info = serialization.load_json(args.verifierinfo)
    ok = verifier.verify(proof, publics, const_root, stark_info, verifier_info)
    print("VALID proof" if ok else "INVALID proof")
    sys.exit(0 if ok else 1)


def cmd_pilverify(args):
    """main_pilverifier.js: the debug prove's constraint check."""
    from .compiler.pilinfo import pil_info
    from .stark import prover

    if args.pil_json and args.const and args.commit:
        pil, const_buffer, cm_buffer, publics = _load_machine(args)
    elif args.model == "fibonacci":
        pil, const_buffer, cm_buffer, publics = _fibonacci(args.nbits or 6, args.inputs)
    else:
        raise SystemExit("--model fibonacci supported")
    info = pil_info(pil, True, {}, {"debug": True})
    errors = prover.prove(
        info["pilInfo"], info["expressionsInfo"], const_buffer, None,
        (cm_buffer, publics), debug=True, device=args.device,
    )
    if errors:
        for e in errors:
            print(e)
        sys.exit(1)
    print("PIL OK!")


# ---------------------------------------------------------------------------
# the Goldilocks recursion tier (main_pil2circom.js, compressor/*)


def _intify(obj):
    """zkin/witness JSONs carry big ints as strings; restore them."""
    if isinstance(obj, str) and (obj.isdigit()
                                 or (obj[:1] == "-" and obj[1:].isdigit())):
        return int(obj)
    if isinstance(obj, list):
        return [_intify(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _intify(v) for k, v in obj.items()}
    return obj


def _read_circom_dir(path: str) -> dict:
    files = {}
    for name in os.listdir(path):
        if name.endswith(".circom"):
            with open(os.path.join(path, name)) as f:
                files[name] = f.read()
    if not files:
        raise SystemExit(f"no .circom files in {path}")
    return files


def cmd_pil2circom(args):
    """main_pil2circom.js: starkinfo + verifier info + verkey -> verifier
    circuit files (the GL gadget set, or the BN128 one for a BN128
    starkinfo)."""
    from .compiler import pil2circom
    from .utils import serialization

    stark_info = serialization.load_json(args.starkinfo)
    verifier_info = serialization.load_json(args.verifierinfo)
    const_root = serialization.load_verkey(args.verkey)
    os.makedirs(args.out, exist_ok=True)
    files = pil2circom.emit_circuit_files(const_root, stark_info, verifier_info)
    for name, text in files.items():
        with open(os.path.join(args.out, name), "w") as f:
            f.write(text)
    print(f"wrote {len(files)} circuit files to {args.out}")


def _compressor_like_setup(args, setup_fn, exec_mod, fr: bool):
    """Shared compressor-setup / final-setup body: compile the circuit
    with the circom front-end (compiler + witness calculator in one —
    the reference shells out to circom and a WASM witness calculator),
    lay out the plonkish machine, write pil/const/exec/witness/meta."""
    from .compiler import circom_front as cf
    from .utils import serialization

    files = _read_circom_dir(args.circom_dir)
    inputs = _intify(serialization.load_json(args.inputs))
    prime = None
    if fr:
        from .final.plonksetup import FR

        prime = FR
    cc = cf.compile_and_witness(files, args.entry, inputs, prime=prime)
    if not cc.check():
        raise SystemExit("circuit constraint check failed on these inputs")

    options = {}
    if args.force_nbits:
        options["forceNBits"] = args.force_nbits
    if fr and args.ncommitted:
        options["nCommitted"] = args.ncommitted
    if fr:
        s = setup_fn(cc, cols=args.cols, options=options)
    else:
        s = setup_fn(cc, options=options)

    pfx = args.out_prefix
    serialization.dump_json(
        json.loads(json.dumps(s["pil"], default=str)), pfx + ".pil.json"
    )
    if fr:
        const_rows = [[str(int(v)) for v in row] for row in s["constPols"]]
        serialization.dump_json(const_rows, pfx + ".const.json")
        exec_mod.write_exec_file(pfx + ".exec", s["plonkAdditions"],
                                 s["sMap"],
                                 ref_format=getattr(args, "ref_exec", False))
    else:
        np.save(pfx + ".const.npy", s["constBuffer"])
        exec_mod.write_exec_file(pfx + ".exec", s["plonkAdditions"], s["sMap"])
    serialization.dump_json(
        [str(int(v)) for v in cc.witness], pfx + ".wtns.json"
    )
    serialization.dump_json(
        {"nBits": s["nBits"], "nPublics": s["nPublics"],
         "cols": args.cols}, pfx + ".meta.json"
    )
    ext = ".const.json" if fr else ".const.npy"
    print(f"wrote {pfx}.pil.json, {pfx}{ext}, {pfx}.exec, "
          f"{pfx}.wtns.json, {pfx}.meta.json "
          f"(N=2^{s['nBits']}, {s['nPublics']} publics)")


def cmd_compressor_setup(args):
    """compressor/main_compressor_setup.js (C12 or C18 by --cols)."""
    from .compiler import compressor12, compressor18

    mod = compressor18 if args.cols == 18 else compressor12
    _compressor_like_setup(args, mod.setup, compressor12, fr=False)


def cmd_compressor_exec(args):
    """compressor/main_compressor_exec.js: exec + witness -> committed
    buffer (+ publics)."""
    from .compiler import compressor12, compressor18
    from .utils import serialization

    meta = serialization.load_json(args.meta)
    cols = meta.get("cols", 12)
    adds, smap = compressor12.read_exec_file(args.exec_file, n_cols=cols)
    wtns = [int(x) for x in serialization.load_json(args.wtns)]
    mod = compressor18 if cols == 18 else compressor12
    cm = mod.exec_witness(wtns, adds, smap, meta["nBits"])
    np.save(args.commit, cm)
    serialization.dump_json(
        [str(w) for w in wtns[1:1 + meta["nPublics"]]], args.publics
    )
    print(f"wrote {args.commit}, {args.publics}")


def cmd_final_setup(args):
    """final/main_final_setup.js (final9/final6/finalfflonk)."""
    from .final import exec as fexec, plonksetup

    _compressor_like_setup(args, plonksetup.setup, fexec, fr=True)


def cmd_final_exec(args):
    """final/main_final_exec.js: exec + witness -> Fr committed buffer."""
    from .final import exec as fexec
    from .utils import serialization

    meta = serialization.load_json(args.meta)
    adds, smap = fexec.read_exec_file(
        args.exec_file, n_cols=meta.get("cols") or None)
    wtns = [int(x) for x in serialization.load_json(args.wtns)]
    cm = fexec.exec_witness(wtns, adds, smap)
    serialization.dump_json(
        [[str(int(v)) for v in row] for row in cm], args.commit
    )
    serialization.dump_json(
        [str(w) for w in wtns[1:1 + meta["nPublics"]]], args.publics
    )
    print(f"wrote {args.commit}, {args.publics}")


# ---------------------------------------------------------------------------
# on-chain leg (fflonk/main_*.js)


def cmd_fflonkinfo(args):
    """fflonk/main_fflonkinfo.js: PIL -> fflonkinfo + code artifacts
    (pil_info with stark=False over Fr)."""
    from .compiler.pilinfo import pil_info
    from .utils import serialization

    pil = serialization.load_json(args.pil_json)
    out = pil_info(pil, stark=False, options={"field": args.field})
    serialization.dump_json(out["pilInfo"], args.fflonkinfo)
    serialization.dump_json(out["expressionsInfo"], args.expressionsinfo)
    serialization.dump_json(out["verifierInfo"], args.verifierinfo)
    print(f"wrote {args.fflonkinfo}, {args.expressionsinfo}, "
          f"{args.verifierinfo}")


def cmd_fflonk_setup(args):
    """fflonk/main_setup.js + main_shkey.js: constants + fflonkinfo ->
    zkey + verification key.  The powers-of-tau string is the dev-mode
    ceremony (protocol/shplonk.py dev_ptau) seeded by --tau; a real
    deployment would substitute a ceremony transcript."""
    from .fflonk.shkey import fflonk_setup, verification_key
    from .protocol.shplonk import dev_ptau
    from .utils import serialization

    fflonk_info = serialization.load_json(args.fflonkinfo)
    const_rows = [[int(v) for v in row]
                  for row in serialization.load_json(args.const)]
    n = 1 << fflonk_info["pilPower"]
    ptau_size = args.ptau_size or 40 * n
    ptau = dev_ptau(ptau_size, tau=args.tau)
    zkey = fflonk_setup(const_rows, fflonk_info, ptau,
                        max_q_degree=args.max_q_degree)

    def np_default(o):
        if isinstance(o, np.ndarray):
            return o.tolist()
        return int(o)

    with open(args.zkey, "w") as f:
        json.dump(zkey, f, default=np_default)
    serialization.dump_json({"g1": ptau["g1"], "X_2": ptau["X_2"]}, args.ptau)
    vk = verification_key(zkey, fflonk_info)
    serialization.dump_json(vk, args.verificationkey)
    print(f"wrote {args.zkey}, {args.ptau}, {args.verificationkey}")


def cmd_fflonk_prove(args):
    """fflonk/main_prover.js: zkey + committed buffer -> proof."""
    import random

    from .fflonk.prover import fflonk_prove
    from .utils import serialization

    zkey = serialization.load_json(args.zkey)
    ptau = serialization.load_json(args.ptau)
    fflonk_info = serialization.load_json(args.fflonkinfo)
    expressions_info = serialization.load_json(args.expressionsinfo)
    rows = serialization.load_json(args.commit)
    cm = np.empty((len(rows), len(rows[0]) if rows else 0), dtype=object)
    for i, row in enumerate(rows):
        for j, v in enumerate(row):
            cm[i, j] = int(v)
    publics = [int(x) for x in serialization.load_json(args.publics)]
    chelpers = None
    if getattr(args, "chelpers", None):
        from .fflonk import chelpers as fflonk_chelpers
        chelpers = fflonk_chelpers.read_file(args.chelpers)
    res = fflonk_prove(zkey, ptau, fflonk_info, expressions_info, cm,
                       publics, rng=random.Random(args.seed),
                       chelpers=chelpers)
    serialization.dump_json(
        json.loads(json.dumps(res["proof"], default=str)), args.proof
    )
    serialization.dump_json([str(p) for p in res["publics"]],
                            args.out_publics)
    print(f"wrote {args.proof}, {args.out_publics}")


def cmd_fflonk_chelpers(args):
    """fflonk/chelpers twin (fflonk_chelpers.js:1-242): flatten the stage
    TACs into the `.fflonkchelpers.bin` bytecode artifact."""
    from .fflonk import chelpers as fflonk_chelpers
    from .utils import serialization

    fflonk_info = serialization.load_json(args.fflonkinfo)
    expressions_info = serialization.load_json(args.expressionsinfo)
    units = fflonk_chelpers.write_file(args.out, fflonk_info,
                                       expressions_info)
    n_ops = sum(len(u["ops"]) for us in units.values() for u in us)
    print(f"wrote {args.out} ({n_ops} flattened ops)")


def _load_fflonk_proof(path):
    from .utils import serialization

    proof = _intify(serialization.load_json(path))
    proof["polynomials"] = {
        k: (None if v is None else (int(v[0]), int(v[1])))
        for k, v in proof["polynomials"].items()
    }
    return proof


def cmd_fflonk_verify(args):
    """fflonk/main_verifier.js."""
    from .fflonk.verifier import fflonk_verify
    from .utils import serialization

    vk = serialization.load_json(args.verificationkey)
    fflonk_info = serialization.load_json(args.fflonkinfo)
    verifier_info = serialization.load_json(args.verifierinfo)
    proof = _load_fflonk_proof(args.proof)
    publics = [int(x) for x in serialization.load_json(args.publics)]
    ok = fflonk_verify(vk, fflonk_info, verifier_info, proof, publics)
    print("VALID proof" if ok else "INVALID proof")
    sys.exit(0 if ok else 1)


# ---------------------------------------------------------------------------
# split setup pipeline (main_preparepil.js / main_genpilcode.js /
# main_calculateimpols.js)


def cmd_preparepil(args):
    """main_preparepil.js: run only the preparation stage and dump the
    prepared-pil summary (polynomial maps, stage counts, constraints)."""
    from .compiler.prepare import prepare_pil
    from .utils import serialization

    pil, pil2 = _compile_pil(args)
    ss = _stark_struct(args)
    info = prepare_pil(pil, ss, stark=True, pil2=pil2)
    res = info["res"]
    summary = {
        "name": res["name"],
        "nStages": res["nStages"],
        "nConstants": res["nConstants"],
        "nPublics": res["nPublics"],
        "nCommitments": res["nCommitments"],
        "qDim": res["qDim"],
        "cExpId": res["cExpId"],
        "boundaries": res["boundaries"],
        "openingPoints": res["openingPoints"],
        "nExpressions": len(info["expressions"]),
        "nConstraints": len(info["constraints"]),
        "starkStruct": res["starkStruct"],
    }
    serialization.dump_json(json.loads(json.dumps(summary, default=str)), args.out)
    print(f"wrote {args.out}")


def cmd_genpilcode(args):
    """main_genpilcode.js: emit only the generated TAC code artifacts (the
    earlier stages of the split pipeline are recomputed: they are
    deterministic and fast)."""
    from .compiler.pilinfo import pil_info
    from .utils import serialization

    pil, pil2 = _compile_pil(args)
    ss = _stark_struct(args)
    out = pil_info(pil, stark=True, stark_struct=ss, pil2=pil2)
    serialization.dump_json(out["expressionsInfo"], args.expressionsinfo)
    serialization.dump_json(out["verifierInfo"], args.verifierinfo)
    print(f"wrote {args.expressionsinfo}, {args.verifierinfo}")


def cmd_calculateimpols(args):
    """main_calculateimpols.js + calculateImPols.py: report the
    intermediate-polynomial selection, heuristic min-cut against the exact
    branch-and-bound optimizer (compiler/impols_opt.py)."""
    from .compiler.pilinfo import pil_info
    from .utils import serialization

    ss = _stark_struct(args)
    report = {}
    for label, opts in (("heuristic", {}), ("optimal", {"optImPols": True})):
        pil, pil2 = _compile_pil(args)
        out = pil_info(pil, stark=True, stark_struct=ss, pil2=pil2, options=opts)
        im = [p for p in out["pilInfo"]["cmPolsMap"] if p and p.get("imPol")]
        report[label] = {
            "nImPols": len(im),
            "addedCols": sum(p["dim"] for p in im),
            "qDeg": out["pilInfo"]["qDeg"],
            "imPols": [p["name"] for p in im],
        }
    serialization.dump_json(report, args.out)
    h, o = report["heuristic"], report["optimal"]
    print(f"heuristic: {h['nImPols']} im pols / {h['addedCols']} cols "
          f"(qDeg {h['qDeg']}); optimal: {o['nImPols']} / {o['addedCols']} "
          f"(qDeg {o['qDeg']}); wrote {args.out}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="pil2_stark_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--pil")
        sp.add_argument("--pilout", help=".pilout protobuf (PIL2)")
        sp.add_argument("--subproof-id", dest="subproof_id")
        sp.add_argument("--air-id", dest="air_id")
        sp.add_argument("--model")
        sp.add_argument("--nbits", type=int)
        sp.add_argument("--starkstruct")
        sp.add_argument("--inputs", type=lambda s: [int(x) for x in s.split(",")])

    def device(sp):
        sp.add_argument("--device", choices=["cuda", "cpu"],
                        help="where the kernels run (default: the card; no fallback)")

    sp = sub.add_parser("genstarkinfo")
    common(sp)
    sp.add_argument("--starkinfo", default="starkinfo.json")
    sp.add_argument("--expressionsinfo", default="expressionsinfo.json")
    sp.add_argument("--verifierinfo", default="verifierinfo.json")
    sp.set_defaults(fn=cmd_genstarkinfo)

    sp = sub.add_parser("buildchelpers")
    common(sp)
    sp.add_argument("--chelpers", default="machine.chelpers.bin")
    sp.set_defaults(fn=cmd_buildchelpers)

    sp = sub.add_parser("preparepil")
    common(sp)
    sp.add_argument("-o", "--out", default="preparedpil.json")
    sp.set_defaults(fn=cmd_preparepil)

    sp = sub.add_parser("genpilcode")
    common(sp)
    sp.add_argument("--expressionsinfo", default="expressionsinfo.json")
    sp.add_argument("--verifierinfo", default="verifierinfo.json")
    sp.set_defaults(fn=cmd_genpilcode)

    sp = sub.add_parser("calculateimpols")
    common(sp)
    sp.add_argument("-o", "--out", default="impols.json")
    sp.set_defaults(fn=cmd_calculateimpols)

    sp = sub.add_parser("prove")
    common(sp)
    device(sp)
    sp.add_argument("--tmp", default="out")
    sp.add_argument("--pil-json", dest="pil_json")
    sp.add_argument("--const")
    sp.add_argument("--commit")
    sp.add_argument("--publics")
    sp.add_argument("--profile-dir", dest="profile_dir",
                    help="write a torch.profiler Chrome trace of the prove "
                         "to this directory")
    sp.set_defaults(fn=cmd_prove)

    sp = sub.add_parser("buildconsttree")
    common(sp)
    device(sp)
    sp.add_argument("--const-file", dest="const_file")
    sp.add_argument("--npols", type=int,
                    help="column count when --const-file is a headerless "
                         "pilcom .const file")
    sp.add_argument("--consttree", default="consttree.bin")
    sp.add_argument("--verkey", default="verkey.json")
    sp.add_argument("--constsfile", default="consts.bin")
    sp.add_argument("--ref-consts", dest="ref_consts",
                    help="also write the reference's 'cnts' binfile "
                         "(stark_constsPolsFile.js layout)")
    sp.add_argument("--pilcom-const", dest="pilcom_const",
                    help="also write a pilcom-layout .const file")
    sp.set_defaults(fn=cmd_buildconsttree)

    sp = sub.add_parser("verify")
    sp.add_argument("--proof", required=True)
    sp.add_argument("--publics", required=True)
    sp.add_argument("--verkey", required=True)
    sp.add_argument("--starkinfo", required=True)
    sp.add_argument("--verifierinfo", required=True)
    sp.set_defaults(fn=cmd_verify)

    sp = sub.add_parser("pilverify")
    common(sp)
    device(sp)
    sp.add_argument("--pil-json", dest="pil_json")
    sp.add_argument("--const")
    sp.add_argument("--commit")
    sp.add_argument("--publics")
    sp.set_defaults(fn=cmd_pilverify)

    sp = sub.add_parser("pil2circom")
    sp.add_argument("--starkinfo", required=True)
    sp.add_argument("--verifierinfo", required=True)
    sp.add_argument("--verkey", required=True)
    sp.add_argument("-o", "--out", default="circuit")
    sp.set_defaults(fn=cmd_pil2circom)

    def circuit_setup_args(sp, fr):
        sp.add_argument("--circom-dir", dest="circom_dir", required=True)
        sp.add_argument("--entry", default="verifier.circom")
        sp.add_argument("--inputs", required=True,
                        help="circuit inputs JSON (e.g. the zkin file)")
        sp.add_argument("--out-prefix", dest="out_prefix", required=True)
        sp.add_argument("--force-nbits", dest="force_nbits", type=int)
        if fr:
            sp.add_argument("--cols", type=int, default=9,
                            choices=[0, 6, 9])
            sp.add_argument("--ncommitted", type=int,
                            help="finalfflonk (cols=0) committed columns")
            sp.add_argument("--ref-exec", dest="ref_exec",
                            action="store_true",
                            help="write .exec as the reference's iden3 "
                                 "'exec' binfile (exec_helpers.js)")
        else:
            sp.add_argument("--cols", type=int, default=12,
                            choices=[12, 18])

    sp = sub.add_parser("compressor-setup")
    circuit_setup_args(sp, fr=False)
    sp.set_defaults(fn=cmd_compressor_setup)

    def exec_args(sp):
        sp.add_argument("--exec", dest="exec_file", required=True)
        sp.add_argument("--wtns", required=True)
        sp.add_argument("--meta", required=True)
        sp.add_argument("--commit", required=True)
        sp.add_argument("--publics", required=True)

    sp = sub.add_parser("compressor-exec")
    exec_args(sp)
    sp.set_defaults(fn=cmd_compressor_exec)

    sp = sub.add_parser("final-setup")
    circuit_setup_args(sp, fr=True)
    sp.set_defaults(fn=cmd_final_setup)

    sp = sub.add_parser("final-exec")
    exec_args(sp)
    sp.set_defaults(fn=cmd_final_exec)

    sp = sub.add_parser("fflonkinfo")
    sp.add_argument("--pil-json", dest="pil_json", required=True)
    sp.add_argument("--field", default="fr", choices=["gl", "fr"])
    sp.add_argument("--fflonkinfo", default="fflonkinfo.json")
    sp.add_argument("--expressionsinfo", default="expressionsinfo.json")
    sp.add_argument("--verifierinfo", default="verifierinfo.json")
    sp.set_defaults(fn=cmd_fflonkinfo)

    sp = sub.add_parser("fflonk-setup")
    sp.add_argument("--fflonkinfo", required=True)
    sp.add_argument("--const", required=True)
    sp.add_argument("--tau", type=int, help="dev-ptau toxic scalar seed")
    sp.add_argument("--ptau-size", dest="ptau_size", type=int)
    sp.add_argument("--max-q-degree", dest="max_q_degree", type=int,
                    default=0)
    sp.add_argument("--zkey", default="zkey.json")
    sp.add_argument("--ptau", default="ptau.json")
    sp.add_argument("--verificationkey", default="verificationkey.json")
    sp.set_defaults(fn=cmd_fflonk_setup)

    sp = sub.add_parser("fflonk-prove")
    sp.add_argument("--zkey", required=True)
    sp.add_argument("--ptau", required=True)
    sp.add_argument("--fflonkinfo", required=True)
    sp.add_argument("--expressionsinfo", required=True)
    sp.add_argument("--commit", required=True)
    sp.add_argument("--publics", required=True)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--proof", default="proof.json")
    sp.add_argument("--out-publics", dest="out_publics",
                    default="proof.publics.json")
    sp.add_argument("--chelpers", help="prebuilt .fflonkchelpers.bin — "
                    "execute stage TACs via the bytecode interpreter")
    sp.set_defaults(fn=cmd_fflonk_prove)

    sp = sub.add_parser("fflonk-chelpers")
    sp.add_argument("--fflonkinfo", required=True)
    sp.add_argument("--expressionsinfo", required=True)
    sp.add_argument("--out", default="fflonk.chelpers.bin")
    sp.set_defaults(fn=cmd_fflonk_chelpers)

    sp = sub.add_parser("fflonk-verify")
    sp.add_argument("--verificationkey", required=True)
    sp.add_argument("--fflonkinfo", required=True)
    sp.add_argument("--verifierinfo", required=True)
    sp.add_argument("--proof", required=True)
    sp.add_argument("--publics", required=True)
    sp.set_defaults(fn=cmd_fflonk_verify)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
