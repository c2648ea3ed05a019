"""The compiled TAC program (ops/torch_tac.py) on the CPU, without JAX:
slots assigned by liveness for every program of every committed setup, a
synthetic program cut into segments by a rotated read of a column it wrote,
and every mixed-dim case of the arithmetic.  Values are compared with
field/torch_f3 op by op; tolerance: none, bit for bit."""
import numpy as np
import pytest
import torch

from pil2_stark_tpu_torch.field import torch_f3 as f3g
from pil2_stark_tpu_torch.field import torch_gl
from pil2_stark_tpu_torch.ops import torch_tac
from pil2_stark_tpu_torch.stark import setup as tsetup

P = 0xFFFFFFFF00000001
SETUPS = ["all_8", "all_20", "fibonacci_6", "fibonacci_6_split", "fibonacci_22",
          "boundaries_6", "poseidon_vm_20", "fibv_module"]


def _compiled(name, which):
    setup = tsetup.read_setup(name)
    info = setup["starkInfo"]
    code, dom = torch_tac.device_program(info, setup["expressionsInfo"], which)
    ss = info["starkStruct"]
    return code["code"], torch_tac.compile_program(code, dom, info, ss["nBits"], ss["nBitsExt"])


def _writes_and_reads(code):
    """Each write of a tmp as (tmp id, instruction), with the instructions
    that read that write."""
    latest, reads = {}, {}
    for j, inst in enumerate(code):
        for r in inst["src"]:
            if r["type"] == "tmp":
                reads[latest[r["id"]]].append(j)
        if inst["dest"]["type"] == "tmp":
            latest[inst["dest"]["id"]] = (inst["dest"]["id"], j)
            reads[(inst["dest"]["id"], j)] = []
    return reads


@pytest.mark.parametrize("which", torch_tac.PROGRAMS)
@pytest.mark.parametrize("name", SETUPS)
def test_slot_count_is_peak_of_live_values(name, which):
    """Instruction j reads its sources before it writes its dest, so at j
    the slots hold the values written before j and read after j, and j's
    own dest."""
    code, prog = _compiled(name, which)
    reads = _writes_and_reads(code)
    peak = 0
    for j, inst in enumerate(code):
        live = sum(1 for (_, k), rs in reads.items() if k < j and rs and max(rs) > j)
        peak = max(peak, live + (inst["dest"]["type"] == "tmp"))
    assert prog.n_slots == peak
    assert len(prog.segments) == 1 and len(prog.ins) == len(code)


@pytest.mark.parametrize("which", torch_tac.PROGRAMS)
@pytest.mark.parametrize("name", SETUPS)
def test_no_slot_is_read_after_reuse(name, which):
    """Replays the slot assignment: every tmp read finds in its slot the
    write it reads in the source program."""
    code, prog = _compiled(name, which)
    latest, holds = {}, {}
    for j, (inst, (_, _, dest, srcs)) in enumerate(zip(code, prog.ins)):
        for r, s in zip(inst["src"], srcs):
            if r["type"] == "tmp":
                assert s[0] == "slot" and holds[s[1]] == latest[r["id"]], (j, r)
        if inst["dest"]["type"] == "tmp":
            assert dest[0] == "slot" and dest[1] < prog.n_slots
            latest[inst["dest"]["id"]] = (inst["dest"]["id"], j)
            holds[dest[1]] = latest[inst["dest"]["id"]]


# ---------------------------------------------------------------------------
# synthetic programs


def _pil_info(dims):
    return {"cmPolsMap": [{"stage": 1, "stagePos": 3 * i, "dim": d} for i, d in enumerate(dims)],
            "boundaries": [{"name": "everyRow"}]}


def inputs_for(pil_info, n, seed, device="cpu"):
    rng = np.random.default_rng(seed)

    def rand(*shape):
        return torch_gl.from_u64(rng.integers(0, P, size=shape, dtype=np.uint64), device)

    cm1 = 3 * len(pil_info["cmPolsMap"])
    return {"sections": {"const": rand(2, n), "cm1": rand(cm1, n)}, "x": rand(n),
            "Zi": rand(1, n), "xDivXSubXi": rand(2, 3, n), "publics": rand(2),
            "challenges": rand(2, 3), "evals": rand(2, 3)}


def reference(code, pil_info, inputs, n, shift_of):
    """The program op by op with torch_f3, every tmp kept to the end."""
    tmp, out_cm, out = {}, {}, {}

    def get(r):
        t, shift = r["type"], shift_of(r.get("prime"))
        if t == "tmp":
            return tmp[r["id"]]
        if t == "cm":
            p = pil_info["cmPolsMap"][r["id"]]
            v = out_cm.get(r["id"])
            if v is None:
                v = inputs["sections"]["cm1"][p["stagePos"]:p["stagePos"] + p["dim"]]
            return torch.roll(v, -shift, dims=1)
        if t == "const":
            return torch.roll(inputs["sections"]["const"][r["id"]:r["id"] + 1], -shift, dims=1)
        if t == "number":
            return torch.tensor([[torch_gl.i64(int(r["value"]))]])
        if t == "public":
            return inputs["publics"][r["id"]].reshape(1, 1)
        if t in ("challenge", "eval"):
            return inputs[t + "s"][r["id"]].reshape(3, 1)
        if t == "x":
            return inputs["x"][None]
        raise ValueError(t)

    def full(v, d):
        if v.shape[0] != d:
            v = torch.cat([v, torch.zeros((d - v.shape[0],) + v.shape[1:], dtype=torch.int64)])
        return v.expand(d, n).contiguous()

    for inst in code:
        a = [get(r) for r in inst["src"]]
        op = inst["op"]
        res = {"copy": lambda: a[0], "add": lambda: f3g.add(a[0], a[1]),
               "sub": lambda: f3g.sub(a[0], a[1]), "mul": lambda: f3g.mul(a[0], a[1]),
               "muladd": lambda: f3g.muladd(a[0], a[1], a[2])}[op]()
        d = inst["dest"]
        if d["type"] == "tmp":
            tmp[d["id"]] = res
        elif d["type"] == "cm":
            dim = pil_info["cmPolsMap"][d["id"]]["dim"]
            out_cm[d["id"]] = torch.roll(full(res, dim), shift_of(d.get("prime")), dims=1)
        else:
            out[d["type"]] = full(res, 3 if d["type"] == "f" else d["dim"])
    return out, out_cm


def _ref(t, i, prime=0):
    r = {"type": t, "id": i}
    if prime:
        r["prime"] = prime
    return r


SEG_DIMS = [1, 3, 1, 3]  # cm 0..3
SEGMENTED = [
    {"op": "mul", "dest": _ref("tmp", 0), "src": [_ref("cm", 0), _ref("const", 1, 1)]},
    {"op": "add", "dest": _ref("cm", 1), "src": [_ref("tmp", 0), _ref("challenge", 0)]},
    # a rotated read of cm 1, written just before: the first cut; tmp 0 is carried
    {"op": "mul", "dest": _ref("tmp", 1), "src": [_ref("cm", 1, 1), _ref("eval", 1)]},
    {"op": "sub", "dest": _ref("tmp", 2), "src": [_ref("tmp", 0), _ref("tmp", 1)]},
    # cm 2 written one row on; read through the same shift it stays in the row
    {"op": "mul", "dest": _ref("cm", 2, 1),
     "src": [_ref("tmp", 0), {"type": "number", "value": str(P + 5)}]},
    {"op": "add", "dest": _ref("tmp", 3), "src": [_ref("cm", 2, 1), _ref("x", 0)]},
    # an unrotated read of cm 2 needs the rows other threads wrote: the second cut
    {"op": "muladd", "dest": _ref("tmp", 4),
     "src": [_ref("tmp", 3), _ref("tmp", 2), _ref("cm", 2)]},
    {"op": "sub", "dest": _ref("cm", 3, -1), "src": [_ref("public", 1), _ref("tmp", 4)]},
    {"op": "copy", "dest": {"type": "q", "dim": 3}, "src": [_ref("tmp", 4)]},
]


def segmented_case(n_bits=4, ext_bits=6):
    info = _pil_info(SEG_DIMS)
    code_obj = {"code": SEGMENTED}
    prog = torch_tac.compile_program(code_obj, "ext", info, n_bits, ext_bits)
    return code_obj, info, prog


def test_segmented_program_matches_op_by_op():
    code_obj, info, prog = segmented_case()
    assert len(prog.segments) == 3
    carried = [b for b in prog.buffers if b[0][0] == "carry"]
    assert len(carried) == 3  # tmp 0 at the first cut, tmp 2 and tmp 3 at the second
    n, extend_bits = 1 << 6, 2
    inputs = inputs_for(info, n, 9)
    got = torch_tac.make_executor(code_obj, "ext", info, 4, 6)(inputs)
    want_out, want_cm = reference(SEGMENTED, info, inputs, n,
                                  lambda p: ((p or 0) << extend_bits) % n)
    assert torch.equal(got["q"], want_out["q"])
    assert sorted(got["cm"]) == [("cm1", 3 * i, SEG_DIMS[i]) for i in (1, 2, 3)]
    for i in (1, 2, 3):
        assert torch.equal(got["cm"][("cm1", 3 * i, SEG_DIMS[i])], want_cm[i])


def wide_case(live=40, n_bits=4, ext_bits=6):
    """A program that holds `live` extension values at once, more than any
    committed program: tmp k = cm (k mod 4) · challenge (k mod 2) + x,
    then q = Σ tmp k · eval (k mod 2), summed from the last value down."""
    info = _pil_info([1, 3, 1, 3])
    code = [{"op": "muladd", "dest": _ref("tmp", k),
             "src": [_ref("cm", k % 4, k % 3 - 1), _ref("challenge", k % 2), _ref("x", 0)]}
            for k in range(live)]
    code.append({"op": "mul", "dest": _ref("tmp", live),
                  "src": [_ref("tmp", live - 1), _ref("eval", 0)]})
    for k in range(live - 2, -1, -1):
        code.append({"op": "muladd", "dest": _ref("tmp", live),
                     "src": [_ref("tmp", k), _ref("eval", k % 2), _ref("tmp", live)]})
    code.append({"op": "copy", "dest": {"type": "q", "dim": 3}, "src": [_ref("tmp", live)]})
    code_obj = {"code": code}
    prog = torch_tac.compile_program(code_obj, "ext", info, n_bits, ext_bits)
    return code_obj, info, prog


def test_wide_program_matches_op_by_op():
    code_obj, info, prog = wide_case()
    assert prog.n_slots == 40 and len(prog.segments) == 1
    n, extend_bits = 1 << 6, 2
    inputs = inputs_for(info, n, 12)
    got = torch_tac.make_executor(code_obj, "ext", info, 4, 6)(inputs)
    want_out, _ = reference(code_obj["code"], info, inputs, n,
                            lambda p: ((p or 0) << extend_bits) % n)
    assert torch.equal(got["q"], want_out["q"])


MIXED = [(1, 1), (1, 3), (3, 1), (3, 3)]


def mixed_case(op, da, db, b_kind):
    """tmp 0 = op(a, b); q (dim 3) = tmp 0, zero-padded when dim 1.  a is a
    column of dim da; b a column or a scalar of dim db."""
    info = _pil_info([da, db])
    if b_kind == "column":
        b = _ref("cm", 1, 1)
    else:
        b = _ref("challenge", 1) if db == 3 else _ref("public", 0)
    code_obj = {"code": [
        {"op": op, "dest": _ref("tmp", 0), "src": [_ref("cm", 0), b]},
        {"op": "copy", "dest": {"type": "q", "dim": 3}, "src": [_ref("tmp", 0)]},
    ]}
    return code_obj, info, b


@pytest.mark.parametrize("b_kind", ["column", "scalar"])
@pytest.mark.parametrize("da,db", MIXED)
@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_mixed_dims_match_torch_f3(op, da, db, b_kind):
    code_obj, info, b = mixed_case(op, da, db, b_kind)
    n = 16
    inputs = inputs_for(info, n, da * 10 + db)
    got = torch_tac.make_executor(code_obj, "n", info, 4, 6)(inputs)["q"]
    a_val = inputs["sections"]["cm1"][0:da]
    if b_kind == "column":
        b_val = torch.roll(inputs["sections"]["cm1"][3:3 + db], -1, dims=1)
    elif db == 3:
        b_val = inputs["challenges"][1].reshape(3, 1)
    else:
        b_val = inputs["publics"][0].reshape(1, 1)
    want = getattr(f3g, op)(a_val, b_val).expand(max(da, db), n)
    assert torch.equal(got[: want.shape[0]], want)
    assert not got[want.shape[0]:].any()


def test_dim1_copy_to_dim3_cm_is_zero_padded():
    info = _pil_info([1, 3])
    code_obj = {"code": [{"op": "copy", "dest": _ref("cm", 1, 2), "src": [_ref("cm", 0)]}]}
    inputs = inputs_for(info, 8, 4)
    got = torch_tac.make_executor(code_obj, "n", info, 3, 5)(inputs)["cm"][("cm1", 3, 3)]
    col = torch.roll(inputs["sections"]["cm1"][0], 2)
    assert torch.equal(got[0], col) and not got[1:].any()
