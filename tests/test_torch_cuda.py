"""PyTorch port on the card: each CUDA kernel equals its plain version on
the card across the shapes its wrapper accepts, and a proof on the card
equals the proof on the CPU.  Needs an NVIDIA GPU and nvcc; skipped without
one.  Run on a machine with a card (its Python has no JAX, hence
--noconftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from pil2_stark_tpu_torch.field import torch_gl
from pil2_stark_tpu_torch.hash import cuda_poseidon, merkle, torch_poseidon
from pil2_stark_tpu_torch.ops import cuda_ntt, cuda_tac, ntt, tac_codegen, torch_tac
from pil2_stark_tpu_torch.stark import device as stark_device
from pil2_stark_tpu_torch.stark import setup as tsetup
from pil2_stark_tpu_torch.tools import exp_poseidon, exp_stream
import test_torch_tac_program as tac_cases

pytestmark = pytest.mark.cuda

P = 0xFFFFFFFF00000001


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _rand(shape, seed, device):
    a = np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)
    corners = np.array([0, 1, P - 1, P - 2], dtype=np.uint64)
    flat = a.reshape(-1)
    flat[: min(4, flat.size)] = corners[: min(4, flat.size)]
    return torch_gl.from_u64(a, device)


@pytest.mark.parametrize("bits1,bits2,cols", [
    (1, 12, 2), (7, 7, 1), (8, 12, 3), (12, 12, 1), (10, 3, 2), (4, 12, 3), (6, 5, 1),
    (8, 12, 15), (10, 12, 15)])  # the last two: the all-gadgets 2^20 / 2^22 LDEs
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_kernels_equal_plain(card, bits1, bits2, cols, inverse):
    """B2 and B3 (two passes above 2^6 points, pass 2 alone up to it; B2's
    last pass with n2 below a block's 32 lanes at bits2 3), then B3 again
    with its output written over its input, as planar_ntt runs them; the
    launches counted."""
    bits = bits1 + bits2
    x = _rand((cols, 1 << bits), bits, card)
    x[0, 4:8] = torch_gl.from_u64(np.array([P, P + 1, (1 << 64) - 1, 1 << 63],
                                            dtype=np.uint64), card)  # not canonical
    lt = ntt.level_twiddles(bits, bits1, inverse, card)
    before = (cuda_ntt.level_planar.launches, cuda_ntt.base_grid.launches)
    y = cuda_ntt.level_planar(x, bits1, 1 << bits2, cols, lt, inverse)
    assert torch.equal(y, cuda_ntt.level_planar_plain(x, bits1, 1 << bits2, cols, lt, inverse))
    z = cuda_ntt.base_grid(y, bits2, cols, inverse)
    want = cuda_ntt.base_grid_plain(y, bits2, cols, inverse)
    assert torch.equal(z, want)
    y2 = cuda_ntt.level_planar(x, bits1, 1 << bits2, cols, lt, inverse)
    two = bits2 > 6
    z2 = cuda_ntt.base_grid(y2, bits2, cols, inverse, out=y2 if two else None)
    assert torch.equal(z2, want)
    passes = (1 + (bits1 > 6), 1 + two)
    assert (cuda_ntt.level_planar.launches - before[0],
            cuda_ntt.base_grid.launches - before[1]) == (2 * passes[0], 2 * passes[1])
    torch.cuda.synchronize()


def test_ntt_wrappers_refuse_aliased_buffers(card):
    """A pass must not write over what it reads: B3's out may be y only
    when two passes run, and has y's shape and device."""
    x = _rand((2, 1 << 19), 19, card)
    lt = ntt.level_twiddles(19, 7, False, card)
    y = cuda_ntt.level_planar(x, 7, 1 << 12, 2, lt, False)
    for bad in (torch.empty_like(x), torch.empty_like(y, device="cpu")):
        with pytest.raises(ValueError):
            cuda_ntt.base_grid(y, 12, 2, False, out=bad)
    small = _rand((3 << 5, 4), 5, card)
    with pytest.raises(ValueError):
        cuda_ntt.base_grid(small, 5, 3, False, out=small)


@pytest.mark.parametrize("bits", [0, 1, 5, 12])
def test_base_grid_single_pass_equals_plain(card, bits):
    x = _rand((3 << bits, 1), bits, card)
    assert torch.equal(cuda_ntt.base_grid(x, bits, 3, False),
                       cuda_ntt.base_grid_plain(x, bits, 3, False))


@pytest.mark.parametrize("bits", range(1, 13))
@pytest.mark.parametrize("lanes", ["one", "four", "pow2", "odd"])
@pytest.mark.parametrize("inverse", [False, True])
def test_base_rows_equals_plain(card, bits, lanes, inverse):
    """B1 in both regimes (registers up to 2^5 rows, above them every
    split of the radix passes) with one lane, four, 3·2^k lanes (the FRI
    folds) and an odd count that leaves a ragged block."""
    n_lanes = {"one": 1, "four": 4, "pow2": 3 << 9, "odd": 1001}[lanes]
    x = _rand((1 << bits, n_lanes), bits + n_lanes, card)
    assert torch.equal(cuda_ntt.base_rows(x, bits, inverse),
                       cuda_ntt.base_rows_plain(x, bits, inverse))
    torch.cuda.synchronize()


def test_intt_rows_launches_b1(card):
    x = _rand((8, 3 << 10), 5, card)
    before = cuda_ntt.base_rows.launches
    got = ntt.intt_rows(x, 3)
    assert cuda_ntt.base_rows.launches == before + 1
    assert torch.equal(got.cpu(), ntt.intt_rows(x.cpu(), 3))


def test_ntt_round_trip_at_2_25(card):
    """Past the planar ceiling: the row route on B1, and back."""
    x = _rand((2, 1 << 25), 25, card)
    before = cuda_ntt.base_rows.launches
    y = ntt.ntt(x, 25)
    assert cuda_ntt.base_rows.launches == before + 5  # bases 2^12 (two passes), 2^1, 2^12
    assert torch.equal(ntt.intt(y, 25), x)
    del y
    torch.cuda.empty_cache()


@pytest.mark.parametrize("batch", [1, 255, 257, 4097])
def test_poseidon_kernel_equals_plain(card, batch):
    s = _rand((12, batch), batch, card)
    assert torch.equal(cuda_poseidon.permute(s), cuda_poseidon.permute_plain(s))


@pytest.mark.parametrize("case", ["non_canonical", "minus_one", "zero", "p_minus_1"])
def test_poseidon_kernel_edge_states(card, case):
    """B4 takes any u64 bit pattern as its residue (no canon at entry) and
    gives canonical output; states at the ends of the field."""
    n = 1000
    if case == "non_canonical":
        a = np.random.default_rng(3).integers(P, 1 << 64, size=(12, n), dtype=np.uint64)
        a[:, 0] = np.uint64(P)
    else:
        v = {"minus_one": (1 << 64) - 1, "zero": 0, "p_minus_1": P - 1}[case]
        a = np.full((12, n), v, dtype=np.uint64)
    s = torch_gl.from_u64(a, card)
    got = cuda_poseidon.permute(s)
    assert torch.equal(got, cuda_poseidon.permute_plain(s))
    assert bool((torch_gl.to_u64(got) < np.uint64(P)).all())
    want = cuda_poseidon.permute_fast_int([int(x) for x in a[:, 0]])
    assert [int(x) for x in torch_gl.to_u64(got[:, 0])] == want


def test_merkle_tree_on_card_equals_host_tree(card):
    """2^16 leaves of 8 columns: every level of the card's tree (B4 for the
    leaf sponge and each level) equals the host tree's."""
    height, width = 1 << 16, 8
    rows = np.random.default_rng(16).integers(0, P, size=(height, width), dtype=np.uint64)
    before = cuda_poseidon.permute.launches
    levels = torch_poseidon.merkle_levels_planar(torch_gl.from_u64(rows.T.copy(), card),
                                                 width, height)
    assert cuda_poseidon.permute.launches - before == 17  # the leaves, then 16 levels
    tree = merkle.merkelize(rows, width, height)
    assert len(levels) == len(tree.levels)
    for got, want in zip(levels, tree.levels):
        np.testing.assert_array_equal(torch_gl.to_u64(got).T, want)


X2_VARIANTS = ["packed", "packed-nosq", "packed-lazy", "packed-dual", "packed-lazy-dual",
               "packed-p4x", "packed-psl", "nomxu", "packed-nops", "packed-nofs"]


@pytest.mark.parametrize("variant", X2_VARIANTS)
@pytest.mark.parametrize("block", [256, 2048])
def test_poseidon_variant_kernel_equals_plain(card, variant, block):
    s = _rand((12, 1 << 14), 14, card)
    before = exp_poseidon.permute_variant.launches
    got = exp_poseidon.build(variant, (1 << 14) // block, block)(s)
    assert exp_poseidon.permute_variant.launches == before + 1
    assert torch.equal(got, exp_poseidon.permute_variant_plain(s, variant))


@pytest.mark.parametrize("bits", [14, 19])
def test_stream_kernel_equals_plain(card, bits):
    """2^19 states are 256 tiles: more than one per CTA of the persistent grid."""
    s = _rand((12, 1 << bits), bits, card)
    before = exp_stream.permute_stream.launches
    got = exp_stream.build_stream((1 << bits) // exp_stream.BLK)(s)
    assert exp_stream.permute_stream.launches == before + 1
    assert torch.equal(got, cuda_poseidon.permute_plain(s))


def _tac_inputs(info, dom, n, seed, device):
    """Random canonical inputs of a setup's program at n rows."""
    rng = np.random.default_rng(seed)

    def rand(*shape):
        return torch_gl.from_u64(rng.integers(0, P, size=shape, dtype=np.uint64), device)

    sections = {"const": rand(info["nConstants"], n)}
    for i in range(info["nStages"] + (1 if dom == "ext" else 0)):
        sections[f"cm{i + 1}"] = rand(info["mapSectionsN"][f"cm{i + 1}"], n)
    return {"sections": sections, "x": rand(n), "Zi": rand(len(info["boundaries"]), n),
            "xDivXSubXi": rand(len(info["openingPoints"]), 3, n),
            "publics": rand(max(info["nPublics"], 1)),
            "challenges": rand(len(info["challengesMap"]), 3), "evals": rand(len(info["evMap"]), 3)}


def _tac_equal(got, want):
    assert sorted(got) == sorted(want) and sorted(got["cm"]) == sorted(want["cm"])
    for key in ("q", "f"):
        if key in want:
            assert torch.equal(got[key].cpu(), want[key].cpu()), key
    for key, v in want["cm"].items():
        assert torch.equal(got["cm"][key].cpu(), v.cpu()), key


@pytest.mark.parametrize("bits", [3, 8, 16, 21])
@pytest.mark.parametrize("which", torch_tac.PROGRAMS)
@pytest.mark.parametrize("name", ["all_8", "fibonacci_6"])
def test_tac_kernel_equals_plain(card, name, which, bits):
    """T1 (the kernel generated from the program) against run_plain on each
    committed program at 2^bits rows: fewer rows than a warp, one block,
    256 blocks, and a grid-stride loop."""
    setup = tsetup.read_setup(name)
    info = setup["starkInfo"]
    code, dom = torch_tac.device_program(info, setup["expressionsInfo"], which)
    extend = info["starkStruct"]["nBitsExt"] - info["starkStruct"]["nBits"]
    n_bits = bits if dom == "n" else bits - extend
    prog = torch_tac.compile_program(code, dom, info, n_bits, n_bits + extend)
    inputs = _tac_inputs(info, dom, 1 << bits, bits, card)
    before = cuda_tac.tac_program.launches
    got = torch_tac.run_kernel(prog, inputs)
    assert cuda_tac.tac_program.launches == before + 1
    _tac_equal(got, torch_tac.run_plain(prog, inputs))


def test_tac_segmented_program_on_card(card):
    code_obj, info, prog = tac_cases.segmented_case(12, 14)
    inputs = tac_cases.inputs_for(info, 1 << 14, 9, card)
    before = cuda_tac.tac_program.launches
    got = torch_tac.make_executor(code_obj, "ext", info, 12, 14)(inputs)
    assert cuda_tac.tac_program.launches == before + len(prog.segments) == before + 3
    _tac_equal(got, torch_tac.run_plain(prog, inputs))


@pytest.mark.parametrize("b_kind", ["column", "scalar"])
@pytest.mark.parametrize("da,db", tac_cases.MIXED)
@pytest.mark.parametrize("op", ["add", "sub", "mul", "muladd"])
def test_tac_mixed_dims_on_card(card, op, da, db, b_kind):
    code_obj, info, b = tac_cases.mixed_case("mul" if op == "muladd" else op, da, db, b_kind)
    if op == "muladd":
        code_obj["code"][0] = {"op": "muladd", "dest": {"type": "tmp", "id": 0},
                               "src": [{"type": "cm", "id": 0}, b, {"type": "cm", "id": 1}]}
    prog = torch_tac.compile_program(code_obj, "n", info, 10, 12)
    inputs = tac_cases.inputs_for(info, 1 << 10, da + db, card)
    _tac_equal(torch_tac.run_kernel(prog, inputs), torch_tac.run_plain(prog, inputs))


CORNERS = [0, 1, 2, 3, P - 1, P - 2, P - 3, (1 << 32) - 1, 1 << 32, (1 << 32) + 1,
           (1 << 63) - 1, 1 << 63, P - (1 << 32), P - (1 << 32) + 1, (1 << 31) + 7, 0x123456789]


@pytest.mark.parametrize("da,db", [(1, 1), (3, 3)])
@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_tac_field_ops_at_corners_on_card(card, op, da, db):
    """T1's field ops (csrc/f3.cuh, whose carries and borrows come from PTX
    carry chains on the card) on every pair of values near 0, 2^32, 2^63
    and p, against run_plain."""
    code_obj, info, _ = tac_cases.mixed_case(op, da, db, "column")
    prog = torch_tac.compile_program(code_obj, "n", info, 8, 10)
    inputs = tac_cases.inputs_for(info, 1 << 8, 3, card)
    grid = np.array(CORNERS, dtype=np.uint64)
    cols = [np.roll(np.repeat(grid, 16), 16 * j) for j in range(3)]
    cols += [np.roll(np.tile(grid, 16), j) for j in range(3)]
    inputs["sections"]["cm1"] = torch_gl.from_u64(np.stack(cols), card)
    _tac_equal(torch_tac.run_kernel(prog, inputs), torch_tac.run_plain(prog, inputs))


def test_tac_wide_program_on_card(card):
    """40 extension values live at once, more than any committed program:
    the generated kernel builds and equals run_plain."""
    code_obj, info, prog = tac_cases.wide_case(40, 14, 16)
    inputs = tac_cases.inputs_for(info, 1 << 16, 12, card)
    before = cuda_tac.tac_program.launches
    got = torch_tac.make_executor(code_obj, "ext", info, 14, 16)(inputs)
    assert cuda_tac.tac_program.launches == before + 1
    _tac_equal(got, torch_tac.run_plain(prog, inputs))


def test_tac_refuses_bad_inputs(card):
    """CPU tensors, a non-contiguous section and a section too short for a
    dim-3 column."""
    code_obj, info, prog = tac_cases.segmented_case(12, 14)
    gen = tac_codegen.generate(prog)
    cpu = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError):
        cuda_tac.tac_program(gen, [0] * gen.n_cols, cpu, 1 << 14)
    inputs = tac_cases.inputs_for(info, 1 << 14, 9, card)
    cm1 = inputs["sections"]["cm1"]
    inputs["sections"]["cm1"] = torch.cat([cm1] * 2, dim=1)[:, ::2]
    with pytest.raises(ValueError):
        torch_tac.run_kernel(prog, inputs)
    code_obj, info, _ = tac_cases.mixed_case("mul", 3, 3, "column")
    prog = torch_tac.compile_program(code_obj, "n", info, 10, 12)
    inputs = tac_cases.inputs_for(info, 1 << 10, 1, card)
    inputs["sections"]["cm1"] = inputs["sections"]["cm1"][:4]  # the dim-3 column at row 3 needs 6
    with pytest.raises(ValueError):
        torch_tac.run_kernel(prog, inputs)


@pytest.mark.parametrize("bits,n_open", [(10, 2), (20, 2), (12, 16)], ids=["10", "20", "12-16"])
def test_xdiv_kernel_equals_plain(card, bits, n_open):
    """T2 against its plain version; the last opening is x[5] itself, so
    x − xi is 0 there and both give 0.  16 openings: the most the kernel
    holds (kMaxOpenings)."""
    x = _rand((1 << bits,), bits, card)
    rng = np.random.default_rng(bits)
    xis = [tuple(int(v) for v in rng.integers(0, P, 3, dtype=np.uint64))
           for _ in range(n_open - 1)] + [(int(torch_gl.to_u64(x[5:6])[0]), 0, 0)]
    before = cuda_tac.gl_xdiv.launches
    got = stark_device.compute_xdiv(x, xis)
    assert cuda_tac.gl_xdiv.launches == before + 1
    assert torch.equal(got, stark_device.compute_xdiv_plain(x, xis))
    assert not got[-1, :, 5].any() and got[-1, :, 6].any()
    with pytest.raises(ValueError):
        cuda_tac.gl_xdiv(x.cpu(), xis)


def test_ntt_on_card_equals_cpu(card):
    x = _rand((2, 1 << 14), 3, "cpu")
    assert torch.equal(ntt.lde_planar(x.to(card), 14, 16).cpu(), ntt.lde_planar(x, 14, 16))


def test_fibonacci_proof_on_card_equals_cpu(card):
    from pil2_stark_tpu_torch.models import fibonacci
    from pil2_stark_tpu_torch.stark import prover, setup

    data = setup.read_setup("fibonacci_6")
    const_cols, cm_cols, publics = fibonacci.build(data["references"], 64)
    out = []
    for dev in (card, torch.device("cpu")):
        s = setup.load_setup(data["starkInfo"], data["expressionsInfo"], data["verifierInfo"],
                             const_cols.buffer, device=dev)
        res = prover.prove(s["starkInfo"], s["expressionsInfo"], const_cols.buffer,
                           s["constTree"], (cm_cols.buffer, publics), device=dev)
        out.append((_canon(res["proof"]), res["challenges"]))
    assert out[0] == out[1]


def test_compiled_setup_proves_on_the_default_device(card):
    """stark_setup and prove with device=None (the card a user gets): the
    const tree keeps the fixed columns on the card, two proves read them
    there and equal the CPU's proof from the committed setup."""
    import copy

    from pil2_stark_tpu_torch.models import fibonacci
    from pil2_stark_tpu_torch.stark import catalog, context, prover, setup

    assert context.resolve_device(None) == torch.device("cuda", torch.cuda.current_device())
    pil = catalog.machine_pil("fibonacci", 6)
    const_cols, cm_cols, publics = fibonacci.build(pil["references"], 64)
    s = setup.stark_setup(const_cols.buffer, pil, copy.deepcopy(fibonacci.STARK_STRUCT))
    base = s["constTree"].base
    assert base.device == card
    data = setup.read_setup("fibonacci_6")
    ref = setup.load_setup(data["starkInfo"], data["expressionsInfo"], data["verifierInfo"],
                           const_cols.buffer, device="cpu")
    want = prover.prove(ref["starkInfo"], ref["expressionsInfo"], const_cols.buffer,
                        ref["constTree"], (cm_cols.buffer, publics), device="cpu")
    for _ in range(2):
        res = prover.prove(s["starkInfo"], s["expressionsInfo"], const_cols.buffer,
                           s["constTree"], (cm_cols.buffer, publics))
        assert _canon(res["proof"]) == _canon(want["proof"])
    assert torch.equal(base.cpu(), torch_gl.from_u64(const_cols.buffer.T))


def _canon(o):
    if isinstance(o, np.ndarray):
        return [_canon(x) for x in o.tolist()]
    if isinstance(o, (list, tuple)):
        return [_canon(x) for x in o]
    if isinstance(o, dict):
        return {k: _canon(v) for k, v in o.items()}
    if isinstance(o, (int, np.integer)):
        return int(o)
    return o


def _vm_inputs(n, seed=3):
    return np.random.default_rng(seed).integers(0, P, size=(n // 32, 12), dtype=np.uint64)


def test_vm_proof_on_card_equals_cpu(card):
    """The Poseidon VM at 2^10 rows (ext 2^13): its 870-instruction Q
    program on T1 and every other kernel give the CPU's proof."""
    from pil2_stark_tpu_torch.models import poseidon_vm
    from pil2_stark_tpu_torch.stark import prover, setup, verifier

    data = setup.read_setup("poseidon_vm_10")
    const_cols, cm_cols, publics = poseidon_vm.build(data["references"], 1 << 10,
                                                     _vm_inputs(1 << 10))
    out = []
    for dev in (card, torch.device("cpu")):
        s = setup.load_setup(data["starkInfo"], data["expressionsInfo"], data["verifierInfo"],
                             const_cols.buffer, device=dev)
        res = prover.prove(s["starkInfo"], s["expressionsInfo"], const_cols.buffer,
                           s["constTree"], (cm_cols.buffer, publics), device=dev)
        out.append((_canon(res["proof"]), res["challenges"]))
    assert out[0] == out[1]
    assert verifier.verify(res["proof"], res["publics"], s["constRoot"], s["starkInfo"],
                           s["verifierInfo"])


def test_c12_recursive_proof_on_card_equals_cpu(card):
    """The smallest chain of the recursion tier: fibonacci 2^4 / ext 2^7
    with 2 queries, its verifier circuit through the port's circom
    front-end, and the 2^11-row C12 machine of it (blowup 2, 8 queries)
    proved on the card and on the CPU: the same proof, which verifies."""
    import copy

    from pil2_stark_tpu_torch.compiler import circom_front, compressor12, pil1_parser, pil2circom
    from pil2_stark_tpu_torch.models import fibonacci
    from pil2_stark_tpu_torch.stark import prover, setup, verifier
    from pil2_stark_tpu_torch.utils import proof2zkin

    pil = pil1_parser.compile_pil_source(fibonacci.pil_source(4))
    pil["name"] = "Fibonacci"
    const_cols, cm_cols, publics = fibonacci.build(pil["references"], 16, [1, 2])
    ss = {"nBits": 4, "nBitsExt": 7, "nQueries": 2, "verificationHashType": "GL",
          "steps": [{"nBits": 7}, {"nBits": 3}]}
    s = setup.stark_setup(const_cols.buffer, pil, ss, device=card)
    res = prover.prove(s["starkInfo"], s["expressionsInfo"], const_cols.buffer, s["constTree"],
                       (cm_cols.buffer, publics), device=card)
    zkin = proof2zkin.proof2zkin(res["proof"], s["starkInfo"])
    zkin["publics"] = [int(p) for p in publics]
    files = pil2circom.emit_circuit_files([int(v) for v in s["constRoot"]], s["starkInfo"],
                                          s["verifierInfo"])
    cc = circom_front.compile_and_witness(files, "verifier.circom", zkin)
    assert cc.check()
    c12 = compressor12.setup(cc)
    cm = compressor12.exec_witness(cc.witness, c12["plonkAdditions"], c12["sMap"], c12["nBits"])
    c12_publics = [int(x) for x in cc.witness[1:1 + c12["nPublics"]]]
    ss12 = {"nBits": 11, "nBitsExt": 12, "nQueries": 8, "verificationHashType": "GL",
            "steps": [{"nBits": 12}, {"nBits": 8}, {"nBits": 4}]}
    assert c12["nBits"] == 11
    out = []
    for dev in (card, torch.device("cpu")):
        s12 = setup.stark_setup(c12["constBuffer"], c12["pil"], copy.deepcopy(ss12), device=dev)
        r12 = prover.prove(s12["starkInfo"], s12["expressionsInfo"], c12["constBuffer"],
                           s12["constTree"], (cm, c12_publics), device=dev)
        out.append((_canon(r12["proof"]), r12["challenges"]))
    assert out[0] == out[1]
    assert verifier.verify(r12["proof"], r12["publics"], s12["constRoot"], s12["starkInfo"],
                           s12["verifierInfo"])


@pytest.mark.parametrize("flip", [False, True])
def test_debug_prove_on_card_equals_cpu(card, flip):
    """prove(debug=True) on the card runs the im-pol program on T1 and
    brings its columns to the host for the constraint check: the VM's
    valid witness gives no error, a flipped state element the CPU's
    errors."""
    from pil2_stark_tpu_torch.models import poseidon_vm
    from pil2_stark_tpu_torch.stark import prover, setup

    n = 1 << 6
    debug = setup.read_setup("poseidon_vm_6_debug")
    const_cols, cm_cols, _ = poseidon_vm.build(setup.read_setup("poseidon_vm_6")["references"],
                                               n, _vm_inputs(n))
    cm = cm_cols.buffer.copy()
    if flip:
        cm[7, 0] ^= np.uint64(1)
    before = cuda_tac.tac_program.launches
    errors = [prover.prove(debug["starkInfo"], debug["expressionsInfo"], const_cols.buffer,
                           None, (cm, []), debug=True, device=dev)
              for dev in (card, torch.device("cpu"))]
    assert cuda_tac.tac_program.launches == before + 1
    assert errors[0] == errors[1]
    assert bool(errors[0]) == flip


def test_profiler_writes_a_trace(card, tmp_path):
    """prove(profile_dir=) on the card: a Chrome trace with the prove's
    span and the kernels' device intervals, whose idle share is a share."""
    import json

    from pil2_stark_tpu_torch.models import fibonacci
    from pil2_stark_tpu_torch.stark import prover, setup
    from pil2_stark_tpu_torch.utils import timing

    data = setup.read_setup("fibonacci_6")
    const_cols, cm_cols, publics = fibonacci.build(data["references"], 64)
    s = setup.load_setup(data["starkInfo"], data["expressionsInfo"], data["verifierInfo"],
                         const_cols.buffer, device=card)
    res = prover.prove(s["starkInfo"], s["expressionsInfo"], const_cols.buffer, s["constTree"],
                       (cm_cols.buffer, publics), device=card, profile_dir=str(tmp_path))
    with open(res["trace"]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"prove", "stage1.commit", "friPol"} <= names
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    assert any("poseidon" in k for k in kernels), sorted(kernels)[:20]
    assert 0.0 <= timing.idle_share(res["trace"]) < 1.0


@pytest.mark.parametrize("custom", [False, True])
def test_bn128_proof_on_card_equals_cpu(card, custom):
    """BN128 trees on the host, transforms and T1/T2 on the card: the
    proof equals the CPU's and verifies; the const tree keeps the fixed
    columns on the card."""
    import copy

    from pil2_stark_tpu_torch.models import fibonacci
    from pil2_stark_tpu_torch.stark import catalog, prover, setup, verifier

    pil = catalog.machine_pil("fibonacci", 6)
    const_cols, cm_cols, publics = fibonacci.build(pil["references"], 64)
    ss = dict(copy.deepcopy(fibonacci.STARK_STRUCT), verificationHashType="BN128",
              merkleTreeArity=16, merkleTreeCustom=custom)
    out = []
    for dev in (card, torch.device("cpu")):
        s = setup.stark_setup(const_cols.buffer, copy.deepcopy(pil), copy.deepcopy(ss),
                              device=dev)
        assert s["constTree"].base.device == dev
        res = prover.prove(s["starkInfo"], s["expressionsInfo"], const_cols.buffer,
                           s["constTree"], (cm_cols.buffer, publics), device=dev)
        out.append((s["constRoot"], _canon(res["proof"]), res["challenges"]))
    assert out[0] == out[1]
    assert verifier.verify(res["proof"], res["publics"], s["constRoot"], s["starkInfo"],
                           s["verifierInfo"])


@pytest.mark.parametrize("case", ["plain", "custom"])
def test_snark_stark_proof_on_card_equals_cpu(card, case):
    """The snark path's STARK (chip_smoke.py snark phase): fibonacci 2^6 /
    ext 2^9 with BN128 trees and 4 queries, plain at arity 16 and custom at
    arity 4, proved on the default device (the card) equals the CPU's
    proof and verifies, and both setups give the same BN128 circuit."""
    import copy

    from pil2_stark_tpu_torch.compiler import pil2circom
    from pil2_stark_tpu_torch.models import fibonacci
    from pil2_stark_tpu_torch.stark import catalog, prover, setup, verifier

    pil = catalog.machine_pil("fibonacci", 6)
    const_cols, cm_cols, publics = fibonacci.build(pil["references"], 64)
    extra = ({"merkleTreeArity": 16} if case == "plain"
             else {"merkleTreeArity": 4, "merkleTreeCustom": True})
    ss = dict(copy.deepcopy(fibonacci.STARK_STRUCT), verificationHashType="BN128", nQueries=4,
              **extra)
    out = []
    for dev in (None, torch.device("cpu")):
        s = setup.stark_setup(const_cols.buffer, copy.deepcopy(pil), copy.deepcopy(ss),
                              device=dev)
        res = prover.prove(s["starkInfo"], s["expressionsInfo"], const_cols.buffer,
                           s["constTree"], (cm_cols.buffer, publics), device=dev)
        out.append((s["constRoot"], _canon(res["proof"]), res["challenges"],
                    pil2circom.pil2circom(s["constRoot"], s["starkInfo"], s["verifierInfo"])))
    assert out[0] == out[1]
    assert verifier.verify(res["proof"], res["publics"], s["constRoot"], s["starkInfo"],
                           s["verifierInfo"])


def test_cli_prove_files_on_card_equal_cpu(card, tmp_path):
    """python -m pil2_stark_tpu_torch prove on the card (the default
    device) writes the files the same command writes with --device cpu."""
    from pil2_stark_tpu_torch.__main__ import main

    argv = ["prove", "--model", "fibonacci", "--nbits", "6", "--tmp"]
    main(argv + [str(tmp_path / "card")])
    main(argv + [str(tmp_path / "cpu"), "--device", "cpu"])
    for name in ("proof.json", "publics.json", "zkin.json", "verkey.json", "starkinfo.json",
                 "verifierinfo.json"):
        assert (tmp_path / "card" / name).read_bytes() == (tmp_path / "cpu" / name).read_bytes()


@pytest.mark.parametrize("width,height", [(0, 1 << 10), (3, 1 << 12), (39, 1 << 12)])
def test_card_tree_file_equals_host(card, tmp_path, width, height):
    """write_tree of a tree built on the card (stark.device.to_host_tree)
    gives the bytes of the host tree of the same columns."""
    buff = np.random.default_rng(width).integers(0, P, size=(height, width), dtype=np.uint64)
    cols = torch_gl.from_u64(np.ascontiguousarray(buff.T)).reshape(width, height)
    a, b = str(tmp_path / "card.bin"), str(tmp_path / "cpu.bin")
    merkle.write_tree(stark_device.to_host_tree(stark_device.merkelize(cols.to(card), width,
                                                                       height)), a)
    merkle.write_tree(stark_device.to_host_tree(stark_device.merkelize(cols, width, height)), b)
    assert open(a, "rb").read() == open(b, "rb").read()
    if width:
        assert open(b, "rb").read() == _host_tree_bytes(buff, width, height, tmp_path)


def _host_tree_bytes(buff, width, height, tmp_path):
    path = str(tmp_path / "host.bin")
    merkle.write_tree(merkle.merkelize(buff, width, height), path)
    return open(path, "rb").read()


# ---------------------------------------------------------------------------
# the multi-device prover (parallel/): virtual ranks on one card, and every
# card of the machine where it has two or more


def _card_mesh(kind):
    from pil2_stark_tpu_torch.parallel import distributed

    if kind == "cards":
        if torch.cuda.device_count() < 2:
            pytest.skip("needs two or more cards")
        return distributed.proof_mesh()
    return distributed.proof_mesh(devices=[torch.device("cuda", 0)] * 4)


@pytest.mark.parametrize("kind", ["virtual4", "cards"])
def test_sharded_ntt_lde_tree_on_card(card, kind):
    """The sharded transform (forward and inverse, and above 2^12 points
    the planar factors), the LDE and the tree equal one device's."""
    from pil2_stark_tpu_torch.parallel import merkle_sharded, ntt_sharded

    mesh = _card_mesh(kind)
    for bits, cols in ((10, 3), (18, 5)):
        x = _rand((cols, 1 << bits), bits, card)
        for inverse in (False, True):
            got = mesh.gather(ntt_sharded.sharded_ntt(mesh.scatter(x), bits, mesh, inverse))
            assert torch.equal(got, ntt.planar_ntt(x, bits, inverse))
    x = _rand((4, 1 << 16), 7, card)
    ext = ntt_sharded.sharded_lde(mesh.scatter(x), 16, 19, mesh)
    want = ntt.lde_planar(x, 16, 19)
    assert torch.equal(mesh.gather(ext), want)
    tree = merkle_sharded.merkelize(mesh, ext, 4, 1 << 19)
    single = stark_device.merkelize(want, 4, 1 << 19)
    assert all(torch.equal(a, b) for a, b in zip(tree.levels, single.levels))
    assert mesh.exchanged_bytes > 0
    torch.cuda.synchronize()


def test_kernels_launch_on_the_tensors_card(card):
    """Every wrapper launches on its tensor's card: B1-B4 and T2 on cuda:1
    equal their plain versions, and a fibonacci prove on cuda:1 (T1 too)
    equals the CPU's."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more cards")
    from pil2_stark_tpu_torch.models import fibonacci
    from pil2_stark_tpu_torch.stark import prover, setup

    other = torch.device("cuda", 1)
    assert torch.cuda.current_device() == 0
    x = _rand((3, 1 << 16), 11, other)
    lt = ntt.level_twiddles(16, 4, False, other)
    y = cuda_ntt.level_planar(x, 4, 1 << 12, 3, lt, False)
    assert torch.equal(y, cuda_ntt.level_planar_plain(x, 4, 1 << 12, 3, lt, False))
    assert torch.equal(cuda_ntt.base_grid(y, 12, 3, False),
                       cuda_ntt.base_grid_plain(y, 12, 3, False))
    rows = x.reshape(1 << 12, 48)
    assert torch.equal(cuda_ntt.base_rows(rows, 12, True),
                       cuda_ntt.base_rows_plain(rows, 12, True))
    st = _rand((12, 1 << 12), 12, other)
    assert torch.equal(cuda_poseidon.permute(st), cuda_poseidon.permute_plain(st))
    xs = x[0].contiguous()
    xis = [(5, 6, 7), (8, 9, 10)]
    assert torch.equal(cuda_tac.gl_xdiv(xs, xis), stark_device.compute_xdiv_plain(xs, xis))
    data = setup.read_setup("fibonacci_6")
    const_cols, cm_cols, publics = fibonacci.build(data["references"], 64)
    out = []
    for dev in (other, torch.device("cpu")):
        s = setup.load_setup(data["starkInfo"], data["expressionsInfo"], data["verifierInfo"],
                             const_cols.buffer, device=dev)
        res = prover.prove(s["starkInfo"], s["expressionsInfo"], const_cols.buffer,
                           s["constTree"], (cm_cols.buffer, publics), device=dev)
        out.append(_canon(res["proof"]))
    assert out[0] == out[1]
    torch.cuda.synchronize(other)


@pytest.mark.parametrize("name", ["all_8", "poseidon_vm_6"])
@pytest.mark.parametrize("kind", ["virtual4", "cards"])
def test_mesh_proof_on_card_equals_cpu(card, name, kind):
    """prove(mesh=) on the card equals the CPU's single-device proof and
    verifies; the fixed columns stay on the lead card."""
    from pil2_stark_tpu_torch.models import gadgets, poseidon_vm
    from pil2_stark_tpu_torch.stark import prover, setup, verifier

    mesh = _card_mesh(kind)
    data = setup.read_setup(name)
    n = 1 << data["nBits"]
    if name == "all_8":
        const_cols, cm_cols, publics = gadgets.build_all(data["references"], n)
    else:
        const_cols, cm_cols, publics = poseidon_vm.build(data["references"], n, _vm_inputs(n))
    out = []
    for dev, m in ((mesh.lead, mesh), (torch.device("cpu"), None)):
        s = setup.load_setup(data["starkInfo"], data["expressionsInfo"], data["verifierInfo"],
                             const_cols.buffer, device=dev)
        res = prover.prove(s["starkInfo"], s["expressionsInfo"], const_cols.buffer,
                           s["constTree"], (cm_cols.buffer, publics), mesh=m,
                           device=None if m else dev)
        out.append(_canon(res["proof"]))
        if m is not None:
            assert set(res["devicePeakBytes"]["stage1.commit"]) == {
                str(d) for d in mesh.local_devices()}
    assert out[0] == out[1]
    assert verifier.verify(res["proof"], res["publics"], s["constRoot"], s["starkInfo"],
                           s["verifierInfo"])
