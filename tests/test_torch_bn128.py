"""BN128 trees in the port against the JAX package on the CPU:
Poseidon-BN254 at every width, the arity-16 Merkle tree (plain and custom
padding), the BN128 transcript, and the final-tier STARK end to end:
fibonacci 2^6 with verificationHashType BN128, whose constRoot, proof and
challenges equal the JAX package's, which the port's verifier accepts and
which uploads the fixed columns zero times (fault C3 stays closed)."""
import copy

import numpy as np
import pytest
import torch

from pil2_stark_tpu.hash import merkle_bn128 as jmerkle, poseidon_bn128 as jposeidon
from pil2_stark_tpu.hash.transcript_bn128 import TranscriptBN128 as JTranscript
from pil2_stark_tpu.models import fibonacci as jfib
from pil2_stark_tpu.stark import prover as jprover, setup as jsetup
from pil2_stark_tpu_torch.field import torch_gl
from pil2_stark_tpu_torch.hash import merkle_bn128, poseidon_bn128
from pil2_stark_tpu_torch.hash.mh import MerkleHashBN128, TreeBN128, build_mh
from pil2_stark_tpu_torch.hash.transcript_bn128 import TranscriptBN128
from pil2_stark_tpu_torch.stark import context, prover, setup, verifier

from test_torch_cases import canon, case_inputs

P_GL = 0xFFFFFFFF00000001


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch's multi-threaded int64 ops are slow on small CPU tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_poseidon_circomlib_vector():
    assert (poseidon_bn128.poseidon([1, 2])
            == 7853200120776062878684798364095072458815029376092732009249414926327459813530)


@pytest.mark.parametrize("t", range(2, 18))
def test_poseidon_equals_jax(t):
    rng = np.random.default_rng(t)
    inputs = [int.from_bytes(rng.bytes(32), "little") % poseidon_bn128.P for _ in range(t - 1)]
    init = int.from_bytes(rng.bytes(32), "little")
    for n_out in (1, t):
        assert (poseidon_bn128.poseidon(inputs, init, n_out)
                == jposeidon.poseidon(inputs, init, n_out))


def test_poseidon_refuses_widths_out_of_range():
    for n in (0, 17):
        with pytest.raises(ValueError, match="Invalid poseidon width"):
            poseidon_bn128.poseidon([1] * n)


@pytest.fixture(scope="module", params=[(33, 5), (16, 3), (300, 9)],
                ids=["33x5", "16x3", "300x9"])
def shape(request):
    return request.param


@pytest.mark.parametrize("custom", [False, True])
def test_merkle_equals_jax(shape, custom):
    height, width = shape
    buff = np.random.default_rng(height).integers(0, P_GL, size=(height, width), dtype=np.uint64)
    jtree = jmerkle.merkelize(buff, width, height, 16, custom)
    # through the port's hash backend, from planar columns
    tree = MerkleHashBN128(16, custom).merkelize(
        torch_gl.from_u64(np.ascontiguousarray(buff.T)), width, height)
    assert isinstance(tree, TreeBN128) and (tree.host.width, tree.host.height) == (width, height)
    assert tree.root == jtree.root
    assert tree.host.levels == jtree.levels
    idxs = [0, 1, height // 2, height - 1]
    proofs = MerkleHashBN128(16, custom).get_group_proofs_multi([tree], [idxs])[0]
    for idx, (values, proof) in zip(idxs, proofs):
        jvalues, jproof = jmerkle.get_group_proof(jtree, idx)
        np.testing.assert_array_equal(values, jvalues)
        assert proof == jproof
        assert merkle_bn128.verify_group_proof(tree.root, proof, idx, values, 16, custom)
        bad = values.copy()
        bad[0] ^= np.uint64(1)
        assert not merkle_bn128.verify_group_proof(tree.root, proof, idx, bad, 16, custom)


@pytest.mark.parametrize("n_inputs,custom", [(16, False), (16, True), (4, True)])
def test_transcript_equals_jax(n_inputs, custom):
    outs = []
    for cls in (TranscriptBN128, JTranscript):
        t = cls(n_inputs, custom)
        t.put([1, 2, 3])
        t.put(12345678901234567890)
        t.put(list(range(40)))
        fields = [t.get_field() for _ in range(5)]
        state = t.get_state()
        t.put(7)
        outs.append((fields, state, t.get_permutations(40, 13)))
    assert outs[0] == outs[1]
    assert all(0 <= x < 1 << 64 for f in outs[0][0] for x in f)
    assert all(0 <= q < 1 << 13 for q in outs[0][2])


def test_build_mh_picks_bn128():
    mh = build_mh({"verificationHashType": "BN128", "merkleTreeArity": 16,
                   "merkleTreeCustom": True})
    assert (mh.hash_type, mh.arity, mh.custom) == ("BN128", 16, True)
    assert isinstance(mh.new_transcript(), TranscriptBN128)
    with pytest.raises(ValueError, match="Invalid Hash Type"):
        build_mh({"verificationHashType": "SHA"})


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "custom"])
def bn128_proofs(request):
    """fibonacci 2^6 with BN128 trees (tests/test_bn128.py:59), proved by
    the JAX package and by the port on the CPU; the port's fixed-column
    uploads counted."""
    pil, const_cols, cm_cols, publics = case_inputs("fibonacci_6")
    ss = dict(copy.deepcopy(jfib.STARK_STRUCT), verificationHashType="BN128",
              merkleTreeArity=16, merkleTreeCustom=request.param)
    fixed = const_cols.buffer
    js = jsetup.stark_setup(fixed, copy.deepcopy(pil), copy.deepcopy(ss))
    jres = jprover.prove(js["starkInfo"], js["expressionsInfo"], fixed, js["constTree"],
                         (cm_cols.buffer, publics))
    ts = setup.stark_setup(fixed, copy.deepcopy(pil), copy.deepcopy(ss), device="cpu")
    uploads = []
    with pytest.MonkeyPatch.context() as mp:
        real_from_u64, real_ctx = torch_gl.from_u64, context.ProverCtx

        def from_u64(a, device=None):
            arr = np.asarray(a)
            if arr.shape == fixed.T.shape and np.array_equal(arr, fixed.T):
                uploads.append(arr.shape)
            return real_from_u64(a, device)

        ctxs = []

        class Ctx(real_ctx):
            def __init__(self, *args, **kwargs):
                ctxs.append(self)
                super().__init__(*args, **kwargs)

        mp.setattr(torch_gl, "from_u64", from_u64)
        mp.setattr(prover, "ProverCtx", Ctx)
        tres = prover.prove(ts["starkInfo"], ts["expressionsInfo"], fixed, ts["constTree"],
                            (cm_cols.buffer, publics), device="cpu")
    return js, jres, ts, tres, uploads, ctxs[0]


def test_bn128_const_root_equals_jax(bn128_proofs):
    js, _, ts, _, _, _ = bn128_proofs
    assert isinstance(ts["constRoot"], int)
    assert ts["constRoot"] == js["constRoot"]


def test_bn128_proof_equals_jax(bn128_proofs):
    _, jres, _, tres, _, _ = bn128_proofs
    assert canon(tres["proof"]) == canon(jres["proof"])
    assert tres["challenges"] == jres["challenges"]
    assert tres["challengesFRISteps"] == jres["challengesFRISteps"]


def test_bn128_verifier_accepts_and_rejects_a_changed_public(bn128_proofs):
    _, _, ts, tres, _, _ = bn128_proofs
    args = (ts["constRoot"], ts["starkInfo"], ts["verifierInfo"])
    assert verifier.verify(tres["proof"], tres["publics"], *args)
    bad = list(tres["publics"])
    bad[0] = 9
    assert not verifier.verify(tres["proof"], bad, *args)


def test_bn128_prove_reads_the_setup_fixed_columns(bn128_proofs):
    _, _, ts, _, uploads, ctx = bn128_proofs
    tree = ts["constTree"]
    assert isinstance(tree, TreeBN128)
    assert uploads == []
    assert ctx.dsections["n"]["const"].data_ptr() == tree.base.data_ptr()
    assert ctx.dsections["ext"]["const"].data_ptr() == tree.elements.data_ptr()
