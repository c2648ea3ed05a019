"""PyTorch port's multi-device prover on the CPU: meshes of virtual CPU
ranks, the counterparts of tests/test_parallel.py and
tests/test_distributed.py.

The sharded NTT, LDE and Merkle tree (pil2_stark_tpu_torch/parallel/) on
an 8-rank ("ici",) mesh and on the (dcn=2, ici=4) mesh of `hosts=2` equal
the port's single-device route, the JAX package's host oracles and, once,
the JAX package's shard_map transform on the conftest's 8 CPU devices.
Proofs with `mesh=` (fibonacci 2^6 on both meshes, the Poseidon VM 2^6 on
4 ranks) equal the JAX package's backend="numpy" proof and the port's
single-device proof, and verify; two processes wired by gloo, each driving
4 ranks, both end with the proof of one device.  Tolerance: none — exact
field arithmetic, compared bit for bit.  torch runs on one thread: these
shapes are small, and the test workers share the host's cores.
"""
import json
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from pil2_stark_tpu.field import jax_gl
from pil2_stark_tpu.hash import merkle as jmerkle
from pil2_stark_tpu.ops import ntt as jntt
from pil2_stark_tpu.parallel import ntt_sharded as jsharded
from pil2_stark_tpu.stark import verifier as jverifier
from pil2_stark_tpu_torch.field import gl64, torch_gl
from pil2_stark_tpu_torch.ops import ntt
from pil2_stark_tpu_torch.parallel import distributed, merkle_sharded, ntt_sharded
from pil2_stark_tpu_torch.stark import device as tdevice
from pil2_stark_tpu_torch.stark import prover as tprover, setup as tsetup
from pil2_stark_tpu_torch.stark import verifier as tverifier

from test_torch_cases import canon, case_inputs, prove_both
from test_torch_import_guard import REPO

P = 0xFFFFFFFF00000001
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["ici8", "dcn2_ici4"])
def mesh(request):
    return distributed.proof_mesh(devices=[CPU] * 8, hosts=2 if request.param != "ici8" else None)


def _rand(shape, seed):
    return np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)


def _sharded(mesh, fn, x_planar):
    """fn over the sharded array of a planar host array, gathered back."""
    out = fn(mesh.scatter(torch_gl.from_u64(x_planar, CPU)))
    return torch_gl.to_u64(mesh.gather(out))


@pytest.mark.parametrize("inverse", [False, True])
def test_sharded_ntt_matches_single(mesh, inverse):
    bits, cols = 8, 3
    x = _rand((1 << bits, cols), 0)  # row-major, as the JAX oracle takes it
    got = _sharded(mesh, lambda s: ntt_sharded.sharded_ntt(s, bits, mesh, inverse), x.T)
    single = torch_gl.to_u64(ntt.planar_ntt(torch_gl.from_u64(x.T, CPU), bits, inverse))
    np.testing.assert_array_equal(got, single)
    if inverse:  # the oracle scales by 1/n
        want = jntt.intt_u64(x, bits).T
        got = gl64.mul(got, np.uint64(pow(1 << bits, P - 2, P)))
    else:
        want = jntt.ntt_u64(x, bits).T
    np.testing.assert_array_equal(got, want)


def test_sharded_ntt_matches_jax_shard_map():
    """The JAX package's own sharded transform on 8 CPU devices."""
    bits, cols = 8, 3
    x = _rand((1 << bits, cols), 1)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:8]), ("x",))
    fn = jsharded.make_sharded_ntt(bits, cols, jmesh)
    want = jax_gl.to_u64(fn(*jax_gl.from_u64(x))) % np.uint64(P)
    mesh = distributed.proof_mesh(devices=[CPU] * 8)
    got = _sharded(mesh, lambda s: ntt_sharded.sharded_ntt(s, bits, mesh), x.T)
    np.testing.assert_array_equal(got, want.T)


def test_sharded_lde_matches_single(mesh):
    bits, ext_bits, cols = 6, 8, 2
    x = _rand((1 << bits, cols), 2)
    got = _sharded(mesh, lambda s: ntt_sharded.sharded_lde(s, bits, ext_bits, mesh), x.T)
    single = torch_gl.to_u64(ntt.lde_planar(torch_gl.from_u64(x.T, CPU), bits, ext_bits))
    np.testing.assert_array_equal(got, single)
    np.testing.assert_array_equal(got, jntt.lde_u64(x, bits, ext_bits).T)


@pytest.mark.parametrize("inverse", [False, True])
def test_sharded_ntt_row_route(inverse):
    """Above the planar ceiling (lowered to 2^5, the row base to 2^3) each
    rank's local transforms take the row route: axis0_ntt's recursion."""
    bits, cols = 8, 2
    x = _rand((cols, 1 << bits), 3)
    mesh = distributed.proof_mesh(devices=[CPU] * 4)
    calls = []
    real_axis0 = ntt.axis0_ntt
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ntt, "MAX_BITS", 5)
        mp.setattr(ntt, "BASE_BITS", 3)
        mp.setattr(ntt, "axis0_ntt", lambda v, b, inv: calls.append(b) or real_axis0(v, b, inv))
        got = _sharded(mesh, lambda s: ntt_sharded.sharded_ntt(s, bits, mesh, inverse), x)
        single = torch_gl.to_u64(ntt.planar_ntt(torch_gl.from_u64(x, CPU), bits, inverse))
    assert calls.count(4) >= 2 * mesh.size  # both factors of 2^4 on every rank
    np.testing.assert_array_equal(got, single)
    if not inverse:
        np.testing.assert_array_equal(got, jntt.ntt_u64(x.T, bits).T)


def test_unsupported_shapes_raise():
    mesh = distributed.proof_mesh(devices=[CPU] * 8)
    x = torch_gl.from_u64(_rand((1, 1 << 5), 4), CPU)
    with pytest.raises(ValueError, match="must divide both factors"):
        ntt_sharded.sharded_ntt(mesh.scatter(x), 5, mesh)  # 2^2 x 2^3
    with pytest.raises(ValueError, match="power-of-two height"):
        merkle_sharded.merkelize(mesh, [x[:, :3]] * 8, 1, 24)
    with pytest.raises(ValueError, match="do not split"):
        distributed.proof_mesh(devices=[CPU] * 3).scatter(x)
    with pytest.raises(ValueError, match="divide evenly"):
        distributed.proof_mesh(devices=[CPU] * 6, hosts=4)


@pytest.mark.parametrize("width", [3, 9])
def test_sharded_merkle_root_matches_single(mesh, width):
    height = 256
    buff = _rand((height, width), 5)
    tree = merkle_sharded.merkelize(mesh, mesh.scatter(torch_gl.from_u64(buff.T, CPU)),
                                    width, height)
    np.testing.assert_array_equal(tree.root, jmerkle.merkelize(buff, width, height).root)


def test_sharded_merkle_levels_match_single(mesh):
    """Every level equals the host tree's and the single-device tree's, the
    split linear hash's too; the tree keeps each rank's rows on that rank
    (gathered here only to compare)."""
    height, width = 256, 5
    buff = _rand((height, width), 6)
    cols = torch_gl.from_u64(buff.T, CPU)
    want = jmerkle.merkelize(buff, width, height, backend="np")
    tree = merkle_sharded.merkelize(mesh, mesh.scatter(cols), width, height)
    levels = tree.gather_levels()
    assert len(levels) == len(want.levels)
    for k, (lvl, ref) in enumerate(zip(levels, want.levels)):
        np.testing.assert_array_equal(torch_gl.to_u64(lvl.T), ref, err_msg=f"level {k}")
    assert torch.equal(mesh.gather(tree.shards), cols)
    assert all(s.shape == (width, height // mesh.size) for s in tree.shards)
    split = merkle_sharded.merkelize(mesh, mesh.scatter(cols), width, height, split=True)
    single = tdevice.merkelize(cols, width, height, split=True)
    split_levels = split.gather_levels()
    assert len(split_levels) == len(single.levels)
    assert all(torch.equal(a, b) for a, b in zip(split_levels, single.levels))


def test_zero_width_tree_is_uniform(mesh):
    tree = merkle_sharded.merkelize(mesh, [None] * 8, 0, 256)
    single = tdevice.merkelize(torch.zeros((0, 256), dtype=torch.int64), 0, 256)
    assert tree.uniform and tree.elements.shape == (0, 256)
    np.testing.assert_array_equal(tree.root, single.root)


def test_proof_mesh_shapes():
    mesh2d = distributed.proof_mesh(devices=[CPU] * 8, hosts=2)
    assert mesh2d.axis_names == ("dcn", "ici")
    assert mesh2d.shape == {"dcn": 2, "ici": 4} and mesh2d.size == 8
    assert mesh2d.devices.shape == (2, 4) and mesh2d.lead == CPU
    single = distributed.proof_mesh(devices=[CPU] * 8)
    assert single.axis_names == ("ici",) and single.shape == {"ici": 8}
    assert list(single.local_ranks) == list(range(8))


def test_init_distributed_single_process_noop():
    distributed.init_distributed()  # must not raise without a coordinator
    distributed.init_distributed(num_processes=1)
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="coordinator"):
        distributed.init_distributed(num_processes=2)


def test_init_distributed_failure_raises():
    """An explicit request that fails raises (no server at the address)."""
    with pytest.raises(RuntimeError, match="timed out"):
        distributed.init_distributed("localhost:1", 2, 1, backend="gloo", timeout_s=1)
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------------
# proofs


def _mesh_prove(name, mesh):
    _, const_cols, cm_cols, publics = case_inputs(name)
    data = tsetup.read_setup(name)
    ts = tsetup.load_setup(data["starkInfo"], data["expressionsInfo"], data["verifierInfo"],
                           const_cols.buffer, device="cpu")
    res = tprover.prove(ts["starkInfo"], ts["expressionsInfo"], const_cols.buffer,
                        merkle_sharded.shard_tree(ts["constTree"], mesh),
                        (cm_cols.buffer, publics), mesh=mesh)
    return ts, res


@pytest.fixture(scope="module")
def fib_proofs():
    return prove_both("fibonacci_6")


def test_fibonacci_mesh_proof_equals_single(mesh, fib_proofs):
    js, jres, _, tres = fib_proofs
    ts, res = _mesh_prove("fibonacci_6", mesh)
    assert json.dumps(canon(res["proof"])) == json.dumps(canon(jres["proof"]))
    assert canon(res["proof"]) == canon(tres["proof"])
    assert res["challenges"] == tres["challenges"]
    assert tverifier.verify(res["proof"], res["publics"], ts["constRoot"], ts["starkInfo"],
                            ts["verifierInfo"])
    assert jverifier.verify(res["proof"], res["publics"], js["constRoot"], js["starkInfo"],
                            js["verifierInfo"])
    assert mesh.exchanged_bytes > 0


def test_vm_mesh_proof_equals_single():
    mesh = distributed.proof_mesh(devices=[CPU] * 4)
    _, jres, _, tres = prove_both("poseidon_vm_6")
    ts, res = _mesh_prove("poseidon_vm_6", mesh)
    assert canon(res["proof"]) == canon(jres["proof"]) == canon(tres["proof"])
    assert tverifier.verify(res["proof"], res["publics"], ts["constRoot"], ts["starkInfo"],
                            ts["verifierInfo"])


def test_mesh_prove_refusals(fib_proofs):
    mesh = distributed.proof_mesh(devices=[CPU] * 4)
    _, const_cols, cm_cols, publics = case_inputs("fibonacci_6")
    ts = fib_proofs[2]
    args = (ts["starkInfo"], ts["expressionsInfo"], const_cols.buffer, ts["constTree"],
            (cm_cols.buffer, publics))
    with pytest.raises(ValueError, match="debug"):
        tprover.prove(*args, mesh=mesh, debug=True)
    with pytest.raises(ValueError, match="lead device"):
        tprover.prove(*args, mesh=mesh, device="meta")
    bn = dict(ts["starkInfo"], starkStruct=dict(ts["starkInfo"]["starkStruct"],
                                                verificationHashType="BN128"))
    with pytest.raises(ValueError, match="BN128"):
        tprover.prove(bn, *args[1:], mesh=mesh)
    with pytest.raises(ValueError, match="split over its mesh"):
        tprover.prove(*args, mesh=mesh)
    with pytest.raises(ValueError, match="split over its mesh"):  # another mesh's split
        tprover.prove(*args[:3], merkle_sharded.shard_tree(ts["constTree"], mesh), args[4],
                      mesh=distributed.proof_mesh(devices=[CPU] * 4))
    sixteen = distributed.proof_mesh(devices=[CPU] * 16)
    with pytest.raises(ValueError, match="must divide both factors"):  # 2^6 over 16 ranks
        tprover.prove(*args[:3], merkle_sharded.shard_tree(ts["constTree"], sixteen), args[4],
                      mesh=sixteen)


WORKER = r'''
import hashlib, json, sys
import numpy as np, torch
torch.set_num_threads(1)
from pil2_stark_tpu_torch.models import fibonacci
from pil2_stark_tpu_torch.parallel import distributed, merkle_sharded
from pil2_stark_tpu_torch.stark import prover, setup
rank, port = int(sys.argv[1]), sys.argv[2]
distributed.init_distributed(f"localhost:{port}", 2, rank, backend="gloo", timeout_s=50)
mesh = distributed.proof_mesh(devices=["cpu"] * 4)
assert mesh.shape == {"dcn": 2, "ici": 4} and list(mesh.local_ranks) == [4 * rank + i for i in range(4)]
data = setup.read_setup("fibonacci_6")
const_cols, cm_cols, publics = fibonacci.build(data["references"], 64)
s = setup.load_setup(data["starkInfo"], data["expressionsInfo"], data["verifierInfo"],
                     const_cols.buffer, device="cpu")
res = prover.prove(s["starkInfo"], s["expressionsInfo"], const_cols.buffer,
                   merkle_sharded.shard_tree(s["constTree"], mesh), (cm_cols.buffer, publics),
                   mesh=mesh)
def canon(o):
    if isinstance(o, np.ndarray): return canon(o.tolist())
    if isinstance(o, (list, tuple)): return [canon(x) for x in o]
    if isinstance(o, dict): return {k: canon(v) for k, v in o.items()}
    return int(o) if isinstance(o, (int, np.integer)) else o
print("PROOF", hashlib.sha256(json.dumps(canon(res["proof"])).encode()).hexdigest(),
      mesh.exchanged_bytes, flush=True)
torch.distributed.destroy_process_group()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_processes_prove_as_one_device(fib_proofs):
    """The (dcn=2, ici=4) mesh over two real processes (gloo): each drives
    4 CPU ranks, and both end with the single device's proof."""
    import hashlib

    want = hashlib.sha256(json.dumps(canon(fib_proofs[3]["proof"])).encode()).hexdigest()
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), port], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=60))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for (out, err), p in zip(outs, procs):
        assert p.returncode == 0, err[-3000:]
        line = next(ln for ln in out.splitlines() if ln.startswith("PROOF"))
        digest, moved = line.split()[1:]
        assert digest == want and int(moved) > 0
