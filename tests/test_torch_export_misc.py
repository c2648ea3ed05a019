"""PyTorch port, the rest of the export leg and the host C++ runtime, held
against the JAX package on the CPU: the fflonk search optimizer's cost
table and picks (fixed ratio; a measured ratio is positive), Goldilocks
``sqrt``, and the host runtime (runtime/native.py on csrc/host/runtime.cpp)
against the numpy and python-int versions it replaces and the JAX
package's own runtime, through the Merkle trees, path checks and
transcript that use it.  A failed host build raises."""
import numpy as np
import pytest

from pil2_stark_tpu.fflonk import search_optimizer as jso
from pil2_stark_tpu.field import sqrt as jsqrt
from pil2_stark_tpu.runtime import native as jnative
from pil2_stark_tpu_torch.fflonk import search_optimizer as so
from pil2_stark_tpu_torch.field import sqrt as tsqrt
from pil2_stark_tpu_torch.hash import linearhash, merkle, poseidon_gl, transcript
from pil2_stark_tpu_torch.protocol.shplonk import dev_ptau
from pil2_stark_tpu_torch.runtime import native
from pil2_stark_tpu_torch.utils import host_build

P = 0xFFFFFFFF00000001


def _rand(shape, seed):
    return np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)


def test_search_optimizer_equals_jax():
    for args in ((3, 10, 6, 4, 10, 100.0), (3, 10, 27, 0, 1, 0.5), (4, 8, 20, 7, 3, 1e6)):
        assert so.fflonk_cost_table(*args) == jso.fflonk_cost_table(*args)
    for power, n_i, n_p, ratio in ((6, 4, 10, 1e9), (6, 0, 1, 0.0), (12, 3, 9, 37.5)):
        got = so.exhaustive_search_optimizer(power, n_intermediate=n_i, n_p=n_p, ratio=ratio)
        assert got == jso.exhaustive_search_optimizer(power, n_intermediate=n_i, n_p=n_p,
                                                      ratio=ratio)
    for mod in (so, jso):
        with pytest.raises(ValueError, match="feasible"):
            mod.exhaustive_search_optimizer(28, n_intermediate=0, n_p=1, ratio=1.0)
    ptau = dev_ptau(64, tau=5)
    assert so.ratio_msm_to_fft(ptau, 6, iterations=1) > 0
    best = so.exhaustive_search_optimizer(6, n_intermediate=2, n_p=4, ptau=ptau, iterations=1)
    assert 3 <= best["degP"] <= 10


def test_sqrt_equals_jax():
    rng = np.random.default_rng(11)
    values = [0, 1, 7, P - 1] + [int(v) for v in rng.integers(0, P, size=40, dtype=np.uint64)]
    values += [int(v) * int(v) % P for v in rng.integers(1, P, size=40, dtype=np.uint64)]
    roots = 0
    for v in values:
        got = tsqrt.sqrt(v)
        assert got == jsqrt.sqrt(v)
        assert tsqrt.legendre(v) == jsqrt.legendre(v)
        if got is not None:
            assert got * got % P == v % P
            roots += 1
    assert 40 <= roots < len(values)


def test_native_runtime_equals_plain_and_jax():
    assert jnative.native_available()
    a, b = _rand((1000,), 1), _rand((1000,), 2)
    for fn, jfn, plain in ((native.gl64_mul, jnative.gl64_mul, lambda x, y: [x * y % P]),
                           (native.gl64_add, jnative.gl64_add, lambda x, y: [(x + y) % P]),
                           (native.gl64_sub, None, lambda x, y: [(x - y) % P])):
        got = fn(a, b)
        assert [int(v) for v in got] == [plain(int(x), int(y))[0] for x, y in zip(a, b)]
        if jfn is not None:
            np.testing.assert_array_equal(got, jfn(a, b))
    states = _rand((33, 12), 3)
    np.testing.assert_array_equal(native.poseidon_permute(states), poseidon_gl.permute(states))
    np.testing.assert_array_equal(native.poseidon_permute(states), jnative.poseidon_permute(states))
    assert native.permute_int([int(v) for v in states[0]]) == \
        poseidon_gl.permute_int([int(v) for v in states[0]])
    for width in (1, 4, 5, 8, 13, 27):
        rows = _rand((17, width), 4 + width)
        np.testing.assert_array_equal(native.linear_hash(rows), linearhash.linear_hash(rows))
        np.testing.assert_array_equal(native.linear_hash(rows), jnative.linear_hash(rows))
    level = _rand((64, 4), 5)
    np.testing.assert_array_equal(native.merkle_level(level),
                                  poseidon_gl.hash_n(level.reshape(-1, 8)))
    np.testing.assert_array_equal(native.merkle_level(level), jnative.merkle_level(level))


def test_host_trees_paths_and_transcript_use_the_runtime():
    for width, split in ((3, False), (11, False), (11, True)):
        _check_tree(width, split)
    buff = _rand((2, 11), 9)

    def squeeze():
        t = transcript.Transcript()
        t.put([int(v) for v in buff[0]])
        t.put(list(range(13)))
        return [t.get_field() for _ in range(4)], t.get_permutations(9, 11)

    want = squeeze()
    with native.plain_hashing():
        assert transcript.native is not native
        assert squeeze() == want
    assert transcript.native is native and merkle.native is native


def _check_tree(width, split):
    """A host tree, its paths and their checks on the runtime equal the
    plain versions'."""
    height = 96
    buff = _rand((height, width), 6 + width)
    tree = merkle.merkelize(buff, width, height, split)
    with native.plain_hashing():
        plain = merkle.merkelize(buff, width, height, split)
    assert len(tree.levels) == len(plain.levels)
    for lvl, ref in zip(tree.levels, plain.levels):
        np.testing.assert_array_equal(lvl, ref)
    for idx in (0, 37, height - 1):
        values, proof = merkle.get_group_proof(tree, idx)
        got = merkle.calculate_root_from_proof(proof, idx, values, split)
        np.testing.assert_array_equal(got, tree.root)
        with native.plain_hashing():
            got = merkle.calculate_root_from_proof(proof, idx, values, split)
        np.testing.assert_array_equal(got, tree.root)
        assert merkle.verify_group_proof(tree.root, proof, idx, values, split)
        bad = values.copy()
        bad[0] = (int(bad[0]) + 1) % P
        assert not merkle.verify_group_proof(tree.root, proof, idx, bad, split)


def test_failed_host_build_raises(tmp_path, monkeypatch):
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(host_build, "HOST_SRC", tmp_path)
    monkeypatch.setattr(host_build, "HOST_BUILD", tmp_path / "out")
    with pytest.raises(RuntimeError, match="host build of broken failed"):
        host_build.lib("broken")
    monkeypatch.setenv("CXX", "no-such-compiler")
    monkeypatch.setattr(host_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
        host_build.cxx()
