"""The port's .chelpers.bin writer and reader (compiler/chelpers_bin.py,
on utils/binfile.py) against the JAX package's: for every committed STARK
setup (the debug setups have no FRI expression, and both packages refuse
them), the file's bytes are equal, and both readers give the same
streams back."""
import pytest

from pil2_stark_tpu.compiler import chelpers_bin as jcb
from pil2_stark_tpu_torch.compiler import chelpers_bin as tcb
from pil2_stark_tpu_torch.stark import catalog, setup as tsetup

SETUPS = sorted(n for n in catalog.FILES if n != "fibv_global" and not n.endswith("_debug"))


def test_every_setup_is_covered():
    assert {"fibonacci_6", "all_8", "poseidon_vm_20", "fibonacci_22", "fibv_module"} <= set(SETUPS)
    assert len(SETUPS) == 12


@pytest.mark.parametrize("name", SETUPS)
def test_chelpers_file_equals_jax(name, tmp_path):
    data = tsetup.read_setup(name)
    paths = [str(tmp_path / f"{k}.chelpers.bin") for k in ("jax", "port")]
    want = jcb.write_chelpers_file(paths[0], data["starkInfo"], data["expressionsInfo"])
    got = tcb.write_chelpers_file(paths[1], data["starkInfo"], data["expressionsInfo"])
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    assert got == want
    assert tcb.read_chelpers_file(paths[1]) == jcb.read_chelpers_file(paths[1])
    assert len(got["expsInfo"]) > 0
