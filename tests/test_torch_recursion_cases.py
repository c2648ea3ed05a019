"""Shared inputs of the port's recursion-tier tests (test_torch_circom.py,
test_torch_compressor.py, test_torch_recursive_prove.py,
test_torch_aggregate.py, test_torch_cli.py): the smallest chain of the
tier, fibonacci 2^4 / ext 2^7 with 2 queries, proved on the CPU, and its
verifier circuit's files and zkin.  Its C12 comes out at 2^11 rows.

The JAX package's Merkle trees of 2^11 leaves and more take its jitted
path, whose XLA compile costs about a minute per shape on the CPU;
``jax_host_trees`` sends them through the same module's native C++ host
path (bit-identical, what it uses below 2^11) for the duration of a test
module.  Also three reference-side hazards that the port copies, pinned in
both packages."""
import contextlib
import copy

import pytest

from pil2_stark_tpu.compiler import pil2circom as jp2c
from pil2_stark_tpu.compiler import pil1_parser as jparser
from pil2_stark_tpu.compiler import pilinfo as jpilinfo
from pil2_stark_tpu.compiler import compressor12 as jc12
from pil2_stark_tpu_torch.compiler import compressor12 as tc12
from pil2_stark_tpu_torch.compiler import pil1_parser as tparser
from pil2_stark_tpu_torch.compiler import pil2circom as tp2c
from pil2_stark_tpu_torch.compiler import pilinfo as tpilinfo
from pil2_stark_tpu_torch.models import fibonacci as tfib
from pil2_stark_tpu_torch.stark import prover as tprover, setup as tsetup
from pil2_stark_tpu_torch.utils import proof2zkin as tp2z

P = 0xFFFFFFFF00000001
# the inner proof: the last FRI step keeps 3 bits, the blowup's (see
# test_final_pol_bound_below_the_blowup_is_copied)
INNER_STRUCT = {"nBits": 4, "nBitsExt": 7, "nQueries": 2, "verificationHashType": "GL",
                "steps": [{"nBits": 7}, {"nBits": 3}]}


def c12_struct(n_bits):
    """The recursive machine's struct: blowup 2, FRI steps of 4 bits, the
    JAX tests' 8 queries."""
    steps = list(range(n_bits + 1, 0, -4))
    return {"nBits": n_bits, "nBitsExt": n_bits + 1, "nQueries": 8,
            "verificationHashType": "GL", "steps": [{"nBits": b} for b in steps]}


@contextlib.contextmanager
def jax_host_trees():
    from pil2_stark_tpu.hash import merkle as jmerkle

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmerkle, "_DEVICE_MIN_HEIGHT", 1 << 62)
        yield


def inner_proof(inputs=(1, 2), setup=None):
    """(setup, result, zkin) of fibonacci 2^4 proved by the port on the
    CPU, from `setup` when given (the setup does not depend on the
    inputs); the zkin carries the publics."""
    pil = tparser.compile_pil_source(tfib.pil_source(4))
    pil["name"] = "Fibonacci"
    const_cols, cm_cols, publics = tfib.build(pil["references"], 16, list(inputs))
    s = setup or tsetup.stark_setup(const_cols.buffer, pil, copy.deepcopy(INNER_STRUCT),
                                    device="cpu")
    res = tprover.prove(s["starkInfo"], s["expressionsInfo"], const_cols.buffer,
                        s["constTree"], (cm_cols.buffer, publics), device="cpu")
    zkin = tp2z.proof2zkin(res["proof"], s["starkInfo"])
    zkin["publics"] = [int(p) for p in publics]
    return s, res, zkin


def circuit_files(s):
    """The verifier circuit of setup s from each package: (jax, port)."""
    args = ([int(v) for v in s["constRoot"]], s["starkInfo"], s["verifierInfo"])
    return jp2c.emit_circuit_files(*args), tp2c.emit_circuit_files(*args)


def test_final_pol_bound_below_the_blowup_is_copied():
    """Both packages' circuits demand every coefficient of the last FRI
    polynomial be zero when its step has fewer bits than the blowup
    (pil2circom.py gen_verify_final_pol, start = 0), where the host
    verifier (stark/fri.py) lets a constant through: such a proof (the
    committed fibonacci_22 ends at 1 bit over a blowup of 3) cannot be
    verified in a circuit.  The port copies it."""
    data = tsetup.read_setup("fibonacci_22")
    texts = [m.gen_verify_final_pol(0, data["starkInfo"]) for m in (jp2c, tp2c)]
    assert texts[0] == texts[1]
    assert "for (var k = 0; k < 2; k++)" in texts[0]
    ok = dict(data["starkInfo"], starkStruct=dict(data["starkInfo"]["starkStruct"],
                                                   steps=[{"nBits": 25}, {"nBits": 4}]))
    assert "for (var k = 2; k < 16; k++)" in tp2c.gen_verify_final_pol(0, ok)


def test_zero_publics_refused_as_in_jax():
    """The C12 PIL declares its Global L rows only for publics, so a
    circuit with no publics gives a PIL that pil_info refuses
    (compressor12.py _pil_source), in both packages alike."""
    errors = []
    for c12, parser, pilinfo in ((jc12, jparser, jpilinfo), (tc12, tparser, tpilinfo)):
        src = c12._pil_source(4, 0)
        pil = parser.compile_pil_source(src)
        with pytest.raises(ValueError) as e:
            pilinfo.pil_info(pil, True, c12_struct(4))
        errors.append(str(e.value))
    assert errors[0] == errors[1] == "Global.L1 must be defined"
    assert jc12._pil_source(4, 0) == tc12._pil_source(4, 0)


def test_final9_refuses_a_wide_poseidon_as_in_jax():
    """The final9 (and final6) layout shares 5 state columns among the
    PoseidonT gate's rounds (final/plonksetup.py _setup_final, after
    final9_setup.js:131), so a verifier circuit whose custom Merkle trees
    have arity above 4 (PoseidonT t > 5) cannot reach the final tier; the
    snark path's custom-gate circuit takes arity 4.  Both packages refuse
    alike."""
    from pil2_stark_tpu.compiler import circom_front as jcf
    from pil2_stark_tpu.final import plonksetup as jplonk
    from pil2_stark_tpu_torch.compiler import circom_front as tcf
    from pil2_stark_tpu_torch.final import plonksetup as tplonk

    from test_final import _poseidon_t_template

    src = "pragma circom 2.1.0;\npragma custom_templates;\n" + _poseidon_t_template(17) + """
template Main() {
    signal input a;
    signal output h;
    component p = PoseidonT(17);
    p.in[0] <== 0;
    for (var i = 1; i < 17; i++) { p.in[i] <== a + i; }
    _ <== p.im;
    h <== p.out[0];
}
component main = Main();
"""
    errors = []
    for cf, plonk in ((jcf, jplonk), (tcf, tplonk)):
        cc = cf.compile_and_witness({"m.circom": src}, "m.circom", {"a": 5}, prime=plonk.FR)
        with pytest.raises(ValueError, match="t=17 exceeds the 5 shared state columns") as e:
            plonk.setup(cc, cols=9)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
