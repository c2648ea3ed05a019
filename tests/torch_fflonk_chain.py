"""The fflonk chain that the export-leg tests of the PyTorch port share
(tests/test_torch_zkey.py, test_torch_solidity.py, test_torch_evm.py):
fibonacci 2^4 over BN254-Fr, set up and proved by the port from a small
dev powers of tau, as tests/test_solidity.py's ``chain`` fixture builds it
in the JAX package.  The same vk and proof objects go through the JAX
package's exporters and the port's, so the tests compare the exporters
alone."""
import functools
import random

import numpy as np

from pil2_stark_tpu_torch.compiler import pil1_parser, pilinfo
from pil2_stark_tpu_torch.fflonk.prover import fflonk_prove
from pil2_stark_tpu_torch.fflonk.shkey import fflonk_setup, verification_key
from pil2_stark_tpu_torch.fflonk.verifier import fflonk_verify
from pil2_stark_tpu_torch.models import fibonacci
from pil2_stark_tpu_torch.ops.fft_bn128 import FR
from pil2_stark_tpu_torch.protocol.shplonk import dev_ptau

N_BITS = 4
N = 1 << N_BITS


@functools.lru_cache(maxsize=None)
def chain():
    """{info, zkey, ptau, cm1, publics, vk, res}: the port's setup, its
    verification key and a verified proof (rng seed 3)."""
    pil = pil1_parser.compile_pil_source(fibonacci.pil_source(N_BITS))
    pil["name"] = "Fibonacci"
    info = pilinfo.pil_info(pil, stark=False)
    fflonk_info = info["pilInfo"]
    const_names = [p["name"] for p in fflonk_info["constPolsMap"]]
    const_pols = [[0] * len(const_names) for _ in range(N)]
    const_pols[0][const_names.index("Fibonacci.L1")] = 1
    const_pols[N - 1][const_names.index("Fibonacci.LLAST")] = 1
    cm_names = [p["name"] for p in fflonk_info["cmPolsMap"] if p["stage"] == 1]
    l1, l2 = [0] * N, [0] * N
    l2[0], l1[0] = 1, 2
    for i in range(1, N):
        l2[i] = l1[i - 1]
        l1[i] = (l1[i - 1] ** 2 + l2[i - 1] ** 2) % FR
    cm1 = np.empty((N, len(cm_names)), dtype=object)
    cm1[:, cm_names.index("Fibonacci.l1")] = l1
    cm1[:, cm_names.index("Fibonacci.l2")] = l2
    publics = [1, 2, l1[N - 1]]
    ptau = dev_ptau(4 * (N + 4) + 8 * N, tau=9999)
    zkey = fflonk_setup(const_pols, fflonk_info, ptau)
    res = fflonk_prove(zkey, ptau, fflonk_info, info["expressionsInfo"], cm1, publics,
                       rng=random.Random(3))
    vk = verification_key(zkey, fflonk_info)
    assert fflonk_verify(vk, fflonk_info, info["verifierInfo"], res["proof"], res["publics"])
    return {"info": info, "zkey": zkey, "ptau": ptau, "cm1": cm1, "publics": publics,
            "vk": vk, "res": res}
