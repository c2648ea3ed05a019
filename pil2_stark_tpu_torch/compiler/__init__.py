"""The PIL compiler: PIL1 source or a PIL2 pilout -> starkInfo,
expressionsInfo and verifierInfo (``pilinfo.pil_info``).

Plain Python, no device code: the port's own copy of the modules of
pil2_stark_tpu/compiler/ that the setup needs (east, prepare_util,
pil1_parser, pil1_libs, cpoly, impols, impols_opt, prepare, mapping,
codegen, pil2_frontend, pilinfo), with the same module and function names
and the same output, so that a setup compiled here equals one compiled
there (tests/test_torch_compiler.py).  ``stark.setup.stark_setup`` runs it
and then builds the const tree.
"""
