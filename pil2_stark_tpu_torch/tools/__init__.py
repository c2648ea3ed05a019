"""Experiment tools of the port: the Poseidon variant sweep (kernel X2,
``exp_poseidon``) and the streamed permutation (kernel X1, ``exp_stream``),
counterparts of the JAX package's ``tools/exp_poseidon.py`` and
``tools/exp_stream.py``."""
