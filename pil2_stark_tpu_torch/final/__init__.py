"""Final recursion tiers over BN254-Fr (reference: pil2-stark-js src/final/).

`plonksetup.setup(r1cs, cols=9|6|0)` turns the BN128 verifier-circuit R1CS
into the last-hop plonkish PIL machine (final9 / final6 / finalfflonk),
`exec.exec_witness` scatters the circuit witness into its committed
columns, and the machine is then proven with the pil-fflonk prover
(pil2_stark_tpu_torch.fflonk) for on-chain verification.
"""
