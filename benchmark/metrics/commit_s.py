"""commit_s: seconds per proof of the commits (every ``stage*.commit``
phase: the LDE and the Merkle tree of each stage, and for Q its program,
its transform and split and its tree; the prover takes the upload out of
the phase), mean over the window's unprofiled proofs."""


def read(ctx):
    phases = ctx["phases"]
    if not phases:
        return None
    return sum(v for p in phases for k, v in p.items()
               if k.startswith("stage") and k.endswith(".commit")) / len(phases)
