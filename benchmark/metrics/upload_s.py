"""upload_s: seconds per proof of the witness upload (every
``stage*.upload`` phase of the prover's PhaseTimer; the stage-1 witness
is nearly all of it), mean over the window's unprofiled proofs."""


def read(ctx):
    phases = ctx["phases"]
    if not phases:
        return None
    return sum(v for p in phases for k, v in p.items() if k.endswith(".upload")) / len(phases)
