"""evals_s: seconds per proof of the DEEP evaluations (the ``evals``
phase), mean over the window's unprofiled proofs."""


def read(ctx):
    phases = ctx["phases"]
    if not phases or "evals" not in phases[0]:
        return None
    return sum(p.get("evals", 0.0) for p in phases) / len(phases)
