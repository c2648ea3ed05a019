"""fri_s: seconds per proof of FRI (the ``friPol`` phase, every
``friFold*`` phase and ``queries``), mean over the window's unprofiled
proofs."""


def read(ctx):
    phases = ctx["phases"]
    if not phases:
        return None
    return sum(v for p in phases for k, v in p.items()
               if k in ("friPol", "queries") or k.startswith("friFold")) / len(phases)
