"""launches_per_proof: device kernels, memcpys and memsets per profiled
proof: the host-dispatch cost behind the idle card."""


def read(ctx):
    ops = ctx["trace"].device_in_proofs()
    if not ops:
        return None
    return len(ops) / ctx["profiled_proofs"]
