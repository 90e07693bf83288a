"""kernels_per_attack: device kernels launched per whole attack call in
the traced stretch (copies and fills not counted): the host's dispatch
work, which a fused or captured path lowers."""


def read(ctx):
    if not ctx.trace.kernels:
        return None
    return len(ctx.trace.kernels) / ctx.calls
