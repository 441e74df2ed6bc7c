"""Kernels in the traced window over the forwards dispatched in it."""


def read(ctx):
    tr, n = ctx.get("trace"), ctx.get("traced_forwards")
    if tr is None or not n or not tr.kernels():
        return None
    return len(tr.kernels()) / n
