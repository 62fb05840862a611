"""Device operations (kernels, copies, fills) the traced slice ran, per
simulated tick: what the engine enqueues."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops:
        return None
    return len(ctx.trace.ops) / ctx.slice_ticks
