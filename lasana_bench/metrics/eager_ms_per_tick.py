"""Device time of every device operation that is neither a port kernel
nor a copy (Algorithm 1's and the surrogates' eager PyTorch), per
simulated tick."""

from lasana_bench.profiling import is_copy, is_port_kernel


def read(ctx):
    eager = lambda n: not is_port_kernel(n) and not is_copy(n)
    if ctx.trace is None or not ctx.trace.count(eager):
        return None
    return ctx.trace.seconds(eager) * 1e3 / ctx.slice_ticks
