"""Device time of the records' copies to the host, per simulated tick."""

from lasana_bench.profiling import is_dtoh


def read(ctx):
    if ctx.trace is None or not ctx.trace.count(is_dtoh):
        return None
    return ctx.trace.seconds(is_dtoh) * 1e3 / ctx.slice_ticks
