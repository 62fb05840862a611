"""``network_tick``'s least time over its device time in the traced
slice: each launch's least time from the frozen arithmetic, one launch a
layer a tick over the rows these inputs need."""

from lasana_bench.work import counts


def read(ctx):
    is_tick = lambda n: "network_tick_tiled" in n and "chunk" not in n
    if ctx.trace is None or not ctx.trace.count(is_tick):
        return None
    least = 0.0
    for tick in ctx.slice_rows:
        for n, rows in zip(ctx.layer_sizes, tick):
            least += counts.least_seconds(
                *counts.network_tick(ctx.circuit, ctx.shapes, n, rows))
    return 100.0 * least / ctx.trace.seconds(is_tick)
