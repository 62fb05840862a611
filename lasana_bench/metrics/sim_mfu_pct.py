"""What the traced slice's simulations need, in operations (every head
evaluation Algorithm 1 makes on the rows these inputs need, the GBDT's
comparisons, the synaptic products), over the slice's seconds at the
fp32 peak. It does not depend on what computes the work."""

from lasana_bench.work import counts


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    flops = 0
    for tick in ctx.slice_rows:
        for rows, drive in zip(tick, ctx.drive_flops):
            flops += counts.simulate_flops(ctx.circuit, ctx.shapes,
                                           tuple(int(r) for r in rows), drive)
    return 100.0 * flops / (ctx.trace.window_s * counts.PEAK_FP32_FLOPS)
