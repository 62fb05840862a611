"""``mlp_surrogate_heads``' least time over its device time in the traced
slice. The stacked tick launches it once per variant whose 3-layer MLP
heads of one shape number two or more (idle heads on stale rows, active
on changed, transition on output-changed rows); each launch's least time
is the frozen arithmetic over the rows these inputs need."""

from lasana_bench.work import counts

VARIANTS = (("M_ES", "M_V"), ("M_O", "M_V", "M_ES"), ("M_ED", "M_L"))


def groups(shapes, circuit):
    """``[(variant index, heads, row width, h1, h2)]`` of the launches."""
    f = counts.row_width(circuit)
    out = []
    for v, heads in enumerate(VARIANTS):
        by_shape = {}
        for p in heads:
            fam, h1, h2, _, _ = shapes[p]
            if fam == "mlp":
                by_shape.setdefault((h1, h2), []).append(p)
        for (h1, h2), ps in by_shape.items():
            if len(ps) >= 2:
                out.append((v, len(ps), f + 2 if v == 2 else f, h1, h2))
    return out


def read(ctx):
    is_heads = lambda n: "mlp_heads_tiled" in n
    if ctx.trace is None or not ctx.trace.count(is_heads):
        return None
    least = 0.0
    launches = groups(ctx.shapes, ctx.circuit)
    for tick in ctx.slice_rows:
        for rows in tick:
            changed, stale, out_changed = rows
            need = (stale, changed, out_changed)
            for v, p, f, h1, h2 in launches:
                least += counts.least_seconds(
                    *counts.mlp_heads(int(need[v]), f, p, h1, h2))
    return 100.0 * least / ctx.trace.seconds(is_heads)
