"""Bytes of records the traced slice's calls or chunks brought to the
host (the program's ``records.bytes`` counter), per simulated tick, in
MB (10^6 bytes)."""


def read(ctx):
    snap = getattr(ctx, "program", None)
    if snap is None or not snap.counters.get("records.bytes") \
            or not ctx.slice_ticks:
        return None
    return snap.counters["records.bytes"] / 1e6 / ctx.slice_ticks
