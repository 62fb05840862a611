"""Host time the engine takes to enqueue the traced slice's ticks (the
program's ``engine.enqueue`` spans: every runner call), per simulated
tick."""

from lasana_bench.program_trace import span_ms_per_tick


def read(ctx):
    return span_ms_per_tick(ctx, ("engine.enqueue",))
