"""Host time spent waiting on the device for the traced slice's records
(the program's ``run.wait`` and ``stream.wait`` spans), per simulated
tick."""

from lasana_bench.program_trace import span_ms_per_tick


def read(ctx):
    return span_ms_per_tick(ctx, ("run.wait", "stream.wait"))
