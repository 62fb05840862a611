"""Host time of bringing the traced slice's records to the host and
building their ``NetworkRun`` (the program's ``run.fetch``,
``stream.to_host`` and ``stream.convert`` spans), per simulated tick."""

from lasana_bench.program_trace import span_ms_per_tick


def read(ctx):
    return span_ms_per_tick(ctx, ("run.fetch", "stream.to_host",
                                  "stream.convert"))
