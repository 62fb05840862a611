"""Process start to the first timed call: imports, loading, the
stimulus, building and warming every shape the window uses."""


def read(ctx):
    return ctx.setup_s
