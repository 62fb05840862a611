"""95th percentile over every chunk of the window of the time from the
consumer's ``next()`` to the record in hand."""

import numpy as np


def read(ctx):
    ms = [(x["t1"] - x["t0"]) * 1e3 for x in ctx.units]
    return float(np.percentile(ms, 95)) if ms else None
