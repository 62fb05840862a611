"""Input events simulated in the window over the window's seconds."""


def read(ctx):
    u = ctx.units
    if not u:
        return None
    return sum(x["events"] for x in u) / (u[-1]["t1"] - u[0]["t0"])
