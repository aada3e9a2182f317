"""driver.tail_rounds: coarse rounds a call of the merging tail (the
port's ``_ext.launches["coarse_round"]``), each ended by a host flag
read."""


def read(ctx):
    n = ctx.counters.get("coarse_round", 0)
    return n / ctx.calls if n and ctx.calls else None
