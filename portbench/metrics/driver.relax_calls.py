"""driver.relax_calls: relax kernel launches a call (the port's
``_ext.launches["relax"]`` over the traced window's calls)."""


def read(ctx):
    n = ctx.counters.get("relax", 0)
    return n / ctx.calls if n and ctx.calls else None
