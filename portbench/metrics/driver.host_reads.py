"""driver.host_reads: the program's explicit blocking reads of a result a
call (the port's ``_ext.launches["host_reads"]``: relax flags, tail round
flags, the seed list, the compact planes); syncs inside torch ops are not
counted."""


def read(ctx):
    n = ctx.counters.get("host_reads", 0)
    return n / ctx.calls if n and ctx.calls else None
