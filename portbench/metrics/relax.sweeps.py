"""relax.sweeps: Jacobi sweeps of relax launched a call (the port's
``_ext.launches["relax_sweeps"]``: each relax launch's ``steps``).  None
where the program has no such counter."""


def read(ctx):
    n = ctx.counters.get("relax_sweeps", 0)
    return n / ctx.calls if n and ctx.calls else None
