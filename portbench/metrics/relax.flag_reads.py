"""relax.flag_reads: the relax fixed point's reads of its flags a call (the
port's ``_ext.launches["relax_reads"]``: one a block of queued relax calls,
or one a call where the fixed point reads every call).  Each read waits for
the card, so fewer reads leave it less idle.  None where the program has no
such counter or no relax launch ran."""

from rustronomy_watershed_tpu_torch import _ext


def read(ctx):
    if "relax_reads" not in _ext.launches or not ctx.counters.get("relax") or not ctx.calls:
        return None
    return ctx.counters.get("relax_reads", 0) / ctx.calls
