"""relax.stopped_calls: relax calls a call that the fixed point queued past
its end and that stopped on the device, because the call before them
certified the fixed point (the port's ``_ext.launches["relax_stopped"]``):
what the fixed point's blocks of calls, read once a block, cost in
launches.  None where the program has no such counter or no relax launch
ran."""

from rustronomy_watershed_tpu_torch import _ext


def read(ctx):
    if "relax_stopped" not in _ext.launches or not ctx.counters.get("relax") or not ctx.calls:
        return None
    return ctx.counters.get("relax_stopped", 0) / ctx.calls
