"""tail.rounds_skipped: coarse rounds a call that the merging tail queued
and that stopped on the device, because a round before them changed
nothing (the port's ``_ext.launches["coarse_round_skipped"]``): what the
tail's blocks of rounds, read once a block, cost in launches.  None where
the program has no such counter or ran no coarse round."""

from rustronomy_watershed_tpu_torch import _ext


def read(ctx):
    if "coarse_round_skipped" not in _ext.launches or not ctx.counters.get("coarse_round") or not ctx.calls:
        return None
    return ctx.counters.get("coarse_round_skipped", 0) / ctx.calls
