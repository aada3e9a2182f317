"""fine_tail.rounds: rounds a call of the fine scan tail (the port's
``_ext.launches["fine_round"]``, the rounds of ``component_min_fine``),
each ended by one blocking flag read, so also the tail's reads a call.
None where the program has no such counter or no fine round ran."""


def read(ctx):
    n = ctx.counters.get("fine_round", 0)
    return n / ctx.calls if n and ctx.calls else None
