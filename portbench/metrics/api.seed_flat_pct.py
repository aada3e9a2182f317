"""api.seed_flat_pct: the share of the seed lists painted by the port that
were read as one flat stream of (y, x) pairs, 100 * flat / (flat + generic)
over the traced window (the port's ``_ext.launches["seed_array_flat"]`` and
``["seed_array_generic"]``, ops/seeds.py ``seed_array``)."""


def read(ctx):
    flat = ctx.counters.get("seed_array_flat", 0)
    total = flat + ctx.counters.get("seed_array_generic", 0)
    return 100.0 * flat / total if total else None
