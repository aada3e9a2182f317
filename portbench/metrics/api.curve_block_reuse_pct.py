"""api.curve_block_reuse_pct: the share of the curve tail's pooled-size
result blocks that came from the pool of released blocks, 100 * reused /
(reused + new) over the traced window (the port's
``_ext.launches["curve_block_reused"]`` and ``["curve_block_new"]``,
ops/merge_curve.py ``ResultBlocks``)."""


def read(ctx):
    reused = ctx.counters.get("curve_block_reused", 0)
    total = reused + ctx.counters.get("curve_block_new", 0)
    return 100.0 * reused / total if total else None
