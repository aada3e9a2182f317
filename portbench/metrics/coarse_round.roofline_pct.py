"""coarse_round.roofline_pct: the coarse rounds' bytes at the HBM peak
over the device time of the round's kernels in the trace (the coarse
instantiations of the column scan and of the row kernel).  Bytes: 8 a
coarse cell a round (harness/roofline.py)."""

from harness.roofline import coarse_round_bytes, share_pct

_ROUND = ("vscan_tiles<true", "row_ring<true", "run_min_pass<true")


def read(ctx):
    rounds = ctx.counters.get("coarse_round", 0)
    if not rounds:
        return None
    t = ctx.trace.device_us(lambda n: n.startswith(_ROUND)) / 1e6
    return share_pct(rounds * coarse_round_bytes(*ctx.shape), t)
