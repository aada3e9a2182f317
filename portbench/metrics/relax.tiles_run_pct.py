"""relax.tiles_run_pct: the share of the relax launches' tiles that ran,
100 * (``relax_tiles`` - ``relax_tiles_skipped``) / ``relax_tiles`` (the
port's ``_ext.launches``: each launch's plan tiles, and the quiet tiles a
skipping fixed point skipped, read with its flags)."""


def read(ctx):
    tiles = ctx.counters.get("relax_tiles", 0)
    if not tiles:
        return None
    return 100.0 * (tiles - ctx.counters.get("relax_tiles_skipped", 0)) / tiles
