"""relax.sparse_calls_pct: the share of relax launches that ran only a
front, 100 * ``relax_calls_sparse`` / ``relax`` over the traced window
(the port's ``_ext.launches``: the launches of a skipping fixed point
that ran fewer than an eighth of their plan's tiles, counted by
``ops/relax.py::_Tiles.count`` from the words the host reads anyway, and
every relax launch).  Such a launch is bound by its launch and its flag
read, not by bandwidth.  None where the program has no such counter or
no relax launch ran."""

from rustronomy_watershed_tpu_torch import _ext


def read(ctx):
    n = ctx.counters.get("relax", 0)
    if "relax_calls_sparse" not in _ext.launches or not n:
        return None
    return 100.0 * ctx.counters.get("relax_calls_sparse", 0) / n
