"""Transform diagnostics: the per-level flood-sweep counts.

Counterpart of ``rustronomy_watershed_tpu.ops.diagnostics``: BASELINE
config 4 reports "throughput + fixed-point iteration count"; this counts
the Jacobi sweeps each level's flood fixed point takes (the reference's
``loops`` PerfReport counter, src/lib.rs:1400-1402), stepped from the host.
"""

from __future__ import annotations

import torch

from .flood import flood_sweep
from .histogram import value_histogram
from .merge import merge_touching
from .seeds import local_extrema_mask, seed_labels_from_mask


def count_fixed_point_iterations(
    img, labels0=None, *, max_water_level: int = 254, merging: bool = False,
    n_labels: int | None = None,
):
    """Returns ``(total_sweeps, max_sweeps_per_level, per_level_counts)``,
    the counts an int32 ``(levels,)`` tensor; skipped levels count 0.

    ``labels0`` defaults to reference-semantics seeds from the image itself
    (with ``n_labels`` then bounded by the most seeds the shape can hold).
    """
    img = torch.as_tensor(img).to(torch.int32)
    if labels0 is None:
        labels0 = seed_labels_from_mask(local_extrema_mask(img))
        if n_labels is None:
            h, w = img.shape
            n_labels = max(1, ((h - 1) // 2) * ((w - 1) // 2))
    lab = torch.as_tensor(labels0).to(img.device, torch.int32)
    levels = max_water_level + 1
    vhist = value_histogram(img).tolist()
    counts = [0] * levels
    for lvl in range(levels):
        if lvl and not vhist[lvl]:
            continue
        while True:
            new = flood_sweep(img, lab, lvl)
            counts[lvl] += 1
            changed = bool((new != lab).any())
            lab = new
            if not changed:
                break
        if merging:
            lab = merge_touching(lab, n_labels)
    c = torch.tensor(counts, dtype=torch.int32)
    return int(c.sum()), int(c.max()), c
