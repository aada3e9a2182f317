"""Lake-size and pixel-value histograms.

Counterpart of ``rustronomy_watershed_tpu.ops.histogram``: the reference's
per-level ``find_lake_sizes`` (reference src/lib.rs:628-635) as one
bincount.  The device table has ``n_labels + 1`` counters (index 0 counts
uncoloured pixels); the public API widens rows to the reference's
``n_pixels + 1`` (SURVEY.md Q10).
"""

from __future__ import annotations

import torch


def lake_sizes(labels: torch.Tensor, n_labels: int) -> torch.Tensor:
    """int32 counts of each label value 0..n_labels; larger values drop."""
    flat = labels.reshape(-1).to(torch.int64)
    flat = flat[flat <= n_labels]
    return torch.bincount(flat, minlength=n_labels + 1).to(torch.int32)


def value_histogram(img: torch.Tensor) -> torch.Tensor:
    """256-bin int32 histogram of the u8 image.  A water level L > 0 with no
    pixel of value exactly L cannot change the labels: at the previous
    level's fixed point every uncoloured frontier pixel has value >= L, and
    only value == L opens a new path."""
    return torch.bincount(img.reshape(-1).to(torch.int64), minlength=256).to(torch.int32)
