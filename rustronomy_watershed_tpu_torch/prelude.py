"""Batch import, mirroring the reference's ``prelude`` module
(reference src/lib.rs:144-154)."""

from .builder import TransformBuilder
from .models import HookCtx, MergingWatershed, SegmentingWatershed, WatershedUtils


class color_maps:
    """Colour maps for plotting (prelude::color_maps)."""

    from .utils.plotting import grey_scale, inferno, magma, plasma, viridis


__all__ = [
    "HookCtx",
    "MergingWatershed",
    "SegmentingWatershed",
    "TransformBuilder",
    "WatershedUtils",
    "color_maps",
]
