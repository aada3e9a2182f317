"""Batch import, mirroring the reference's ``prelude`` module
(reference src/lib.rs:144-154)."""

from .builder import TransformBuilder
from .models import MergingWatershed, SegmentingWatershed, WatershedUtils

__all__ = [
    "MergingWatershed",
    "SegmentingWatershed",
    "TransformBuilder",
    "WatershedUtils",
]
