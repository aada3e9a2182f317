"""Merging (void-filling) watershed: touching lakes merge and take the
lower label.

Counterpart of ``rustronomy_watershed_tpu.models.merging`` (reference
``MergingWatershed``, src/lib.rs:1297-1562).
"""

from __future__ import annotations

from .base import _WatershedBase


class MergingWatershed(_WatershedBase):
    _merging = True
