"""Merging (void-filling) watershed — not ported yet.

Counterpart of ``rustronomy_watershed_tpu.models.merging``.  The object
builds, and its WatershedUtils helpers work, but ``transform`` needs the
component-min kernels of ROADMAP queue 1 item 6.
"""

from __future__ import annotations

from .base import _not_yet, _WatershedBase


class MergingWatershed(_WatershedBase):
    _merging = True

    def transform(self, input_img, seeds, device_output: bool = False):
        raise _not_yet("MergingWatershed.transform", 6)
