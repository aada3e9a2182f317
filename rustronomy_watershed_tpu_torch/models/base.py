"""Shared driver logic for the segmenting / merging transforms.

Counterpart of ``rustronomy_watershed_tpu.models.base``: the reference's
``Watershed`` trait surface (reference src/lib.rs:1206-1238) and the
``WatershedUtils`` mixin (src/lib.rs:1069-1201).  This slice serves
``transform`` of the segmenting variant on the packed engine (backend
``'auto'``) or the exact engine (``'relax'``); every other entry raises
NotImplementedError naming the ROADMAP item that brings it.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .. import _ext
from ..constants import ALWAYS_FILL, NORMAL_MAX
from ..ops.level_driver import run_levels_impl
from ..ops.preprocess import pre_process
from ..ops.seeds import local_extrema_mask, paint_seeds

_BACKENDS = {"auto": "packed", "relax": "relax"}


def _not_yet(what: str, item: int):
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet "
        f"(ROADMAP queue 1 item {item})"
    )


class WatershedUtils:
    """Image-preparation helpers (src/lib.rs:1069-1201).  ``device`` selects
    where find_local_minima computes its mask."""

    device = "cuda"

    def pre_processor(self, img) -> np.ndarray:
        """Normalise any numeric array to u8 [0, NORMAL_MAX] with the
        reference's special-value mapping (SURVEY.md Q4)."""
        return pre_process(img, NORMAL_MAX)

    def pre_processor_with_max(self, img, max_val: int) -> np.ndarray:
        return pre_process(img, max_val)

    def find_local_minima(self, img, mode: str = "reference") -> list[tuple[int, int]]:
        """Seed coordinates in row-major order: strict local *maxima* by
        value despite the name (src/lib.rs:1190, SURVEY.md Q1); pass
        ``mode='minima'`` for the documented intent."""
        dev = _ext.resolve_device(self.device)
        mask = local_extrema_mask(torch.as_tensor(img).to(dev), mode)
        return list(map(tuple, torch.nonzero(mask).tolist()))


class _WatershedBase(WatershedUtils):
    """Common implementation; subclasses set ``_merging``."""

    _merging: bool = False

    def __init__(
        self,
        max_water_level: int = NORMAL_MAX,
        edge_correction: bool = False,
        backend: str = "auto",
        device="cuda",
    ):
        if backend not in _BACKENDS:
            raise ValueError(f"backend {backend!r} not served (auto or relax)")
        self.max_water_level = int(max_water_level)
        self.edge_correction = bool(edge_correction)
        self.backend = backend
        self.device = device

    def _prepare(self, input_img, seeds):
        """Edge correction + painted seeds (src/lib.rs:1329-1369), on the
        device."""
        img = np.array(input_img, dtype=np.uint8)  # writable, for torch
        if self.edge_correction:
            # 1-px zero border (ALWAYS_FILL); seed coordinates are painted
            # WITHOUT the +1 shift, replicating the reference quirk
            # (src/lib.rs:1365-1367, SURVEY.md Q7).
            img = np.pad(img, 1, constant_values=ALWAYS_FILL)
        labels0 = paint_seeds(img.shape, seeds)
        dev = _ext.resolve_device(self.device)
        return torch.from_numpy(img).to(dev), torch.from_numpy(labels0).to(dev)

    def transform(self, input_img, seeds, device_output: bool = False):
        """Final label image (host numpy int32, or the device tensor with
        ``device_output=True``).

        On the packed engine a d-field saturation (a >= 2^23-pixel
        equal-level plateau) warns and re-runs on the exact engine.
        """
        img, labels0 = self._prepare(input_img, seeds)
        kw = dict(
            max_water_level=self.max_water_level,
            merging=self._merging,
            device=img.device,
        )
        backend = _BACKENDS[self.backend]
        labels, starved = run_levels_impl(
            img, labels0, backend=backend, with_flags=True, **kw
        )
        if starved:
            warnings.warn(
                "packed-key relax kernel d-field saturation detected: a "
                ">= 2^23-pixel equal-level plateau starved label propagation "
                "(ops/relax.py); re-running on the exact relaxation engine "
                "(ops/priority.py, 32-bit ring index)",
                RuntimeWarning,
                stacklevel=2,
            )
            labels = run_levels_impl(img, labels0, backend="relax", **kw)
        return labels if device_output else labels.cpu().numpy()

    def transform_with_hook(self, input_img, seeds):
        raise _not_yet("transform_with_hook", 11)

    def transform_to_list(self, input_img, seeds, *args, **kwargs):
        raise _not_yet("transform_to_list", 8)

    def transform_history(self, input_img, seeds):
        raise _not_yet("transform_history", 8)

    def transform_batch(self, input_imgs, seeds_list, device_output: bool = False):
        raise _not_yet("transform_batch", 7)
