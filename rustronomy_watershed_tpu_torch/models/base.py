"""Shared driver logic for the segmenting / merging transforms.

Counterpart of ``rustronomy_watershed_tpu.models.base``: the reference's
``Watershed`` trait surface (reference src/lib.rs:1206-1238) and the
``WatershedUtils`` mixin (src/lib.rs:1069-1201).  The port serves
``transform`` and ``transform_batch`` of both variants on the packed engine
(backend ``'auto'``) or the exact engine (``'relax'``); every other entry
raises NotImplementedError naming the ROADMAP item that brings it.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .. import _ext
from ..constants import ALWAYS_FILL, NEVER_FILL, NORMAL_MAX
from ..ops.level_driver import run_levels_impl
from ..ops.preprocess import pre_process
from ..ops.seeds import local_extrema_mask, paint_seeds, seed_array

_BACKENDS = {"auto": "packed", "relax": "relax"}


def _warn_saturation():
    warnings.warn(
        "packed-key relax kernel d-field saturation detected: a "
        ">= 2^23-pixel equal-level plateau starved label propagation "
        "(ops/relax.py); re-running on the exact relaxation engine "
        "(ops/priority.py, 32-bit ring index)",
        RuntimeWarning,
        stacklevel=4,  # the caller of transform / transform_batch
    )


def _surviving_min(coords, w: int) -> int:
    """The least label that survives painting ``(n, 2)`` coordinates (a
    later seed at the same coordinate overwrites an earlier one), 0 for no
    seeds."""
    if coords.shape[0] == 0:
        return 0
    flat = coords[:, 0] * w + coords[:, 1]
    keep = flat.shape[0] - 1 - np.unique(flat[::-1], return_index=True)[1]
    return int(keep.min()) + 1


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

    def _run(self, img, labels0, **kw):
        """run_levels_impl on the configured engine; a d-field saturation
        of the packed engine (a >= 2^23-pixel equal-level plateau) warns
        and re-runs on the exact engine."""
        kw.update(max_water_level=self.max_water_level, merging=self._merging, device=img.device)
        labels, starved = run_levels_impl(
            img, labels0, backend=_BACKENDS[self.backend], with_flags=True, **kw
        )
        if starved:
            _warn_saturation()
            labels = run_levels_impl(img, labels0, backend="relax", **kw)
        return labels

    def transform(self, input_img, seeds, device_output: bool = False):
        """Final label image (host numpy int32, or the device tensor with
        ``device_output=True``)."""
        img, labels0 = self._prepare(input_img, seeds)
        labels = self._run(img, labels0, n_labels=len(seeds))
        return labels if device_output else labels.cpu().numpy()

    def transform_with_hook(self, input_img, seeds):
        raise _not_yet("transform_with_hook", 11)

    def transform_to_list(self, input_img, seeds, *args, **kwargs):
        raise _not_yet("transform_to_list", 8)

    def transform_history(self, input_img, seeds):
        raise _not_yet("transform_history", 8)

    def transform_batch(self, input_imgs, seeds_list, device_output: bool = False):
        """Transform a ``(b, h, w)`` stack of same-shaped cutouts (BASELINE
        config 5: 64 x 1024² cutouts), one seed list per image; returns
        ``(b, h, w)`` labels like ``transform``.

        The images run as ONE vertically stacked plane with their borders
        forced to NEVER_FILL: border cells are never claimed, so claims and
        labels cannot cross images and one relax pass equals b transforms.
        Merging adds one NEVER_FILL separator row per image, so the
        component-min scans stay per image too, and at full depth on the
        packed engine, when no seed sits on an image border (checked here on
        the host), declares the stack to the driver for the per-image
        broadcast shortcut (models/base.py:491-582 of the JAX package).
        """
        imgs = np.asarray(input_imgs, dtype=np.uint8)
        if imgs.ndim != 3:
            raise ValueError("transform_batch expects (B, H, W)")
        if len(seeds_list) != imgs.shape[0]:
            raise ValueError("one seed list per image required")
        if self.edge_correction:
            imgs = np.pad(imgs, ((0, 0), (1, 1), (1, 1)), constant_values=ALWAYS_FILL)
        b, h, w = imgs.shape
        coords = [seed_array(s) for s in seeds_list]
        labels0 = np.stack([paint_seeds((h, w), c) for c in coords])
        imgs = imgs.copy()
        imgs[:, [0, -1], :] = NEVER_FILL
        imgs[:, :, [0, -1]] = NEVER_FILL
        hs = h + 1 if self._merging else h
        kw = dict(n_labels=max((len(c) for c in coords), default=0))
        if self._merging:
            imgs = np.concatenate([imgs, np.full((b, 1, w), NEVER_FILL, np.uint8)], axis=1)
            labels0 = np.pad(labels0, ((0, 0), (0, 1), (0, 0)))
            border_seed = any(
                ((c[:, 0] == 0) | (c[:, 0] == h - 1) | (c[:, 1] == 0) | (c[:, 1] == w - 1)).any()
                for c in coords
            )
            if _BACKENDS[self.backend] == "packed" and self.max_water_level >= 254 and not border_seed:
                kw.update(batch=(b, hs, h), batch_mins=[_surviving_min(c, w) for c in coords])
        dev = _ext.resolve_device(self.device)
        img = torch.from_numpy(np.ascontiguousarray(imgs.reshape(b * hs, w))).to(dev)
        lab = torch.from_numpy(np.ascontiguousarray(labels0.reshape(b * hs, w))).to(dev)
        out = self._run(img, lab, **kw).reshape(b, hs, w)[:, :h]
        return out if device_output else out.cpu().numpy()
