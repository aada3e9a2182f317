"""The transform driver: the relaxation branch of the water-level driver.

Counterpart of ``rustronomy_watershed_tpu.ops.level_driver.run_levels_impl``,
relax branches (level_driver.py:229-392).  The whole 254-level transform is
ONE priority-relaxation fixed point, so no per-level loop runs.  Two engines
with bit-identical labels:

* ``backend='packed'`` — the packed-key engine (ops/pack.py + ops/relax.py)
  and, for merging, the coarse component-min engine (ops/scan_merge.py): the
  CUDA kernels on a CUDA device, their plain twins on the CPU.  The
  counterpart of the JAX ``'relax_pallas'`` backend.
* ``backend='relax'`` — the exact unpacked engine (ops/priority.py) and,
  for merging, the component-min oracle.

Merging = segmenting labels, then every 4-connected component of the
claimed set takes its minimum label (ops/scan_merge.py).  At full depth the
relax calls also reduce the single-component statistics; the driver takes
them from the certifying call, whose planes are the fixed point, in the
same flag read.  When no interior cell is unclaimed and no border cell is
claimed, the claimed set is the interior rectangle, one component, and the
labels are a broadcast of its least label (the shortcut).  Otherwise the
coarse tail runs.  The JAX driver trusts only the first relax call's
statistics, which on this card's schedule never certifies; the schedule
differs, the labels do not.
"""

from __future__ import annotations

import torch

from .. import _ext
from ..constants import _INF, UNCOLOURED
from .priority import relax_transform
from .relax import relax_packed_planes, relax_transform_packed
from .scan_merge import component_min_coarse, component_min_labels_plain

_NEXT_COLLECT = "per-level statistics on the port arrive with ROADMAP queue 1 item 8"


def _shortcut(shape, device, batch, batch_mins, gmin):
    """The broadcast labels: ``gmin`` on the interior and UNCOLOURED
    elsewhere, or per stacked image its least seed label on that image's
    interior (the JAX package's jnp.where over an interior mask, written as
    one fill and one strided write)."""
    h, w = shape
    out = torch.full((h, w), UNCOLOURED, dtype=torch.int32, device=device)
    if batch is None:
        out[1 : h - 1, 1 : w - 1] = gmin
    else:
        b, hs, h_img = batch
        mins = torch.as_tensor(batch_mins, dtype=torch.int32).to(device)
        out.view(b, hs, w)[:, 1 : h_img - 1, 1 : w - 1] = mins[:, None, None]
    return out


def _merge_full_depth(img, labels0, *, n_labels, steps, device, batch, batch_mins):
    """Merging at max_water_level >= 254 on the packed engine: relax with
    statistics, then the shortcut or the coarse tail.  Returns
    ``(labels, starved)``."""
    _, lab, starved, (n_uncl, any_border, gmin) = relax_packed_planes(
        img, labels0, steps=steps, device=device, stats=True
    )
    h, w = lab.shape
    if batch is not None:
        # Stacked batch (models/base.py::transform_batch): every per-image
        # border and separator row is a structural NEVER_FILL cell.  The
        # claimed set is each image's full interior iff the unclaimed count
        # is exactly their number, (3b-2)*(w-2) — the caller guarantees no
        # border seed (level_driver.py:271-309).
        b = batch[0]
        if batch_mins is None or len(batch_mins) != b:
            raise ValueError("batch requires batch_mins, one per image")
        fast = n_uncl == (3 * b - 2) * (w - 2) and not any_border and min(batch_mins) > 0
    else:
        fast = n_uncl == 0 and not any_border and gmin < _INF
    if fast:
        _ext.launches["merge_shortcut"] += 1
        return _shortcut((h, w), lab.device, batch, batch_mins, gmin), starved
    _ext.launches["merge_tail"] += 1
    return component_min_coarse(lab, n_labels)[0], starved


def run_levels_impl(
    img,
    labels0,
    *,
    max_water_level: int,
    merging: bool = False,
    n_labels: int | None = None,
    collect: str = "none",
    backend: str = "packed",
    steps: int | None = None,
    with_flags: bool = False,
    batch: tuple | None = None,
    batch_mins=None,
    device="cuda",
):
    """Run the full transform; returns the ``(h, w)`` int32 label tensor, or
    ``(labels, starved)`` with ``with_flags=True``.

    ``labels0=None`` (packed only) takes the seeds from the image through the
    pack kernel.  ``n_labels`` (merging only) bounds the labels, 1..n_labels:
    the coarse tail's gate reads it.  ``batch=(b, hs, h_img)`` with
    ``batch_mins`` (merging, packed, full depth) declares a vertically
    stacked batch of ``b`` images at a stride of ``hs`` rows with no seed on
    any image border, and enables the per-image broadcast shortcut; the
    minima are each image's least surviving seed label.  ``starved`` is True
    iff the packed engine's d field saturated (the caller should re-run on
    ``'relax'``); always False for ``'relax'``.
    """
    if collect != "none":
        raise NotImplementedError(_NEXT_COLLECT)
    if merging and n_labels is None:
        raise ValueError("merging needs n_labels, the largest label")
    dev = _ext.resolve_device(device)
    if backend == "packed":
        if merging and max_water_level >= 254:
            labels, starved = _merge_full_depth(
                img, labels0, n_labels=n_labels, steps=steps, device=dev,
                batch=batch, batch_mins=batch_mins,
            )
        else:
            labels, _, starved = relax_transform_packed(
                img, labels0, max_water_level=max_water_level, steps=steps, device=dev
            )
            if merging:
                _ext.launches["merge_tail"] += 1
                labels = component_min_coarse(labels, n_labels)[0]
    elif backend == "relax":
        if labels0 is None:
            raise ValueError("labels0=None requires backend='packed'")
        labels, _ = relax_transform(
            torch.as_tensor(img).to(dev),
            torch.as_tensor(labels0).to(dev),
            max_water_level=max_water_level,
        )
        if merging:
            labels = component_min_labels_plain(labels)
        starved = False
    else:
        raise ValueError(f"unknown backend {backend!r} (packed or relax)")
    return (labels, starved) if with_flags else labels
