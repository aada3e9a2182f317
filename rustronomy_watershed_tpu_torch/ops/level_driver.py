"""The transform driver: the relaxation branch of the water-level driver.

Counterpart of ``rustronomy_watershed_tpu.ops.level_driver.run_levels_impl``,
segmenting relax branch (level_driver.py:359-372, :391-392).  The whole
254-level transform is ONE priority-relaxation fixed point, so no per-level
loop runs.  Two engines with bit-identical labels:

* ``backend='packed'`` — the packed-key engine (ops/pack.py + ops/relax.py):
  the CUDA kernels on a CUDA device, their plain twins on the CPU.  The
  counterpart of the JAX ``'relax_pallas'`` backend.
* ``backend='relax'`` — the exact unpacked engine (ops/priority.py).
"""

from __future__ import annotations

import torch

from .. import _ext
from .priority import relax_transform
from .relax import relax_transform_packed

_NEXT_MERGING = "the merging variant on the port arrives with ROADMAP queue 1 item 6"
_NEXT_COLLECT = "per-level statistics on the port arrive with ROADMAP queue 1 item 8"


def run_levels_impl(
    img,
    labels0,
    *,
    max_water_level: int,
    merging: bool = False,
    collect: str = "none",
    backend: str = "packed",
    steps: int | None = None,
    with_flags: bool = False,
    device="cuda",
):
    """Run the full segmenting transform; returns the ``(h, w)`` int32 label
    tensor, or ``(labels, starved)`` with ``with_flags=True``.

    ``labels0=None`` (packed only) takes the seeds from the image through the
    pack kernel.  The JAX driver's ``n_labels`` label-table bound has no
    counterpart here: the segmenting path reads no per-label table.
    ``starved`` is True iff the packed engine's d field saturated
    (the caller should re-run on ``'relax'``); always False for ``'relax'``.
    """
    if merging:
        raise NotImplementedError(_NEXT_MERGING)
    if collect != "none":
        raise NotImplementedError(_NEXT_COLLECT)
    dev = _ext.resolve_device(device)
    if backend == "packed":
        labels, _, starved = relax_transform_packed(
            img, labels0, max_water_level=max_water_level, steps=steps, device=dev
        )
    elif backend == "relax":
        if labels0 is None:
            raise ValueError("labels0=None requires backend='packed'")
        labels, _ = relax_transform(
            torch.as_tensor(img).to(dev),
            torch.as_tensor(labels0).to(dev),
            max_water_level=max_water_level,
        )
        starved = False
    else:
        raise ValueError(f"unknown backend {backend!r} (packed or relax)")
    return (labels, starved) if with_flags else labels
