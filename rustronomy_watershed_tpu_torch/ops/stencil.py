"""Neighbour reads for the plain PyTorch stencils.

Counterpart of ``rustronomy_watershed_tpu.ops.stencil``.  Every read is an
explicit shift with a fill value for cells outside the image; nothing wraps
around (the JAX ``roll4`` wraps and relies on its callers' aprons to make the
wrap unobservable).  Window centres are restricted to the interior exactly
like the reference's 3x3 windows (reference src/lib.rs:220-233).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _padded(a: torch.Tensor, fill) -> torch.Tensor:
    # constant_pad_nd keeps integer dtypes (F.pad's "constant" mode).
    return F.pad(a, (1, 1, 1, 1), mode="constant", value=fill)


def shift4(a: torch.Tensor, fill):
    """``(up, down, left, right)`` with ``up[y, x] = a[y-1, x]`` etc.;
    reads outside the image give ``fill``."""
    h, w = a.shape[-2], a.shape[-1]
    p = _padded(a, fill)
    return (
        p[..., 0:h, 1 : w + 1],
        p[..., 2 : h + 2, 1 : w + 1],
        p[..., 1 : h + 1, 0:w],
        p[..., 1 : h + 1, 2 : w + 2],
    )


def shift8(a: torch.Tensor, fill):
    """All eight 8-connected neighbour reads, row-major over (dy, dx);
    reads outside the image give ``fill``."""
    h, w = a.shape[-2], a.shape[-1]
    p = _padded(a, fill)
    return tuple(
        p[..., 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
        for dy in (-1, 0, 1)
        for dx in (-1, 0, 1)
        if dy or dx
    )


def interior_mask(shape, device) -> torch.Tensor:
    """True except on the 1-px border (all False when h < 3 or w < 3)."""
    h, w = shape
    m = torch.zeros((h, w), dtype=torch.bool, device=device)
    if h > 2 and w > 2:
        m[1:-1, 1:-1] = True
    return m
