"""Flood (colouring) sweeps: one Jacobi sweep and the per-level fixed point.

Counterpart of ``rustronomy_watershed_tpu.ops.flood`` with the min
tie-break (SURVEY.md Q2).  One sweep is a whole-image 5-point stencil that
paints a pixel when it is

1. flooded: ``img <= lvl`` (reference src/lib.rs:224),
2. uncoloured: ``labels == UNCOLOURED`` (src/lib.rs:226),
3. next to a coloured 4-neighbour (src/lib.rs:228-231),
4. an interior pixel (3x3 window centres only, src/lib.rs:220-233),

with the minimum coloured 4-neighbour label.  Every decision of a sweep
reads the labels from its start (Jacobi), so one sweep advances the
wavefront by one 4-connected ring, the reference's plateau-claiming order
(SURVEY.md Q3).  Plain PyTorch on any device.

``flood_sweep_random`` is the opt-in stochastic tie-break
(``set_tie_break('random', seed)``): the reference's own plateau rule
(src/lib.rs:249-253), a uniformly random coloured 4-neighbour *position*,
drawn from one float32 uniform plane per transform (a pixel is painted
once, so it consumes its draw once).
"""

from __future__ import annotations

import torch

from ..constants import INT32_MAX, UNCOLOURED
from .stencil import interior_mask, shift4


def flood_candidates(img, labels, lvl, mask=None):
    """The reference's ``find_flooded_px`` phase alone (src/lib.rs:196-257):
    ``(cand, nmin, any_cand)`` without painting; ``any_cand`` is a 0-d bool
    tensor."""
    if mask is None:
        mask = interior_mask(labels.shape, labels.device)
    nmin = None
    for n in shift4(labels, UNCOLOURED):
        n = torch.where(n != UNCOLOURED, n, INT32_MAX)
        nmin = n if nmin is None else torch.minimum(nmin, n)
    cand = (labels == UNCOLOURED) & (img <= lvl) & (nmin != INT32_MAX) & mask
    return cand, nmin, cand.any()


def paint(labels, cand, nmin):
    """The paint phase (src/lib.rs:1428-1436): apply the found candidates."""
    return torch.where(cand, nmin, labels)


def flood_sweep(img, labels, lvl, mask=None):
    """One Jacobi flood sweep of int32 ``labels`` over the u8/int ``img``."""
    cand, nmin, _ = flood_candidates(img, labels, lvl, mask)
    return paint(labels, cand, nmin)


def flood_fixed_point(img, labels, lvl, sweep_fn=None):
    """Flood sweeps until no pixel changes (the per-level colouring loop,
    src/lib.rs:1394-1438); a do-while, so at least one sweep runs, like the
    reference.  ``sweep_fn(img, labels, lvl)`` swaps in another sweep that
    equals ``flood_sweep`` iterated >= 1 times.

    Returns ``(labels, painted)``: ``painted`` says whether the level
    painted a pixel (when False the merge phase can be skipped).  The host
    reads one change flag per sweep."""
    sweep_fn = sweep_fn or flood_sweep
    painted = False
    while True:
        new = sweep_fn(img, labels, lvl)
        changed = bool((new != labels).any())
        labels = new
        painted |= changed
        if not changed:
            return labels, painted


def flood_candidates_random(img, labels, lvl, u, mask=None):
    """flood_candidates under the random tie-break: ``(cand, choice,
    any_cand)`` with ``choice`` the coloured 4-neighbour of rank
    ``j = min(int32(u * float32(n_valid)), n_valid - 1)`` among the coloured
    ones in the order up, down, left, right (the JAX ``roll4`` order; the
    min guards the ``u * n == n`` rounding corner).  ``u`` is a float32
    uniform [0, 1) plane; ``choice`` matters only where ``cand``."""
    if mask is None:
        mask = interior_mask(labels.shape, labels.device)
    neigh = shift4(labels, UNCOLOURED)
    valid = [(n != UNCOLOURED).to(torch.int32) for n in neigh]
    n_valid = valid[0] + valid[1] + valid[2] + valid[3]
    j = torch.minimum((u * n_valid.to(torch.float32)).to(torch.int32), n_valid - 1)
    choice = torch.zeros_like(labels)
    rank = torch.zeros_like(n_valid)
    for v, n in zip(valid, neigh):
        choice = torch.where((v > 0) & (rank == j), n, choice)
        rank = rank + v
    cand = (labels == UNCOLOURED) & (img <= lvl) & (n_valid > 0) & mask
    return cand, choice, cand.any()


def flood_sweep_random(img, labels, lvl, *, u, mask=None):
    """One Jacobi flood sweep under the random tie-break; a ``sweep_fn``
    once ``u`` is bound (functools.partial)."""
    cand, choice, _ = flood_candidates_random(img, labels, lvl, u, mask)
    return paint(labels, cand, choice)
