"""Seed finding: the reference's ``find_local_minima``.

Counterpart of ``rustronomy_watershed_tpu.ops.seeds``.  A pixel is a seed iff
**all eight** 8-connected neighbours are **strictly less** than the centre
(reference src/lib.rs:1190) — strict local *maxima*, despite the name
(SURVEY.md Q1).  Border pixels are never candidates and plateaus never seed;
a 255 (NEVER_FILL) pixel can be a seed.

Seeds are numbered 1..K in row-major order by an integer prefix sum over the
flattened mask — no float matmul, so no TF32/bf16 truncation hazard (the JAX
version's MXU prefix needed ``Precision.HIGHEST``, PARITY.md hazard log).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from .. import _ext
from .stencil import interior_mask, shift8

# Entry types whose iteration is the (y, x) pair that np.asarray reads from
# them; a str, bytes or dict of length 2 iterates otherwise.
_PAIR_TYPES = frozenset((tuple, list))


def local_extrema_mask(img: torch.Tensor, mode: str = "reference") -> torch.Tensor:
    """Boolean seed mask.

    ``mode='reference'`` (default) keeps the reference's quirk: strict local
    maxima.  ``mode='minima'`` gives the documented intent (all 8 neighbours
    greater than the centre).
    """
    if mode == "reference":
        cmp = torch.lt
    elif mode == "minima":
        cmp = torch.gt
    else:
        raise ValueError(f"unknown mode {mode!r}")
    ok = interior_mask(img.shape, img.device)
    # The fill is never observed: border centres are masked out above.
    for nb in shift8(img, 0):
        ok &= cmp(nb, img)
    return ok


def seed_labels_from_mask(mask: torch.Tensor) -> torch.Tensor:
    """int32 label image: seeds numbered 1..K row-major, 0 elsewhere."""
    ranks = torch.cumsum(mask.reshape(-1).to(torch.int32), 0, dtype=torch.int32)
    return torch.where(mask, ranks.reshape(mask.shape), 0).to(torch.int32)


def seed_array(seeds) -> np.ndarray:
    """``(n, 2)`` int64 coordinates from a (y, x) list or array.

    A non-empty sequence of tuples or lists of two, such as
    ``find_local_minima``'s list, is read as one flat stream of coordinates
    (counted in ``_ext.launches["seed_array_flat"]``); any other sequence,
    and one the flat read refuses, goes through ``np.asarray``
    (``seed_array_generic``), which gives the same array for such pairs."""
    if not isinstance(seeds, np.ndarray):
        seeds = list(seeds)
        if seeds and set(map(type, seeds)) <= _PAIR_TYPES and set(map(len, seeds)) == {2}:
            try:
                flat = np.fromiter(itertools.chain.from_iterable(seeds), np.int64, count=2 * len(seeds))
            except (TypeError, ValueError, OverflowError):
                pass  # e.g. a nested pair, None or NaN: np.asarray reads or refuses it
            else:
                _ext.launches["seed_array_flat"] += 1
                return flat.reshape(-1, 2)
        _ext.launches["seed_array_generic"] += 1
    return np.asarray(seeds, dtype=np.int64).reshape(-1, 2)


def paint_seeds(shape: tuple[int, int], seeds) -> np.ndarray:
    """int32 label image from an explicit (y, x) list (reference API shape).

    Colours are 1..len(seeds) in list order (src/lib.rs:1358-1369); at a
    duplicate coordinate the later seed wins, like the reference's
    sequential paint loop (vectorised with a keep-last dedup).
    """
    labels = np.zeros(shape, dtype=np.int32)
    coords = seed_array(seeds)
    if coords.shape[0]:
        flat = coords[:, 0] * shape[1] + coords[:, 1]
        # Last occurrence of each coordinate wins, like the sequential loop.
        rev_first = np.unique(flat[::-1], return_index=True)[1]
        keep = flat.shape[0] - 1 - rev_first
        cols = np.arange(1, flat.shape[0] + 1, dtype=np.int32)
        labels.reshape(-1)[flat[keep]] = cols[keep]
    return labels
