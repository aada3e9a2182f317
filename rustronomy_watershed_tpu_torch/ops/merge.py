"""Region merging for the merging (void-filling) variant's level sweep.

Counterpart of ``rustronomy_watershed_tpu.ops.merge``: the reference's
``find_merge`` + ``make_colour_map`` + ``recolour`` (reference
src/lib.rs:393-445, :467-542, :589-592) as label-table rounds:

1. adjacency scatter-min: every interior coloured pixel scatters its least
   differently-coloured 4-neighbour label into a per-label table, both ways;
2. hook: ``parent[u] = min(parent[u], parent[adj[u]])``;
3. pointer jumping to a fixed point;
4. repeat until no round lowers a root (each round lowers some root, so
   the loop ends, in practice in O(log) rounds).

The merged label is the least label of its set (SURVEY.md Q9); label 0
(UNCOLOURED) never takes part.  Plain PyTorch on any device; the host reads
one flag per pointer-jump step and per round, and ``_ext.launches``
counts the rounds as ``merge_round``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _ext
from ..constants import INT32_MAX, UNCOLOURED
from .stencil import interior_mask, shift4


def _pointer_jump(parent):
    """Compress ``parent`` until ``parent == parent[parent]``."""
    while True:
        p2 = parent[parent.long()]
        if torch.equal(p2, parent):
            return parent
        parent = p2


def _adjacency_min(cur, n_labels: int):
    """Per-label least partner over the reference's merge pairs: one pair
    per (interior coloured centre, differing coloured 4-neighbour), where
    the neighbour may be a border pixel but two border pixels never pair
    (no window is centred on a border pixel).  Each pair is scattered into
    both labels' entries, so a border label, which has no centre of its own,
    sees its partners too (merge.py:66-72).  Returns ``(n_labels + 1,)``
    int32, INT32_MAX where a label touches no other; labels above
    ``n_labels`` drop."""
    valid = (cur != UNCOLOURED) & interior_mask(cur.shape, cur.device)
    oob = n_labels + 1  # one spare slot takes the masked scatters
    adj = torch.full((n_labels + 2,), INT32_MAX, dtype=torch.int32, device=cur.device)
    for n in shift4(cur, UNCOLOURED):
        pair = valid & (n != UNCOLOURED) & (n != cur)
        for dst, src in ((cur, n), (n, cur)):
            idx = torch.where(pair, dst, oob).clamp_(max=oob).reshape(-1).long()
            adj.scatter_reduce_(0, idx, torch.where(pair, src, INT32_MAX).reshape(-1), "amin")
    return adj[: n_labels + 1]


def merge_touching(labels, n_labels: int):
    """Merge all 4-adjacent differently-coloured regions, least label wins:
    one reference merge phase (src/lib.rs:1446-1466), transitively complete
    in one call.  ``labels`` hold values 0..n_labels."""
    idx = labels.long()
    parent = torch.arange(n_labels + 1, dtype=torch.int32, device=labels.device)
    while True:
        _ext.launches["merge_round"] += 1
        adj = _adjacency_min(parent[idx], n_labels)
        cand = torch.where(adj != INT32_MAX, parent[adj.clamp(max=n_labels).long()], INT32_MAX)
        new_parent = _pointer_jump(torch.minimum(parent, cand))
        if torch.equal(new_parent, parent):
            return parent[idx]
        parent = new_parent


def resolve_merges(colour_map, pairs):
    """Apply an explicit merge-pair list to a colour LUT, least label wins:
    entries whose *value* belongs to a transitive merge set map to the set's
    least label, like the reference's ``make_colour_map`` (src/lib.rs:
    467-542).  ``pairs`` has shape (P, 2), any order, duplicates allowed;
    pairs naming a value outside the LUT drop."""
    colour_map = torch.as_tensor(colour_map, dtype=torch.int32)
    pairs = torch.as_tensor(pairs, dtype=torch.int64, device=colour_map.device).reshape(-1, 2)
    n = colour_map.shape[0]
    pairs = pairs[(pairs < n).all(1)]
    lo, hi = pairs.min(1).values, pairs.max(1).values
    parent = torch.arange(n, dtype=torch.int32, device=colour_map.device)
    while True:
        cand = parent.scatter_reduce(0, hi, parent[lo], "amin")
        cand.scatter_reduce_(0, lo, parent[hi], "amin")
        new_parent = _pointer_jump(cand)
        if torch.equal(new_parent, parent):
            return parent[colour_map.long()]
        parent = new_parent


def recolour(labels, colour_map):
    """Gather every pixel's label through the LUT (src/lib.rs:589-592)."""
    return torch.as_tensor(colour_map, dtype=torch.int32, device=labels.device)[labels.long()]


def touching_pairs(labels) -> set[tuple[int, int]]:
    """Host helper mirroring ``find_merge``'s deduplicated pair set
    (src/lib.rs:393-445): unordered pairs of differing coloured labels where
    one pixel is an interior centre 4-adjacent to the other.  For tests."""
    lab = np.asarray(labels)
    h, w = lab.shape
    out: set[tuple[int, int]] = set()
    for y in range(1, h - 1):
        for x in range(1, w - 1):
            c = int(lab[y, x])
            if c == UNCOLOURED:
                continue
            for ny, nx in ((y - 1, x), (y + 1, x), (y, x - 1), (y, x + 1)):
                n = int(lab[ny, nx])
                if n != UNCOLOURED and n != c:
                    out.add((min(c, n), max(c, n)))
    return out
