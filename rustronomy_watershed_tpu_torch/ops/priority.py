"""Exact priority-relaxation engine: the segmenting transform as ONE fixed point.

Counterpart of ``rustronomy_watershed_tpu.ops.priority`` — see its module
docstring for the derivation.  Each pixel p carries the lexicographic claim
key ``(L(p), d(p))`` — the minimax water level at which p floods and the BFS
ring index through its equal-level plateau — and ``label(p)``, the minimum
label among neighbours claimed strictly before p.  Jacobi relaxation over
(L, d, label) converges to the unique fixed point, whose labels equal the
reference's level loop under the min-label tie-break.

L, d and labels are unpacked int32 planes here (d has 32 bits and cannot
saturate on any addressable image), so this engine is the readable oracle
of the packed kernels (ops/relax.py) and the fallback when their 23-bit d
field saturates (models/base.py).  Plain PyTorch, any device.

Neighbours outside the image read as unclaimed (``_BIG_L``, ``_BIG_D``) and
never donate.  The JAX engine wraps instead, which can hand a border cell
next to a border seed the claim level 255; such claims are above every
legal water level either way, so the labels are identical.
"""

from __future__ import annotations

import torch

from ..constants import NEVER_FILL, UNCOLOURED
from .stencil import shift4

_BIG_L = NEVER_FILL + 1  # > any claimable level
_BIG_D = 2**30
_BIG_LAB = 2**30


def _lex_lt(l1, d1, l2, d2):
    return (l1 < l2) | ((l1 == l2) & (d1 < d2))


def relax_sweep(v_eff, state):
    """One Jacobi relaxation sweep over (L, d, label)."""
    L, d, lab = state
    seeds = (L == 0) & (d == 0) & (lab != UNCOLOURED)
    nL, nd, nlab = shift4(L, _BIG_L), shift4(d, _BIG_D), shift4(lab, UNCOLOURED)

    best_l, best_d = L, d
    for Lq, dq in zip(nL, nd):
        lc = torch.maximum(v_eff, Lq)
        dc = torch.where(Lq == lc, dq + 1, 1)
        take = _lex_lt(lc, dc, best_l, best_d)
        best_l = torch.where(take, lc, best_l)
        best_d = torch.where(take, dc, best_d)

    # Labels: min over neighbours claimed strictly before OUR (new) key.
    lab_min = torch.full_like(lab, _BIG_LAB)
    for Lq, dq, labq in zip(nL, nd, nlab):
        qualifies = _lex_lt(Lq, dq, best_l, best_d)
        lab_min = torch.minimum(lab_min, torch.where(qualifies, labq, _BIG_LAB))

    new_lab = torch.where(lab_min == _BIG_LAB, lab, lab_min)
    # Seeds are immutable.
    return (
        torch.where(seeds, L, best_l),
        torch.where(seeds, d, best_d),
        torch.where(seeds, lab, new_lab),
    )


def init_state(img: torch.Tensor, labels0: torch.Tensor):
    """(v_eff, (L, d, label)): the 1-px border forced to NEVER_FILL (the
    reference never paints border pixels, src/lib.rs:220-233); seeds start
    claimed at key (0, 0)."""
    v = img.to(torch.int32).clone()
    v[0, :] = NEVER_FILL
    v[-1, :] = NEVER_FILL
    v[:, 0] = NEVER_FILL
    v[:, -1] = NEVER_FILL
    labels0 = labels0.to(torch.int32)
    seeds = labels0 != UNCOLOURED
    L = torch.where(seeds, 0, _BIG_L).to(torch.int32)
    d = torch.where(seeds, 0, _BIG_D).to(torch.int32)
    return v, (L, d, labels0)


def relax_transform(
    img: torch.Tensor,
    labels0: torch.Tensor,
    *,
    max_water_level: int = 254,
    collect_sweeps: bool = False,
):
    """Full segmenting transform by exact priority relaxation.

    Returns ``(labels, claim_levels[, n_sweeps])``: labels is bit-identical
    to the level-sweep drivers; claim_levels is L(p) (NEVER_FILL + 1 where
    never claimed).  The host reads one change flag per sweep.
    """
    v, state = init_state(img, labels0)
    n = 0
    while True:
        new = relax_sweep(v, state)
        n += 1
        changed = bool(torch.stack([(a != b).any() for a, b in zip(new, state)]).any())
        state = new
        if not changed:
            break
    L, _, lab = state
    labels = torch.where(L <= max_water_level, lab, UNCOLOURED)
    if collect_sweeps:
        return labels, L, n
    return labels, L


def sizes_from_levels(labels, claim_levels, n_labels: int, max_water_level: int):
    """(levels, K+1) per-level lake sizes from one (L, label) pass: a pixel
    is coloured at every level >= L(p), so counts are a 2-D bincount with a
    cumulative sum over levels; column 0 (uncoloured) is the complement."""
    levels = max_water_level + 1
    lab = labels.reshape(-1).to(torch.int64)
    lv = claim_levels.reshape(-1).clamp(0, levels).to(torch.int64)  # `levels` = never
    keep = lab <= n_labels  # out-of-range labels drop, like JAX's mode="drop"
    flat = lv[keep] * (n_labels + 1) + lab[keep]
    counts = torch.bincount(flat, minlength=(levels + 1) * (n_labels + 1))
    counts = counts.reshape(levels + 1, n_labels + 1)[:levels]
    cum = torch.cumsum(counts, 0)
    coloured = cum[:, 1:].sum(1)
    cum[:, 0] = labels.numel() - coloured
    return cum.to(torch.int32)
