"""Component-min labelling: the merging variant's final labels.

Counterpart of ``rustronomy_watershed_tpu.ops.scan_merge``.  At the final
water level the merging transform's output is "every 4-connected component
of the claimed set (label != 0) takes its minimum label", where the edges
between two border pixels are blocked: the vertical edges inside columns 0
and w-1 and the horizontal edges inside rows 0 and h-1 (the reference only
detects merge pairs through 3x3 windows centred on interior pixels).

Two engines, bit-identical labels:

* ``component_min_labels_plain`` — the readable oracle, a port of the JAX
  package's associative-scan form (scan_merge.py:553-640): segmented run-min
  scans along columns, then rows, with the blocked border lines restored,
  until nothing changes.  Plain PyTorch; the CPU engine when a coarse gate
  fails.
* ``component_min_coarse`` — the 2x-row-coarsened engine (the JAX package's
  ``component_min_coarse_from_padded``, scan_merge.py:1268-1370) in three
  kernels: ``coarsen`` (csrc/coarsen.cu) packs each column's fine row pair
  into one coarse cell with four scan-reset bits, ``coarse_round``
  (csrc/coarse_round.cu) runs rounds of full-length segmented min scans to
  the fixed point, ``coarse_broadcast`` (csrc/coarse_broadcast.cu) expands
  the result back to the fine plane.  Each kernel has its plain twin here; a
  CPU tensor runs the twin, a CUDA tensor the kernel.

Why the coarse graph is exact (scan_merge.py:643-678): a column's fine pair
(2i, 2i+1) is internally connected when both are claimed, so one node per
pair with value min(claimed labels), a v-edge (i-1, i) iff fine rows 2i-1
and 2i are both claimed, and an h-edge iff the top halves or the bottom
halves of two neighbouring pairs are both claimed (blocked border rows
excepted), has the same components and minima.  Border columns leave the
system: their only edges (horizontal, into columns 1 and w-2, rows 1..h-2)
are folded into those columns before the scans and resolved after the
broadcast.

The coarse plane is ``(ceil(h/2), w)`` int32 with no aprons: the value in
bits 0..23 (0 = empty node) and the forward / backward, vertical /
horizontal reset bits at 24..27.  A reset bit set means "no edge towards
the previous (forward) or next (backward) cell"; empty cells set all four.
A cell outside the image reads as unclaimed, so an odd ``h`` needs no
padding.
"""

from __future__ import annotations

import torch

from .. import _ext
from ..constants import _INF

_CVAL = (1 << 24) - 1  # value bits of a coarse cell; labels must stay below
_CB_VF = 24  # forward-vertical reset bit
_CB_VB = 25  # backward-vertical reset bit
_CB_HF = 26  # forward-horizontal reset bit
_CB_HB = 27  # backward-horizontal reset bit
_BIG = 2**30  # the oracle's "no label" inside a run (scan_merge.py:555)


# -- plain building blocks ----------------------------------------------------


def _seg_min_scan(x, reset, dim: int, reverse: bool = False):
    """Inclusive segmented min scan along ``dim``: ``out[i] = x[i]`` where
    ``reset[i]``, else ``min(x[i], out[i-1])`` (``out[i+1]`` with
    ``reverse``).  ``x`` holds int32 values in ``[0, 2**30]``."""
    if reverse:
        return _seg_min_scan(x.flip(dim), reset.flip(dim), dim).flip(dim)
    # A running max of (segment id, 2**31 - 1 - x) packed into one int64:
    # the current segment's id dominates every earlier segment's.
    seg = torch.cumsum(reset, dim, dtype=torch.int64)
    low = (1 << 31) - 1
    run = torch.cummax((seg << 32) | (low - x.to(torch.int64)), dim).values
    return (low - (run & 0xFFFFFFFF)).to(torch.int32)


def _run_min(x, dim: int):
    """Each maximal run of nonzero values along ``dim`` replaced by its
    minimum; zeros stay zero (the JAX ``_vscan_jnp``)."""
    zero = x == 0
    y = torch.where(zero, _BIG, x)
    y = _seg_min_scan(_seg_min_scan(y, zero, dim), zero, dim, reverse=True)
    return torch.where(zero, 0, y)


def component_min_labels_plain(labels):
    """Every 4-connected component of nonzero labels (blocked border-border
    edges excluded) replaced by its minimum label — the oracle."""
    lab = labels.to(torch.int32)
    while True:
        v = _run_min(lab, 0)
        v[:, 0], v[:, -1] = lab[:, 0], lab[:, -1]  # blocked vertical edges
        new = _run_min(v, 1)
        new[0, :], new[-1, :] = v[0, :], v[-1, :]  # blocked horizontal edges
        if torch.equal(new, lab):
            return new
        lab = new


def _check_cuda_planes(*planes):
    if not all(
        t.is_cuda and t.dtype == torch.int32 and t.dim() == 2 and t.is_contiguous()
        and t.device == planes[0].device
        for t in planes
    ):
        raise ValueError("coarse kernels take contiguous 2-D int32 planes on one CUDA device")


def _check_width(w: int):
    if w < 3:
        raise ValueError(f"the coarse engine needs w >= 3 (got {w})")


def _dispatch(kernel, plain, lead):
    if lead.device.type == "cuda":
        return kernel
    if lead.device.type == "cpu":
        return plain
    raise ValueError(f"unsupported device {lead.device}")


# -- coarsen: fine labels -> packed coarse plane (csrc/coarsen.cu) ------------


def coarsen_plain(lab):
    """Plain twin of the coarsen kernel: the ``(ceil(h/2), w)`` packed plane."""
    _ext.launches["coarsen_plain"] += 1
    h, w = lab.shape
    _check_width(w)
    hc = (h + 1) // 2
    # Fine rows -1 .. 2*hc: zero outside the image.
    fp = torch.zeros((2 * hc + 2, w), dtype=torch.int32, device=lab.device)
    fp[1 : h + 1] = lab
    top, bot = fp[1 : 2 * hc : 2], fp[2 : 2 * hc + 1 : 2]
    prev_bot, next_top = fp[0 : 2 * hc - 1 : 2], fp[3 : 2 * hc + 2 : 2]
    r0 = 2 * torch.arange(hc, device=lab.device)[:, None]
    ok0 = (r0 != 0) & (r0 != h - 1)  # fine row 2i is not a border row
    ok1 = r0 + 1 != h - 1  # fine row 2i+1 is not a border row
    tcl, bcl = top != 0, bot != 0
    val = torch.minimum(torch.where(tcl, top, _INF), torch.where(bcl, bot, _INF))
    val = torch.where(tcl | bcl, val, 0)
    # Border-column folds: a claimed border cell in rows 1..h-2 joins its
    # claimed same-row neighbour in column 1 / w-2.
    for plane, cl, ok in ((top, tcl, ok0[:, 0]), (bot, bcl, ok1[:, 0])):
        for x, bx in ((1, 0), (w - 2, w - 1)):
            nb = plane[:, bx]
            fold = cl[:, x] & (nb != 0) & ok
            val[:, x] = torch.where(fold, torch.minimum(val[:, x], nb & _CVAL), val[:, x])
    val[:, 0] = 0
    val[:, -1] = 0
    empty = val == 0
    vf = empty | ~((prev_bot != 0) & tcl)
    vb = empty | ~(bcl & (next_top != 0))
    cols = torch.arange(w, device=lab.device)
    interior = (cols > 0) & (cols < w - 1)
    tcl_e, bcl_e = tcl & interior & ok0, bcl & interior & ok1
    hedge = torch.zeros_like(empty)  # hedge[:, x]: an edge (x-1, x)
    hedge[:, 1:] = (tcl_e[:, :-1] & tcl_e[:, 1:]) | (bcl_e[:, :-1] & bcl_e[:, 1:])
    hedge_next = torch.zeros_like(empty)
    hedge_next[:, :-1] = hedge[:, 1:]
    hf, hb = empty | ~hedge, empty | ~hedge_next
    for b, shift in zip((vf, vb, hf, hb), (_CB_VF, _CB_VB, _CB_HF, _CB_HB)):
        val = val | (b.to(torch.int32) << shift)
    return val


def coarsen_kernel(lab):
    """Launch csrc/coarsen.cu on a CUDA label plane; same output as
    coarsen_plain."""
    _check_cuda_planes(lab)
    h, w = lab.shape
    _check_width(w)
    c = torch.empty(((h + 1) // 2, w), dtype=torch.int32, device=lab.device)
    err = _ext.lib().rwt_coarsen(lab.data_ptr(), c.data_ptr(), h, w, _ext.stream_ptr(lab))
    _ext.check(err, "rwt_coarsen")
    _ext.launches["coarsen"] += 1
    return c


def coarsen(lab):
    return _dispatch(coarsen_kernel, coarsen_plain, lab)(lab)


# -- coarse rounds (csrc/coarse_round.cu) -------------------------------------


def _coarse_pass(c, dim: int, fwd_bit: int):
    """Forward then backward segmented min scans of every line along
    ``dim`` under the cell's reset bits; returns the new plane and the count
    of cells whose value changed."""
    x = c & _CVAL
    empty = x == 0
    v = torch.where(empty, _INF, x)
    v = _seg_min_scan(v, ((c >> fwd_bit) & 1).bool(), dim)
    v = _seg_min_scan(v, ((c >> (fwd_bit + 1)) & 1).bool(), dim, reverse=True)
    out = torch.where(empty, 0, v)
    return (c & ~_CVAL) | out, (out != x).sum(dtype=torch.int32)


def coarse_round_plain(c, *, out=None, scratch=None):
    """Plain twin of one coarse round: the v-pass over columns, then the
    h-pass over rows.  Returns ``(plane, changed)``, ``changed`` a
    one-element int32 tensor counting the cells each pass changed."""
    _ext.launches["coarse_round_plain"] += 1
    c1, n1 = _coarse_pass(c, 0, _CB_VF)
    c2, n2 = _coarse_pass(c1, 1, _CB_HF)
    if out is not None:
        out.copy_(c2)
        c2 = out
    return c2, (n1 + n2).reshape(1)


def coarse_round_kernel(c, *, out=None, scratch=None):
    """Launch csrc/coarse_round.cu: the v-pass from ``c`` into ``scratch``,
    then the h-pass into ``out`` (which may be ``c`` itself)."""
    out = torch.empty_like(c) if out is None else out
    scratch = torch.empty_like(c) if scratch is None else scratch
    _check_cuda_planes(c, out, scratch)
    if not c.shape == out.shape == scratch.shape:
        raise ValueError("coarse round planes must share one shape")
    if scratch.data_ptr() in (c.data_ptr(), out.data_ptr()):
        raise ValueError("the coarse round's scratch plane must not alias its input or output")
    hc, w = c.shape
    changed = torch.empty((1,), dtype=torch.int32, device=c.device)
    err = _ext.lib().rwt_coarse_round(
        c.data_ptr(), scratch.data_ptr(), out.data_ptr(), changed.data_ptr(), hc, w,
        _ext.stream_ptr(c),
    )
    _ext.check(err, "rwt_coarse_round")
    _ext.launches["coarse_round"] += 1
    return out, changed


def coarse_round(c, *, out=None, scratch=None):
    """One round (v-pass, then h-pass) over the whole coarse plane."""
    return _dispatch(coarse_round_kernel, coarse_round_plain, c)(c, out=out, scratch=scratch)


# -- coarse -> fine (csrc/coarse_broadcast.cu) --------------------------------


def coarse_broadcast_plain(c, lab):
    """Plain twin of the broadcast kernel: each claimed fine cell takes its
    coarse cell's value; a border-column cell in rows 1..h-2 takes the min of
    its own label and its claimed same-row interior neighbour's new value,
    and keeps its own label otherwise."""
    _ext.launches["coarse_broadcast_plain"] += 1
    h, w = lab.shape
    _check_width(w)
    out = torch.where(lab != 0, (c & _CVAL).repeat_interleave(2, dim=0)[:h], 0)
    rows = torch.arange(h, device=lab.device)
    row_ok = (rows != 0) & (rows != h - 1)
    for x, nx in ((0, 1), (w - 1, w - 2)):
        own, nb = lab[:, x], out[:, nx]
        merged = (own != 0) & (nb != 0) & row_ok
        out[:, x] = torch.where(merged, torch.minimum(own, nb), own)
    return out


def coarse_broadcast_kernel(c, lab):
    """Launch csrc/coarse_broadcast.cu; same output as the twin."""
    _check_cuda_planes(c, lab)
    h, w = lab.shape
    _check_width(w)
    if c.shape != ((h + 1) // 2, w):
        raise ValueError(f"coarse plane {tuple(c.shape)} does not match labels {(h, w)}")
    out = torch.empty_like(lab)
    err = _ext.lib().rwt_coarse_broadcast(
        c.data_ptr(), lab.data_ptr(), out.data_ptr(), h, w, _ext.stream_ptr(lab)
    )
    _ext.check(err, "rwt_coarse_broadcast")
    _ext.launches["coarse_broadcast"] += 1
    return out


def coarse_broadcast(c, lab):
    return _dispatch(coarse_broadcast_kernel, coarse_broadcast_plain, lab)(c, lab)


# -- the driver ----------------------------------------------------------------


def component_min_coarse(labels, n_labels: int):
    """Component-min labels on the coarse engine; returns ``(labels,
    rounds)``, ``rounds`` counting the final quiet round.

    ``n_labels`` bounds the labels (1..n_labels).  Gates: labels below
    2**24 (the packed value width) and ``w >= 3`` (narrower planes have no
    coarse system).  When a gate fails a CPU plane runs the oracle (rounds
    0) and a CUDA plane raises: its engine is the fine scan tail, which is
    not ported yet.  The host reads one change count per round.
    """
    h, w = labels.shape
    if n_labels >= 1 << 24 or w < 3:
        if labels.device.type == "cuda":
            raise NotImplementedError(
                f"component-min on a {h}x{w} plane with labels up to {n_labels} needs "
                "the fine scan tail, which is not ported to the PyTorch package yet "
                "(ROADMAP queue 1 item 10)"
            )
        return component_min_labels_plain(labels), 0
    c = coarsen(labels)
    scratch = torch.empty_like(c)
    rounds = 0
    while True:
        c, changed = coarse_round(c, out=c, scratch=scratch)
        rounds += 1
        if not int(changed.item()):
            return coarse_broadcast(c, labels), rounds
