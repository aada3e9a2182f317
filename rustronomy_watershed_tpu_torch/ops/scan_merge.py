"""Component-min labelling: the merging variant's final labels.

Counterpart of ``rustronomy_watershed_tpu.ops.scan_merge``.  At the final
water level the merging transform's output is "every 4-connected component
of the claimed set (label != 0) takes its minimum label", where the edges
between two border pixels are blocked: the vertical edges inside columns 0
and w-1 and the horizontal edges inside rows 0 and h-1 (the reference only
detects merge pairs through 3x3 windows centred on interior pixels).

Three engines, bit-identical labels:

* ``component_min_labels_plain`` — the readable oracle, a port of the JAX
  package's associative-scan form (scan_merge.py:553-640): segmented run-min
  scans along columns, then rows, with the blocked border lines restored,
  until nothing changes.  Plain PyTorch.
* ``component_min_fine`` — the fine scan tail (the JAX package's
  ``_component_min_pallas`` / ``component_min_from_padded``,
  scan_merge.py:409-550): rounds of two passes on the label plane,
  ``fwd_v`` (forward vertical scan) and ``bwd_vh`` (backward vertical scan,
  horizontal run-min, violation stencil), both in csrc/scan_round.cu.  One
  round equals one oracle iteration.  It serves every plane;
  ``component_min_labels`` runs it when the coarse gate fails (labels
  >= 2**24, or w < 3).
* ``component_min_coarse`` — the 2x-row-coarsened engine (the JAX package's
  ``component_min_coarse_from_padded``, scan_merge.py:1268-1441):
  ``coarsen`` (csrc/coarsen.cu) packs each column's fine row pair into one
  coarse cell with four scan-reset bits, rounds run to the fixed point,
  ``coarse_broadcast`` (csrc/coarse_broadcast.cu) expands the result back to
  the fine plane.  The rounds are ``coarse_round`` (csrc/scan_round.cu,
  the port's schedule: column tiles with a look-back, then the ring row
  kernel) by default, or with ``RWT_COARSE_MULTI=0`` the JAX
  package's legacy two-pass rounds ``cfwd_v`` / ``cbwd_vh``
  (csrc/scan_round.cu, coarse encoding), whose h-scans are windowed to
  ``RWT_COARSE_HWIN`` lanes on most rounds.

Each kernel has its plain twin here; a CPU tensor runs the twin, a CUDA
tensor the kernel (or raises).

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
padding.  The fine planes carry no aprons either: cells outside read as 0.
"""

from __future__ import annotations

import functools
import itertools
import os
import types

import torch

from .. import _ext
from ..constants import _INF
from ..utils.tracing import spanned

_CVAL = (1 << 24) - 1  # value bits of a coarse cell; labels must stay below
_CB_VF = 24  # forward-vertical reset bit
_CB_VB = 25  # backward-vertical reset bit
_CB_HF = 26  # forward-horizontal reset bit
_CB_HB = 27  # backward-horizontal reset bit
_BIG = 2**30  # the oracle's "no label" inside a run (scan_merge.py:555)


def _parse_coarse_hwin() -> int | None:
    """``RWT_COARSE_HWIN``, parsed once at import (scan_merge.py:53-70): the
    legacy coarse rounds' h-scan window in lanes, default 256; ``0``,
    ``off`` or empty mean full width; a value below 2 raises."""
    raw = os.environ.get("RWT_COARSE_HWIN", "256")
    if raw in ("", "0", "off"):
        return None
    v = int(raw)
    if v < 2:
        raise ValueError(f"RWT_COARSE_HWIN={raw!r}: need >= 2 lanes, or 0/off to disable")
    return v


_COARSE_HWIN = _parse_coarse_hwin()
# RWT_COARSE_MULTI=0 selects the legacy two-pass coarse rounds
# (scan_merge.py:75-81); parsed once at import.  RWT_COARSE_K belongs to the
# TPU's multi-iteration kernel, whose schedule the port does not carry.
_COARSE_MULTI = os.environ.get("RWT_COARSE_MULTI", "1") not in ("0", "off")


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


def _reach(n: int, h_window) -> int:
    """How many cells a windowed h-scan of a line of ``n`` cells reaches
    back (or ahead) within its run, or -1 for the whole line.  The TPU's
    lane doubling with a limit runs ceil(log2(min(n, limit))) steps, so it
    reaches ``2**steps - 1`` cells, not ``limit - 1`` (scan_merge.py:84-126):
    255 for the default 256, 511 for 300."""
    if h_window is None:
        return -1
    s = 1
    while s < min(n, h_window):
        s *= 2
    return -1 if s - 1 >= n - 1 else s - 1


def _window_min_scan(x, reset, reach: int, reverse: bool = False):
    """``_seg_min_scan`` along rows whose reach is bounded: ``out[i]`` is
    the min of ``x`` over ``i-reach..i`` back to and including the last
    reset (``i..i+reach`` with ``reverse``); the whole run when ``reach``
    is -1.  The windowed form doubles, as the TPU kernel does."""
    if reach < 0:
        return _seg_min_scan(x, reset, 1, reverse)
    if reverse:
        return _window_min_scan(x.flip(1), reset.flip(1), reach).flip(1)
    v, r = x, reset
    s = 1
    while s <= reach:  # strides 1, 2, 4, ...: a window of 2 * s cells
        pv = torch.full_like(v, _INF)
        pr = torch.zeros_like(r)
        pv[:, s:], pr[:, s:] = v[:, :-s], r[:, :-s]
        v = torch.where(r, v, torch.minimum(v, pv))
        r = r | pr
        s *= 2
    return v


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
        raise ValueError("scan kernels take contiguous 2-D int32 planes on one CUDA device")


def _check_width(w: int):
    if w < 3:
        raise ValueError(f"the coarse engine needs w >= 3 (got {w})")


def _dispatch(kernel, plain, lead):
    if lead.device.type == "cuda":
        return kernel
    if lead.device.type == "cpu":
        return plain
    raise ValueError(f"unsupported device {lead.device}")


def _into(out, plane):
    if out is None:
        return plane
    out.copy_(plane)
    return out


def _round_planes(x, out, scratch):
    out = torch.empty_like(x) if out is None else out
    scratch = torch.empty_like(x) if scratch is None else scratch
    _check_cuda_planes(x, out, scratch)
    if not x.shape == out.shape == scratch.shape:
        raise ValueError("scan round planes must share one shape")
    if scratch.data_ptr() in (x.data_ptr(), out.data_ptr()):
        raise ValueError("the scan round's scratch plane must not alias its input or output")
    return out, scratch


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


# The coarsen kernel's launch plan, computed here so that the CPU tests can
# check it; csrc/coarsen.cu launches it as given and refuses a plan that
# does not cover the plane.
_COARSEN_THREADS = 256  # kThreads: the most threads a coarsen block has
# Coarse rows a strip: the shortest strip that reads a fine row less than
# twice, fastest of 1..32 at 4096^2 on the H100 (more blocks in flight).
_COARSEN_STRIP = 2
_GRID_Y = 65535  # the most blocks along a grid's y axis


@functools.lru_cache(maxsize=256)
def coarsen_plan(h: int, w: int, aligned: bool = True) -> dict:
    """The coarsen launch: ``route`` ``"vec"`` (w % 4 == 0 and the planes
    16-byte aligned: ``threads`` threads of 4 columns each, strips of
    ``k_rows`` coarse rows (``_COARSEN_STRIP``, more where the grid's y axis
    would overflow), ``grid`` (column blocks, strips)) or
    ``"cells"`` (a thread per coarse cell, ``grid`` (blocks, 1)).  Cached,
    so read-only."""
    _check_width(w)
    hc = (h + 1) // 2
    if w % 4 or not aligned:
        n = hc * w
        return types.MappingProxyType({"route": "cells", "threads": _COARSEN_THREADS, "k_rows": 0,
                                       "grid": (-(-n // _COARSEN_THREADS), 1)})
    cols = w // 4
    threads = min(_COARSEN_THREADS, 32 * -(-cols // 32))
    gx = -(-cols // threads)
    k = max(_COARSEN_STRIP, -(-hc // _GRID_Y))
    return types.MappingProxyType({"route": "vec", "threads": threads, "k_rows": k, "grid": (gx, -(-hc // k))})


def coarsen_kernel(lab):
    """Launch csrc/coarsen.cu on a CUDA label plane; same output as
    coarsen_plain.  The route ``coarsen_plan`` picks is counted as
    ``coarsen_vec`` or ``coarsen_cells``."""
    _check_cuda_planes(lab)
    h, w = lab.shape
    _check_width(w)
    c = torch.empty(((h + 1) // 2, w), dtype=torch.int32, device=lab.device)
    plan = coarsen_plan(h, w, _vec(w, lab, c))
    err = _ext.lib().rwt_coarsen(
        lab.data_ptr(), c.data_ptr(), h, w, 0 if plan["route"] == "vec" else 1, plan["threads"],
        plan["k_rows"], *plan["grid"], _ext.stream_ptr(lab),
    )
    _ext.check(err, "rwt_coarsen")
    _ext.launches["coarsen"] += 1
    _ext.launches[f"coarsen_{plan['route']}"] += 1
    return c


def coarsen(lab):
    return _dispatch(coarsen_kernel, coarsen_plain, lab)(lab)


# -- coarse rounds (csrc/scan_round.cu) ---------------------------------------


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


def _check_round_words(c, out, go, changed):
    for t in (go, changed):
        if t is not None and (t.shape != (1,) or t.dtype != torch.int32 or t.device != c.device):
            raise ValueError("a coarse round's go and changed are one-element int32 tensors on the plane's device")
    if go is not None and out is not c:
        raise ValueError("a coarse round with go runs in place (out is c)")
    if go is not None and changed is not None and go.data_ptr() == changed.data_ptr():
        raise ValueError("a coarse round's changed must not be its go")


def _plain_round(c, out, go, changed) -> bool:
    """The twin's round into ``out`` and ``changed``, uncounted; when ``go``
    holds 0 it stops: ``out`` (which is ``c``) stays and ``changed`` reads
    0.  Returns whether the round ran."""
    if go is not None and not go.item():
        changed.zero_()
        return False
    c1, n1 = _coarse_pass(c, 0, _CB_VF)
    c2, n2 = _coarse_pass(c1, 1, _CB_HF)
    out.copy_(c2)
    changed.copy_((n1 + n2).reshape(1))
    return True


def coarse_round_plain(c, *, out=None, scratch=None, go=None, changed=None):
    """Plain twin of one coarse round: the v-pass over columns, then the
    h-pass over rows.  Returns ``(plane, changed)``, ``changed`` a
    one-element int32 tensor counting the cells each pass changed (the one
    given, when given).  ``go``: the previous round's ``changed``; the round
    then runs in place, and when ``go`` holds 0 it stops at once: the plane
    stays, ``changed`` reads 0, and it is counted as
    ``coarse_round_skipped``."""
    _check_round_words(c, out, go, changed)
    out = torch.empty_like(c) if out is None else out
    changed = _flag_on(c) if changed is None else changed
    ran = _plain_round(c, out, go, changed)
    _ext.launches["coarse_round_plain" if ran else "coarse_round_skipped"] += 1
    return out, changed


def coarse_round_kernel(c, *, out=None, scratch=None):
    """Launch the coarse round of csrc/scan_round.cu: the v-pass as two
    column scans from ``c`` into ``scratch``, then the h-pass into ``out``
    (which may be ``c`` itself) on the row route ``row_plan`` picks, counted
    at the launch as ``coarse_round``, ``coarse_round_launched`` and
    ``coarse_round_ring`` or ``coarse_round_chunked``."""
    out, scratch = _round_planes(c, out, scratch)
    changed = _flag_on(c)
    launch = _round_launcher(c, out, scratch, changed)
    launch(0, None)
    launch.settle(1, 0)  # a round without go runs
    return out, changed


def _round_launcher(c, out, scratch, words):
    """The coarse round's launcher on checked planes ``c`` -> ``out`` with
    ``scratch``, and ``words``, int32 words on the device: its plan and
    status buffer made once.  ``launch(i, g)`` queues one round that writes
    its change count to ``words[i]``; with ``g`` not None it runs in place
    and reads ``words[g]`` first, on the device, and stops at once when that
    holds 0: the plane stays and ``words[i]`` reads 0.  Each launch is
    counted at the launch as ``coarse_round_launched`` and its row route;
    ``launch.settle(ran, skipped)``, called once the words are read, counts
    the rounds that ran as ``coarse_round`` and those that stopped as
    ``coarse_round_skipped``."""
    hc, w = c.shape
    vec = _vec(w, c, scratch)
    plan = row_plan(hc, w, _ext.sm_count(c.get_device()), coarse=True)
    vp = vscan_plan(hc, w, vec)
    # [the two column scans' counters and tile flags, one carry area]
    status = torch.empty((vp["status_ints"] + 1 + vp["n_tiles"],), dtype=torch.int32, device=c.device)
    fn, planes = _ext.lib().rwt_coarse_round, (c.data_ptr(), scratch.data_ptr(), out.data_ptr())
    rest = (status.data_ptr(), hc, w, int(vec), plan["rows_per_step"], plan["band_rows"], plan["threads"],
            plan["smem"], _ext.stream_ptr(c))
    base, route = words.data_ptr(), f"coarse_round_{plan['route']}"

    def launch(i: int, g):
        _ext.check(fn(*planes, base + 4 * i, None if g is None else base + 4 * g, *rest), "rwt_coarse_round")
        _ext.launches["coarse_round_launched"] += 1
        _ext.launches[route] += 1

    launch.status = status  # held while the launcher is
    launch.settle = _count_coarse_rounds
    return launch


def _plain_round_launcher(c, out, scratch, words):
    """``_round_launcher``'s twin: each launch a ``coarse_round_plain``,
    which counts itself."""

    def launch(i: int, g):
        coarse_round_plain(c, out=out, go=None if g is None else words[g : g + 1], changed=words[i : i + 1])

    launch.settle = lambda ran, skipped: None
    return launch


def _count_coarse_rounds(ran: int, skipped: int):
    """Count ``ran`` coarse rounds of the kernel as ``coarse_round`` and
    ``skipped`` as ``coarse_round_skipped``."""
    _ext.launches["coarse_round"] += ran
    _ext.launches["coarse_round_skipped"] += skipped


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


# The broadcast kernel's launch plan; csrc/coarse_broadcast.cu launches it
# as given and refuses a plan that does not cover the plane.
_BROADCAST_THREADS = 256  # kMaxThreads: the most threads a broadcast block has


@functools.lru_cache(maxsize=256)
def broadcast_plan(h: int, w: int, aligned: bool = True) -> dict:
    """The broadcast launch: ``route`` ``"vec"`` (w % 4 == 0 and the planes
    16-byte aligned: ``threads`` threads of 4 columns each, ``k_rows``
    coarse rows a thread (one, more where the grid's y axis would
    overflow), ``grid`` (column blocks, row blocks)) or ``"cells"`` (a
    thread per column and fine row, ``grid`` (column blocks, fine rows up
    to ``_GRID_Y``; the kernel strides past it)).  Cached, so read-only."""
    _check_width(w)
    if w % 4 or not aligned:
        threads = min(_BROADCAST_THREADS, 32 * -(-w // 32))
        return types.MappingProxyType({"route": "cells", "threads": threads, "k_rows": 0,
                                       "grid": (-(-w // threads), max(1, min(h, _GRID_Y)))})
    hc, cols = (h + 1) // 2, w // 4
    threads = min(_BROADCAST_THREADS, 32 * -(-cols // 32))
    k = max(1, -(-hc // _GRID_Y))
    return types.MappingProxyType({"route": "vec", "threads": threads, "k_rows": k,
                                   "grid": (-(-cols // threads), max(1, -(-hc // k)))})


def coarse_broadcast_kernel(c, lab):
    """Launch csrc/coarse_broadcast.cu; same output as the twin.  The route
    ``broadcast_plan`` picks is counted as ``coarse_broadcast_vec`` or
    ``coarse_broadcast_cells``."""
    _check_cuda_planes(c, lab)
    h, w = lab.shape
    _check_width(w)
    if c.shape != ((h + 1) // 2, w):
        raise ValueError(f"coarse plane {tuple(c.shape)} does not match labels {(h, w)}")
    out = torch.empty_like(lab)
    plan = broadcast_plan(h, w, _vec(w, c, lab, out))
    err = _ext.lib().rwt_coarse_broadcast(
        c.data_ptr(), lab.data_ptr(), out.data_ptr(), h, w, 0 if plan["route"] == "vec" else 1,
        plan["threads"], plan["k_rows"], *plan["grid"], _ext.stream_ptr(lab),
    )
    _ext.check(err, "rwt_coarse_broadcast")
    _ext.launches["coarse_broadcast"] += 1
    _ext.launches[f"coarse_broadcast_{plan['route']}"] += 1
    return out


def coarse_broadcast(c, lab):
    return _dispatch(coarse_broadcast_kernel, coarse_broadcast_plain, lab)(c, lab)


# -- round passes (csrc/scan_round.cu) -----------------------------------------


def _fine_vertical_violations(out):
    """The vertical half of the fine witness: some claimed vertical pair off
    the border columns holds two labels.  On ``bwd_vh``'s output it is the
    whole witness (every interior row is constant along its runs after the
    horizontal run-min, and border rows are blocked), so the kernel checks
    only this half, fused into its row launch."""
    cl = out > 0
    v = (out[1:] != out[:-1]) & cl[1:] & cl[:-1]
    v[:, 0] = False
    v[:, -1] = False
    return v.any()


def _fine_violations(out):
    """The fine fixed-point witness (scan_merge.py:294-330) over a whole
    plane: some claimed 4-neighbour pair holds two labels across an
    unblocked edge (vertical pairs off the border columns, horizontal pairs
    off the border rows)."""
    cl = out > 0
    hz = (out[:, 1:] != out[:, :-1]) & cl[:, 1:] & cl[:, :-1]
    hz[0] = False
    hz[-1] = False
    return _fine_vertical_violations(out) | hz.any()


def _coarse_violations(c, out):
    """The coarse witness (scan_merge.py:964-974): some neighbour pair
    joined by an edge (the forward reset bit of the later cell clear) holds
    two values."""
    v = (out[1:] != out[:-1]) & ((c[1:] >> _CB_VF) & 1 == 0)
    hz = (out[:, 1:] != out[:, :-1]) & ((c[:, 1:] >> _CB_HF) & 1 == 0)
    return v.any() | hz.any()


def _flag(b):
    return b.to(torch.int32).reshape(1)


def fwd_v_scan(x):
    """The fine pass 1's plane: the forward vertical segmented min scan of
    ``x``, 0 a barrier, border columns kept (uncounted; ``fwd_v_plain``
    and the relax twin's y0 epilogue share it)."""
    zero = x == 0
    y = torch.where(zero, 0, _seg_min_scan(torch.where(zero, _INF, x), zero, 0))
    y[:, 0], y[:, -1] = x[:, 0], x[:, -1]
    return y


def fwd_v_plain(x, *, out=None):
    """Plain twin of the fine pass 1 (scan_merge.py:129-209): the forward
    vertical segmented min scan, 0 a barrier, border columns kept.  Returns
    ``(plane, changed)``, ``changed`` a one-element int32 tensor."""
    _ext.launches["fwd_v_plain"] += 1
    y = fwd_v_scan(x)
    changed = _flag((y != x).any())  # before ``out``, which may be ``x``, is written
    return _into(out, y), changed


def bwd_vh_plain(y, *, out=None, scratch=None):
    """Plain twin of the fine pass 2 (scan_merge.py:212-340): the backward
    vertical scan (border columns kept), the horizontal run-min (border
    rows kept), and the violation flag of the result."""
    _ext.launches["bwd_vh_plain"] += 1
    zero = y == 0
    z = torch.where(zero, 0, _seg_min_scan(torch.where(zero, _INF, y), zero, 0, reverse=True))
    z[:, 0], z[:, -1] = y[:, 0], y[:, -1]
    o = _run_min(z, 1)
    o[0], o[-1] = z[0], z[-1]
    return _into(out, o), _flag(_fine_violations(o))


def cfwd_v_plain(c, *, out=None):
    """Plain twin of the legacy coarse pass 1 (scan_merge.py:836-895): the
    forward vertical scan under the bit-24 resets, reset bits kept."""
    _ext.launches["cfwd_v_plain"] += 1
    x = c & _CVAL
    empty = x == 0
    v = _seg_min_scan(torch.where(empty, _INF, x), ((c >> _CB_VF) & 1).bool(), 0)
    y = torch.where(empty, 0, v)
    return _into(out, (c & ~_CVAL) | y), _flag((y != x).any())


def cbwd_vh_plain(c, h_window=None, *, out=None, scratch=None):
    """Plain twin of the legacy coarse pass 2 (scan_merge.py:898-985): the
    backward vertical scan under bit 25, then the min of a forward (bit 26)
    and a backward (bit 27) h-scan, each windowed to ``h_window`` lanes
    (None: full width), and the violation flag."""
    _ext.launches["cbwd_vh_plain"] += 1
    x = c & _CVAL
    empty = x == 0
    bit = lambda b: ((c >> b) & 1).bool()  # noqa: E731
    z = torch.where(empty, _INF, _seg_min_scan(torch.where(empty, _INF, x), bit(_CB_VB), 0, reverse=True))
    reach = _reach(c.shape[1], h_window)
    hf = _window_min_scan(z, bit(_CB_HF), reach)
    hb = _window_min_scan(z, bit(_CB_HB), reach, reverse=True)
    o = torch.where(empty, 0, torch.minimum(hf, hb))
    return _into(out, (c & ~_CVAL) | o), _flag(_coarse_violations(c, o))


# The fine kernels' launch plans, computed here so that the CPU tests can
# check them; csrc/scan_round.cu refuses a plan that does not fit.
_VSCAN_TILE_ROWS = 128  # kTileRows: 16 warps x 8 rows
_ROW_CAP = 18432  # kRowCap: the widest row the ring row kernel takes
_ROW_CELLS = 20  # kCells: cells a row-kernel thread owns
_ROW_RING = 3  # kRing: row buffers in shared memory
_MIN_BAND = 32  # rows per block at least, so the shadow row costs < ~3%
_COARSE_STEP = 4096  # cells per ring step of the coarse h-pass: about 220 threads a block
_SM_SMEM = 233472  # shared memory of one SM (Hopper: 228 KB) ...
_BLOCK_SMEM = 1024 + 512  # ... of which a block also takes the system's 1 KB and its static arrays
_WIN_THREADS = 480  # kWinThreads: the most threads of the windowed legacy row kernel (6 buffers)
_SM_THREADS = 2048


def vscan_plan(h: int, w: int, vec: bool) -> dict:
    """Tiles of the fine column scan: ``tile_rows`` x ``tile_cols`` (128
    columns with 16-byte access, 32 without), ``n_tiles`` of them, and the
    status buffer's ``status_ints`` (counter, one flag per tile, aggregate
    and inclusive carry per tile and column)."""
    tile_cols = 128 if vec else 32
    n_tiles = -(-h // _VSCAN_TILE_ROWS) * -(-w // tile_cols)
    return {
        "tile_rows": _VSCAN_TILE_ROWS, "tile_cols": tile_cols, "n_tiles": n_tiles,
        "status_ints": 1 + n_tiles + 2 * n_tiles * tile_cols,
    }


def row_plan(h: int, w: int, n_sm: int, coarse: bool = False) -> dict:
    """The row launch of ``bwd_vh`` and, with ``coarse``, of the coarse
    round's h-pass: ``route`` ``"ring"`` (rows of at most ``_ROW_CAP``
    cells) with ``rows_per_step`` whole rows per ring buffer, a block per
    ``band_rows`` rows, ``threads`` per block and ``smem`` bytes of ring; or
    ``"chunked"`` for wider rows.  The fine kernel fills its buffer
    (about one band per SM, at least ``_MIN_BAND`` rows, so that the shadow
    row costs little).  The coarse one has no shadow row: it takes steps of
    about ``_COARSE_STEP`` cells, so that several blocks share an SM, and
    bands that spread over all of them."""
    if w > _ROW_CAP:
        return {"route": "chunked", "rows_per_step": 0, "band_rows": 0, "n_bands": 0, "threads": 0, "smem": 0}
    g = min(h, max(1, _COARSE_STEP // w) if coarse else _ROW_CAP // w)
    owners = -(-(g * w + 3) // _ROW_CELLS)  # a step's cells, up to 3 before its first 16-byte line
    threads = 32 * -(-owners // 32)
    smem = _ROW_RING * threads * _ROW_CELLS * 4
    if coarse:
        per_sm = max(1, min(_SM_SMEM // (smem + _BLOCK_SMEM), _SM_THREADS // threads))
        band = max(-(-h // (n_sm * per_sm)), g)
    else:
        band = max(-(-h // n_sm), _MIN_BAND, g)
    return {
        "route": "ring", "rows_per_step": g, "band_rows": band, "n_bands": -(-h // band),
        "threads": threads, "smem": smem,
    }


# Rows a band of the legacy pass 2's row kernel at least: its shadow row then
# costs at most 1/8 of the rows read (fastest of 4, 8, 16 and 32 at 4096^2 on
# the H100: tools/torch_legacy_plans.py).
_LEGACY_MIN_BAND = 8


@functools.lru_cache(maxsize=256)
def legacy_row_plan(h: int, w: int, n_sm: int, reach: int = -1) -> dict:
    """The row launch of the legacy coarse pass 2 (``cbwd_vh``, h-scans
    reaching ``reach`` cells, -1 for the whole row): ``route`` ``"ring"``
    (rows of at most ``_ROW_CAP`` cells) with the coarse round's steps
    (``rows_per_step`` whole rows, about ``_COARSE_STEP`` cells), ``threads``
    per block, ``smem`` bytes of ring and, windowed (``0 <= reach < w -
    1``), a fourth ring buffer (two steps loaded ahead) and two more
    buffers of its size for the block mins; a block per
    ``band_rows`` rows, spread over the blocks the SMs hold together, but at
    least ``_LEGACY_MIN_BAND`` rows, since each band also computes the row
    above it for the stencil (the shadow row).  ``"chunked"`` for wider
    rows, and for windowed rows of more than ``_WIN_THREADS`` threads' cells
    (9597).  Cached, so read-only."""
    plan = row_plan(h, w, n_sm, coarse=True)
    g, threads = plan["rows_per_step"], plan["threads"]
    win = 0 <= reach < w - 1
    smem = (_ROW_RING + 3 * win) * threads * _ROW_CELLS * 4
    if plan["route"] == "chunked" or (win and threads > _WIN_THREADS):
        return types.MappingProxyType({"route": "chunked", "rows_per_step": 0, "band_rows": 0, "n_bands": 0,
                                       "threads": 0, "smem": 0})
    per_sm = max(1, min(_SM_SMEM // (smem + _BLOCK_SMEM), _SM_THREADS // threads))
    band = max(-(-h // (n_sm * per_sm)), _LEGACY_MIN_BAND, g)
    return types.MappingProxyType({"route": "ring", "rows_per_step": g, "band_rows": band, "n_bands": -(-h // band),
                                   "threads": threads, "smem": smem})


def _vec(w: int, *planes) -> bool:
    return w % 4 == 0 and all(p.data_ptr() % 16 == 0 for p in planes)


def _flag_on(x):
    return torch.empty((1,), dtype=torch.int32, device=x.device)


def _status(h: int, w: int, vec: bool, dev):
    return torch.empty((vscan_plan(h, w, vec)["status_ints"],), dtype=torch.int32, device=dev)


def fwd_v_kernel(x, *, out=None):
    """Launch the fine forward pass of csrc/scan_round.cu (the tiled column
    scan with a decoupled look-back); ``out`` may be ``x`` itself."""
    out = torch.empty_like(x) if out is None else out
    _check_cuda_planes(x, out)
    if x.shape != out.shape:
        raise ValueError("scan round planes must share one shape")
    h, w = x.shape
    vec = _vec(w, x, out)
    flag = _flag_on(x)
    err = _ext.lib().rwt_fine_fwd_v(
        x.data_ptr(), out.data_ptr(), flag.data_ptr(), _status(h, w, vec, x.device).data_ptr(), h, w,
        int(vec), _ext.stream_ptr(x),
    )
    _ext.check(err, "rwt_fine_fwd_v")
    _ext.launches["fwd_v"] += 1
    return out, flag


def bwd_vh_kernel(y, *, out=None, scratch=None):
    """Launch the fine pass 2 of csrc/scan_round.cu: the column scan ``y`` ->
    ``scratch``, then the row run-min with the violation stencil fused
    (``scratch`` -> ``out``, which may be ``y``) on the route ``row_plan``
    picks, counted as ``bwd_vh_ring`` or ``bwd_vh_chunked``."""
    out, scratch = _round_planes(y, out, scratch)
    h, w = y.shape
    vec = _vec(w, y, scratch)
    plan = row_plan(h, w, _ext.sm_count(y.get_device()))
    flag = _flag_on(y)
    err = _ext.lib().rwt_fine_bwd_vh(
        y.data_ptr(), scratch.data_ptr(), out.data_ptr(), flag.data_ptr(),
        _status(h, w, vec, y.device).data_ptr(), h, w, int(vec), plan["rows_per_step"],
        plan["band_rows"], plan["threads"], plan["smem"], _ext.stream_ptr(y),
    )
    _ext.check(err, "rwt_fine_bwd_vh")
    _ext.launches["bwd_vh"] += 1
    _ext.launches[f"bwd_vh_{plan['route']}"] += 1
    return out, flag


def cfwd_v_kernel(c, *, out=None):
    out = torch.empty_like(c) if out is None else out
    _check_cuda_planes(c, out)
    if c.shape != out.shape:
        raise ValueError("scan round planes must share one shape")
    flag = _flag_on(c)
    hc, w = c.shape
    err = _ext.lib().rwt_coarse_fwd_v(c.data_ptr(), out.data_ptr(), flag.data_ptr(), hc, w, _ext.stream_ptr(c))
    _ext.check(err, "rwt_coarse_fwd_v")
    _ext.launches["cfwd_v"] += 1
    return out, flag


def cbwd_vh_kernel(c, h_window=None, *, out=None, scratch=None):
    """Launch the legacy coarse pass 2 of csrc/scan_round.cu: the backward
    column scan ``c`` -> ``scratch``, then the windowed (or full-length)
    h-scans with the violation stencil fused (``scratch`` -> ``out``, which
    may be ``c``) on the route ``legacy_row_plan`` picks, counted as
    ``cbwd_vh_ring`` or ``cbwd_vh_chunked``."""
    out, scratch = _round_planes(c, out, scratch)
    flag = _flag_on(c)
    hc, w = c.shape
    reach = _reach(w, h_window)
    plan = legacy_row_plan(hc, w, _ext.sm_count(c.get_device()), reach)
    err = _ext.lib().rwt_coarse_bwd_vh(
        c.data_ptr(), scratch.data_ptr(), out.data_ptr(), flag.data_ptr(), hc, w, reach, plan["rows_per_step"],
        plan["band_rows"], plan["threads"], plan["smem"], _ext.stream_ptr(c),
    )
    _ext.check(err, "rwt_coarse_bwd_vh")
    _ext.launches["cbwd_vh"] += 1
    _ext.launches[f"cbwd_vh_{plan['route']}"] += 1
    return out, flag


def fwd_v(x, *, out=None):
    """Fine pass 1 over the whole label plane: ``(plane, changed)``."""
    return _dispatch(fwd_v_kernel, fwd_v_plain, x)(x, out=out)


def bwd_vh(y, *, out=None, scratch=None):
    """Fine pass 2 over the whole label plane: ``(plane, violated)``."""
    return _dispatch(bwd_vh_kernel, bwd_vh_plain, y)(y, out=out, scratch=scratch)


def cfwd_v(c, *, out=None):
    """Legacy coarse pass 1: ``(plane, changed)``."""
    return _dispatch(cfwd_v_kernel, cfwd_v_plain, c)(c, out=out)


def cbwd_vh(c, h_window=None, *, out=None, scratch=None):
    """Legacy coarse pass 2, h-scans windowed to ``h_window`` lanes (None:
    full width): ``(plane, violated)``."""
    return _dispatch(cbwd_vh_kernel, cbwd_vh_plain, c)(c, h_window, out=out, scratch=scratch)


# -- the drivers ---------------------------------------------------------------


def _two_pass_rounds(x, fwd, bwd, y0=None):
    """Pass 1, then rounds of pass 2 until one sees no violation, with pass
    1 again after each violated round (scan_merge.py:409-461); one host
    read per round.  ``bwd(y, k, out, scratch)`` runs round ``k``.  ``y0``,
    when given, is pass 1's plane already computed: the rounds start from it
    (and write over it) and pass 1 does not run.  Returns ``(plane,
    rounds)``."""
    y = fwd(x, out=None)[0] if y0 is None else y0
    scratch = torch.empty_like(y)
    rounds = 0
    while True:
        y, viol = bwd(y, rounds, y, scratch)
        rounds += 1
        if not _ext.host_read(viol, "item"):
            return y, rounds
        y, _ = fwd(y, out=y)


def component_min_fine(labels, *, y0=None, y0_valid=None):
    """Component-min labels on the fine scan tail; returns ``(labels,
    rounds)``.  A violation-free pass 2 certifies the fixed point: labels
    only min-propagate inside components, so a state with no differing
    claimed pair across an unblocked edge is the component minimum
    (scan_merge.py:409-421).

    ``y0`` / ``y0_valid``: pass 1's plane from the relax kernel's y0
    epilogue (``ops.relax.relax_packed_planes(fwd_scan=True)``), the
    counterpart of ``component_min_from_padded(y0=, y0_valid=)``
    (scan_merge.py:464-550).  When ``y0_valid`` is true, ``y0`` is
    ``fwd_v`` of ``labels``: the rounds start from it, write over it, and
    ``fwd_v`` does not run; otherwise it runs here as usual.  The labels and
    the rounds are the same either way."""
    lab = labels.to(torch.int32).contiguous()
    if y0 is not None and y0_valid:
        if y0.shape != lab.shape or y0.dtype != torch.int32 or y0.device != lab.device or not y0.is_contiguous():
            raise ValueError("y0 must be a contiguous int32 plane of the labels' shape and device")
    else:
        y0 = None
    return _two_pass_rounds(
        lab, fwd_v, lambda y, k, out, scratch: bwd_vh(y, out=out, scratch=scratch), y0
    )


def _legacy_window(k: int):
    """Round ``k``'s h-window: full width on rounds 0, 1 and every 4th from
    3 (scan_merge.py:1410-1421), else ``_COARSE_HWIN``."""
    return None if k < 2 or k % 4 == 3 else _COARSE_HWIN


def _coarse_gate(w: int, n_labels: int) -> bool:
    """Whether the coarse engine serves the plane: labels (1..n_labels)
    below 2**24, the packed value width, and ``w >= 3`` (narrower planes
    have no coarse system)."""
    return n_labels < 1 << 24 and w >= 3


# Coarse rounds the tail queues a block (module constant; the fastest of
# 1..8, or within 0.6% of it, in three sweeps on the H100, PERF.md).
_TAIL_BLOCK = 4


def _coarse_rounds(c) -> int:
    """The coarse round in place on ``c`` until one changes no cell; returns
    the rounds, that quiet round included.

    The rounds are queued in blocks of ``k = _TAIL_BLOCK``, each writing
    its change count into a word of one small array and taking the word of
    the round before it as its ``go`` (the first round none), so once a
    round is quiet the rounds after it stop on the device.  Block ``b + 1``
    is queued before block ``b``'s words are read (copied into pinned host
    memory and read after an event: one host read a block), so the card
    always has a block queued while the host reads.  The loop ends at the
    first block that holds a quiet round; the block queued after it stops
    wholly, so ``k`` to ``2k - 1`` rounds stop a call.  Labels and
    ``rounds`` are those of a loop that reads every round's count.  The
    rounds go through one launcher (``_round_launcher`` on the card), so
    that the host queues a round in a few microseconds; each launch is
    counted as it is queued, and the rounds that ran and those that stopped
    once their block is read."""
    cuda, k = c.is_cuda, _TAIL_BLOCK
    # Words 0..k-1 and k..2k-1: the change counts of even and odd blocks.
    words = torch.empty((2 * k,), dtype=torch.int32, device=c.device)
    host = torch.empty((2, k), dtype=torch.int32, pin_memory=cuda)
    launch = _dispatch(_round_launcher, _plain_round_launcher, c)(c, c, torch.empty_like(c), words)
    go = None

    def queue(b: int):
        nonlocal go
        first = (b % 2) * k
        for i in range(first, first + k):
            launch(i, go)
            go = i
        h = host[b % 2]
        h.copy_(words[first : first + k], non_blocking=cuda)
        if not cuda:
            return h, None
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(c.device))
        return h, done

    rounds, block = 0, queue(0)
    for b in itertools.count():
        queued = queue(b + 1)
        counts = _ext.host_read(block[0], after=block[1])
        quiet = 0 in counts
        ran = counts.index(0) + 1 if quiet else k
        rounds += ran
        launch.settle(ran, 2 * k - ran if quiet else 0)
        if quiet:
            return rounds
        block = queued


def component_min_coarse(labels, n_labels: int):
    """Component-min labels on the coarse engine; returns ``(labels,
    rounds)``.

    ``n_labels`` bounds the labels (1..n_labels); the coarse gate must hold
    (``component_min_labels`` checks it and runs the fine tail when it
    fails).  Rounds: ``coarse_round`` until one changes no cell (``rounds``
    counts that quiet round; ``_coarse_rounds``: one host read a block of
    rounds), or with ``RWT_COARSE_MULTI=0`` the legacy two-pass rounds
    until a pass 2 sees no violation (one host read a round).
    """
    _check_width(labels.shape[1])
    if n_labels >= 1 << 24:
        raise ValueError(f"the coarse engine needs labels below 2**24 (got a bound of {n_labels})")
    c = coarsen(labels)
    if not _COARSE_MULTI:
        c, rounds = _two_pass_rounds(
            c, cfwd_v,
            lambda y, k, out, scratch: cbwd_vh(y, _legacy_window(k), out=out, scratch=scratch),
        )
        return coarse_broadcast(c, labels), rounds
    rounds = _coarse_rounds(c)
    return coarse_broadcast(c, labels), rounds


@spanned("rwt.tail")
def component_min_labels(labels, *, max_label=None, y0=None, y0_valid=None):
    """Every 4-connected component of nonzero labels (blocked border-border
    edges excluded) replaced by its minimum label, on the card's engines
    (scan_merge.py:573-610): the coarse engine when ``max_label`` bounds
    the labels below 2**24 and ``w >= 3``, else the fine tail.  ``y0`` /
    ``y0_valid`` go to the fine tail (``component_min_fine``); the coarse
    engine takes no y0 (scan_merge.py:1268-1281).  Returns ``(labels,
    rounds)``."""
    if max_label is None or not _coarse_gate(labels.shape[1], max_label):
        return component_min_fine(labels, y0=y0, y0_valid=y0_valid)
    return component_min_coarse(labels, max_label)
