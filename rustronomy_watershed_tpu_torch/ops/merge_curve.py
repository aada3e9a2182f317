"""Per-level statistics from ONE relaxation pass: the compact-plane curves.

Counterpart of ``rustronomy_watershed_tpu.ops.merge_curve``.  The
reference's main merging entry point is ``transform_to_list`` (reference
src/lib.rs:1551-1561): per water level, the lake-size histogram of the
merged label image.  Instead of replaying the flood level by level, the
curves come from the relaxation engine's ``(label, claim level)`` planes:

* two regions with segmenting labels a != b first merge at water level
  ``max(L(p), L(q))`` minimised over 4-adjacent claimed pixel pairs (p, q)
  labelled (a, b); pairs of two border pixels never merge (3x3 windows are
  centred on interior pixels only), so horizontal pairs in rows 0 and h-1
  and vertical pairs in columns 0 and w-1 are left out;
* the merged labelling at a level is the union of the edges active at or
  below it (least label represents its set, SURVEY.md Q9), and the merged
  histogram redistributes the segmenting per-level counts onto the
  representatives.

The device runs the relaxation, the edge extraction and its deduplication;
the int32 label plane and the u8 claim-level plane then move to the host in
one copy, and the host rebuilds the per-level tables (the Kruskal tail): the
curves in one native C++ pass (parity/native.py; the NumPy pair
``merged_curve_plain`` is its twin for the tests), the histories in NumPy.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _ext
from ..parity.native import native_merged_curve
from .priority import relax_transform
from .relax import _key_consts, relax_transform_packed
from .scan_merge import component_min_labels, component_min_labels_plain


def merge_edges(seg_labels, claim_levels, *, max_water_level: int):
    """Deduplicated label-adjacency edges with their least activation level.

    Returns ``(lo, hi, act, n)``: int32 tensors of length ``n``, sorted by
    ``(lo, hi)`` with unique pairs and ``act`` the least level at which the
    pair touches.  These are the first ``n`` slots of the JAX function's
    arrays, in the same order."""
    s = torch.as_tensor(seg_labels).to(torch.int32)
    L = torch.as_tensor(claim_levels).to(s.device, torch.int32)
    h, w = s.shape
    rows = torch.arange(h, device=s.device)[:, None]
    cols = torch.arange(w, device=s.device)[None, :]
    parts = (
        # Horizontal pairs (p, p + x), blocked in rows 0 and h-1.
        (s[:, :-1], s[:, 1:], L[:, :-1], L[:, 1:], ((rows == 0) | (rows == h - 1)).expand(h, w - 1)),
        # Vertical pairs (p, p + y), blocked in columns 0 and w-1.
        (s[:-1, :], s[1:, :], L[:-1, :], L[1:, :], ((cols == 0) | (cols == w - 1)).expand(h - 1, w)),
    )
    keys, acts = [], []
    for a, b, la, lb, blocked in parts:
        act = torch.maximum(la, lb)
        valid = (a > 0) & (b > 0) & (a != b) & ~blocked & (act <= max_water_level)
        lo = torch.minimum(a, b)[valid].to(torch.int64)
        hi = torch.maximum(a, b)[valid].to(torch.int64)
        keys.append((lo << 31) | hi)  # labels < 2**31: one sortable int64
        acts.append(act[valid])
    key, act = torch.cat(keys), torch.cat(acts)
    uniq, inv = torch.unique(key, sorted=True, return_inverse=True)
    least = torch.full(uniq.shape, 2**30, dtype=torch.int32, device=s.device)
    least.scatter_reduce_(0, inv, act, "amin")
    lo = (uniq >> 31).to(torch.int32)
    hi = (uniq & (2**31 - 1)).to(torch.int32)
    return lo, hi, least, int(uniq.numel())


def _device_curves(
    img, labels0, *, n_labels: int, max_water_level: int, backend: str = "packed",
    steps=None, with_final: bool = True, with_edges: bool = True, device="cuda",
):
    """The device half: relaxation, edges, the optional merged plane, and
    the compact planes.  Returns ``(final, labels, lv8, (lo, hi, act),
    starved)``: ``labels`` the segmenting plane (int32), ``lv8`` its claim
    levels clipped to ``max_water_level + 1`` (never claimed) as uint8, and
    ``final`` the component-min plane (``labels`` itself with
    ``with_final=False``).  ``starved`` (a host bool) is the packed engine's
    d-field saturation flag; the planes are unreliable when it is set."""
    dev = _ext.resolve_device(device)
    if backend == "packed":
        labels, key, starved = relax_transform_packed(
            img, labels0, max_water_level=max_water_level, steps=steps, device=dev
        )
        claim = key >> _key_consts(None)[0]
    elif backend == "relax":
        labels, claim = relax_transform(
            torch.as_tensor(img).to(dev), torch.as_tensor(labels0).to(dev),
            max_water_level=max_water_level,
        )
        starved = False
    else:
        raise ValueError(f"unknown backend {backend!r} (packed or relax)")
    if with_edges:
        lo, hi, act, _ = merge_edges(labels, claim, max_water_level=max_water_level)
    else:
        lo = hi = act = torch.zeros((0,), dtype=torch.int32, device=dev)
    final = labels
    if with_final:
        if backend == "packed":
            final = component_min_labels(labels, max_label=n_labels)[0]
        else:
            final = component_min_labels_plain(labels)
    lv8 = claim.clamp(0, max_water_level + 1).to(torch.uint8)
    return final, labels, lv8, (lo, hi, act), starved


def _fetch_planes(labels, lv8, edges):
    """``(labels, lv8, lo, hi, act)`` as host numpy arrays, moved in ONE
    device-to-host copy of their bytes."""
    parts = [labels.reshape(-1), lv8.reshape(-1), *edges]
    raw = torch.cat([p.contiguous().view(torch.uint8) for p in parts]).cpu().numpy()
    out, at = [], 0
    for p in parts:
        n = p.numel() * p.element_size()
        out.append(raw[at : at + n].view(np.dtype(str(p.dtype).replace("torch.", ""))))
        at += n
    labels_np, lv8_np, lo, hi, act = out
    return labels_np.reshape(labels.shape), lv8_np.reshape(lv8.shape), lo, hi, act


def host_cumulative_counts(labels, lv8, n_labels: int, max_water_level: int) -> np.ndarray:
    """Host twin of ops.priority.sizes_from_levels: ``(levels, K+1)`` int64
    cumulative segmenting counts from the two compact planes."""
    levels = max_water_level + 1
    k1 = n_labels + 1
    # An int32 flat index is cheaper to form; int64 when it would overflow.
    dt = np.int32 if (levels + 1) * k1 < 2**31 else np.int64
    lv = np.asarray(lv8).astype(dt).reshape(-1)
    lab = np.asarray(labels, dtype=dt).reshape(-1)
    counts = np.bincount(lv * dt(k1) + lab, minlength=(levels + 1) * k1)
    counts = counts[: (levels + 1) * k1].reshape(levels + 1, k1)
    # A row loop, not np.cumsum(axis=0): the strided cumsum is far slower on
    # a (255, K+1) table.
    cum = np.empty((levels, k1), dtype=np.int64)
    running = np.zeros(k1, dtype=np.int64)
    for lvl in range(levels):
        running += counts[lvl]
        cum[lvl] = running
    cum[:, 0] = lab.size - cum[:, 1:].sum(axis=1)
    return cum


def _level_edge_buckets(levels: int, lo, hi, act):
    """Edges sorted by activation level, and each level's start offset."""
    order = np.argsort(act, kind="stable")
    lo, hi, act = lo[order], hi[order], act[order]
    starts = np.searchsorted(act, np.arange(levels + 1))
    return lo, hi, starts


def _union_level(parent: np.ndarray, el: np.ndarray, eh: np.ndarray):
    """Union one level's edges into the compressed ``parent`` (least label
    represents its set), on a mini graph over the roots the edges touch;
    returns the compressed parent (one full-table gather)."""
    ra, rb = parent[el], parent[eh]
    nodes, inv = np.unique(np.concatenate([ra, rb]), return_inverse=True)
    ia, ib = inv[: el.size], inv[el.size :]
    rep = np.arange(nodes.size, dtype=np.int64)
    while True:
        m = np.minimum(rep[ia], rep[ib])
        np.minimum.at(rep, ia, m)
        np.minimum.at(rep, ib, m)
        r2 = rep[rep]
        while not np.array_equal(r2, rep):
            rep = r2
            r2 = rep[rep]
        rep = r2
        if (rep[ia] == rep[ib]).all():
            break
    parent[nodes] = nodes[rep]
    return parent[parent]


def merged_sizes_host(cum: np.ndarray, lo: np.ndarray, hi: np.ndarray, act: np.ndarray) -> np.ndarray:
    """``(levels, K+1)`` merged per-level lake sizes from the cumulative
    segmenting counts: per level, union the edges that activate there, then
    redistribute that level's counts onto the representatives."""
    levels, k1 = cum.shape
    parent = np.arange(k1, dtype=np.int64)
    lo, hi, starts = _level_edge_buckets(levels, lo, hi, act)
    out = np.zeros_like(cum)
    for lvl in range(levels):
        el, eh = lo[starts[lvl] : starts[lvl + 1]], hi[starts[lvl] : starts[lvl + 1]]
        if el.size:
            parent = _union_level(parent, el, eh)
        out[lvl] = np.bincount(parent, weights=cum[lvl], minlength=k1).astype(cum.dtype)
    return out


def merged_curve_host(
    labels_np, lv8_np, n_labels: int, max_water_level: int, lo, hi, act,
    out_width: int | None = None,
) -> np.ndarray:
    """``(levels, out_width or K+1)`` merged sizes from the compact planes:
    the native C++ pass (parity/native.py), as the JAX package's tail runs.
    Columns beyond K+1 are zeros; representatives at or above
    ``out_width`` are cut."""
    return native_merged_curve(labels_np, lv8_np, n_labels, max_water_level, lo, hi, act, out_width=out_width)


def merged_curve_plain(
    labels_np, lv8_np, n_labels: int, max_water_level: int, lo, hi, act,
    out_width: int | None = None,
) -> np.ndarray:
    """The NumPy twin of merged_curve_host (host_cumulative_counts, then
    merged_sizes_host), which the tests hold the native pass against."""
    cum = host_cumulative_counts(labels_np, lv8_np, n_labels, max_water_level)
    sizes = merged_sizes_host(cum, np.asarray(lo), np.asarray(hi), np.asarray(act))
    if out_width is None or out_width == sizes.shape[1]:
        return sizes
    out = np.zeros((sizes.shape[0], out_width), dtype=sizes.dtype)
    k = min(sizes.shape[1], out_width)
    out[:, :k] = sizes[:, :k]
    return out


def relax_merging_sizes(
    img, labels0, *, n_labels: int, max_water_level: int, backend: str = "packed",
    steps=None, with_final: bool = True, out_width: int | None = None,
    merging: bool = True, device="cuda",
):
    """``transform_to_list`` data from one relaxation pass, both variants.

    Returns ``(final, sizes, starved)``: the merged label plane (the
    segmenting plane with ``with_final=False`` or ``merging=False``), the
    ``(levels, out_width or K+1)`` int64 per-level sizes (None when
    ``starved``: the caller re-runs on ``'relax'``), and the saturation
    flag.  ``merging=False`` gives the segmenting curves: the cumulative
    claim counts, with no edges."""
    final, labels, lv8, edges, starved = _device_curves(
        img, labels0, n_labels=n_labels, max_water_level=max_water_level,
        backend=backend, steps=steps, with_final=with_final and merging,
        with_edges=merging, device=device,
    )
    if starved:
        return final, None, True
    labels_np, lv8_np, lo, hi, act = _fetch_planes(labels, lv8, edges)
    sizes = merged_curve_host(
        labels_np, lv8_np, n_labels, max_water_level, lo, hi, act, out_width=out_width
    )
    return final, sizes, False


def iter_history_from_planes(
    labels_np, lv8_np, max_water_level: int, lo=None, hi=None, act=None, *,
    n_labels: int | None = None,
):
    """Yield ``(level, int32 snapshot)`` rebuilt from the compact planes:
    ``where(claim <= level, rep_level[label], 0)``, the snapshot the level
    sweep records (segmenting labels never change once claimed; the merging
    labelling at a level is the union of the edges active at or below it).
    Pass ``lo/hi/act`` for merging, none for segmenting.  A generator, so
    per-level observers hold one snapshot at a time."""
    labels_np = np.asarray(labels_np).astype(np.int32, copy=False)
    lv8_np = np.asarray(lv8_np)
    levels = max_water_level + 1
    if lo is None:
        for lvl in range(levels):
            yield lvl, np.where(lv8_np <= lvl, labels_np, np.int32(0))
        return
    k1 = int(n_labels) + 1 if n_labels is not None else int(labels_np.max()) + 1
    parent = np.arange(k1, dtype=np.int64)
    lo, hi, starts = _level_edge_buckets(levels, np.asarray(lo), np.asarray(hi), np.asarray(act))
    rep_plane = labels_np  # the identity until the first union
    for lvl in range(levels):
        el, eh = lo[starts[lvl] : starts[lvl + 1]], hi[starts[lvl] : starts[lvl + 1]]
        if el.size:
            parent = _union_level(parent, el, eh)
            rep_plane = parent[labels_np].astype(np.int32)
        yield lvl, np.where(lv8_np <= lvl, rep_plane, np.int32(0))


def history_from_planes(labels_np, lv8_np, max_water_level, lo=None, hi=None, act=None, *, n_labels=None) -> list:
    """List form of iter_history_from_planes."""
    return list(iter_history_from_planes(labels_np, lv8_np, max_water_level, lo, hi, act, n_labels=n_labels))


def relax_history(
    img, labels0, *, n_labels: int, max_water_level: int, backend: str = "packed",
    steps=None, merging: bool = True, as_iter: bool = False, device="cuda",
):
    """``transform_history`` data from one relaxation pass and a host
    rebuild.  Returns ``(snapshots, starved)``: the list of ``(level,
    snapshot)`` (a lazy generator with ``as_iter=True``), None when
    ``starved``."""
    _, labels, lv8, edges, starved = _device_curves(
        img, labels0, n_labels=n_labels, max_water_level=max_water_level,
        backend=backend, steps=steps, with_final=False, with_edges=merging, device=device,
    )
    if starved:
        return None, True
    labels_np, lv8_np, lo, hi, act = _fetch_planes(labels, lv8, edges)
    make = iter_history_from_planes if as_iter else history_from_planes
    if merging:
        return make(labels_np, lv8_np, max_water_level, lo, hi, act, n_labels=n_labels), False
    return make(labels_np, lv8_np, max_water_level), False
