"""The transform driver: the relaxation engines and the level sweep.

Counterpart of ``rustronomy_watershed_tpu.ops.level_driver.run_levels_impl``.
Four engines, bit-identical labels:

* ``backend='packed'`` — the packed-key engine (ops/pack.py + ops/relax.py)
  and, for merging, the coarse component-min engine, or the fine scan tail
  when the labels reach 2**24 or w < 3 (ops/scan_merge.py): the CUDA
  kernels on a CUDA device, their plain twins on the CPU.  The
  counterpart of the JAX ``'relax_pallas'`` backend.
* ``backend='relax'`` — the exact unpacked engine (ops/priority.py) and,
  for merging, the component-min oracle.
* ``backend='flood'`` — the level sweep on the flood kernel
  (ops/flood_block.py: csrc/flood.cu on a CUDA device, its twin on the CPU),
  the JAX ``'pallas'`` backend.
* ``backend='sweep'`` — the level sweep on plain ``flood_sweep`` (or the
  caller's ``sweep_fn``) on any device, the JAX ``'jnp'`` backend.

The relaxation engines run the whole 254-level transform as ONE priority
relaxation fixed point.  Merging = segmenting labels, then every
4-connected component of the claimed set takes its minimum label.  At full
depth the relax calls also reduce the single-component statistics; the
driver takes them from the certifying call, whose planes are the fixed
point, in the same flag read.  When no interior cell is unclaimed and no
border cell is claimed, the claimed set is the interior rectangle, one
component, and the labels are a broadcast of its least label (the
shortcut).  Otherwise the component-min tail runs, coarse or fine.  The
JAX driver trusts only the first relax call's statistics, which on this
card's schedule never certifies; the schedule differs, the labels do not.

The level sweeps step the reference's per-level loop (reference
src/lib.rs:1379-1521) from the host: per level the flood fixed point, then
for merging the merge phase (ops/merge.py) when the level painted a pixel
(or at level 0, where painted seeds may already touch).  A level L > 0 at
which no pixel has value L is skipped (level_driver.py:87-90).  They alone
serve per-level MERGED statistics, so merging with ``collect`` on a
relaxation engine runs the level sweep of the same tier (level_driver.py:
197-213): ``'packed'`` -> ``'flood'``, ``'relax'`` -> ``'sweep'``.
"""

from __future__ import annotations

import torch

from .. import _ext
from ..constants import _INF, UNCOLOURED
from .flood import flood_fixed_point, flood_sweep
from .flood_block import DEFAULT_STEPS as FLOOD_STEPS
from .flood_block import flood_fixed_point_block, flood_image, flood_tiles
from .histogram import lake_sizes, value_histogram
from .merge import merge_touching
from .priority import relax_transform, sizes_from_levels
from .relax import _key_consts, relax_packed_planes, relax_transform_packed
from .scan_merge import component_min_labels, component_min_labels_plain
from .seeds import local_extrema_mask, seed_labels_from_mask


def level_step(img, labels, lvl, *, merging: bool, n_labels: int, sweep_fn=None):
    """One water level: the flood fixed point, then for merging the merge
    phase when the level painted a pixel or is level 0."""
    labels, painted = flood_fixed_point(img, labels, lvl, sweep_fn=sweep_fn)
    if merging and (painted or lvl == 0):
        labels = merge_touching(labels, n_labels)
    return labels


def level_step_counted(img, labels, lvl, *, merging: bool, n_labels: int, sweep_fn=None):
    """level_step that also returns the level's sweep count (the
    reference's PerfReport 'loops', src/lib.rs:1400-1402); merges
    unconditionally, like the JAX function."""
    sweep = sweep_fn or flood_sweep
    loops = 0
    while True:
        new = sweep(img, labels, lvl)
        loops += 1
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break
    if merging:
        labels = merge_touching(labels, n_labels)
    return labels, loops


def _collect_loop(step, labels0, *, levels: int, vhist, collect: str, n_labels):
    """Run ``step(labels, lvl)`` per level, skipping levels L > 0 with no
    pixel of value L, and collect the per-level statistics: nothing, the
    ``(levels, n_labels + 1)`` int32 lake sizes or the ``(levels, h, w)``
    int32 label snapshots."""
    if collect not in ("none", "sizes", "history"):
        raise ValueError(f"unknown collect mode {collect!r}")
    if collect != "none" and n_labels is None:
        raise ValueError("collect needs n_labels, the largest label")
    dev = labels0.device
    if collect == "sizes":
        out = torch.empty((levels, n_labels + 1), dtype=torch.int32, device=dev)
    elif collect == "history":
        out = torch.empty((levels,) + tuple(labels0.shape), dtype=torch.int32, device=dev)
    vhist = vhist.tolist()
    lab = labels0
    for lvl in range(levels):
        if lvl == 0 or vhist[lvl] > 0:
            lab = step(lab, lvl)
        if collect == "sizes":
            out[lvl] = lake_sizes(lab, n_labels)
        elif collect == "history":
            out[lvl] = lab
    return lab if collect == "none" else (lab, out)


def _flood_step(img, labels0, *, merging: bool, n_labels, steps):
    """``(step, labels0)`` of the flood-kernel level sweep: the step runs
    flood_fixed_point_block over a pair of ping-pong planes, on the card
    with one tile state for the whole sweep (quiet tiles skipped, levels'
    first calls run where a pixel of the level lies).  Skipped tiles write
    nothing, so the two planes start equal, and after a merge relabels
    one plane one device copy brings the other in sync (8 B a cell once a
    merged level; marking every tile to run instead would cost a whole
    call of sweeps)."""
    img_eff = flood_image(img)
    steps = FLOOD_STEPS if steps is None else int(steps)
    lab0 = labels0.clone(memory_format=torch.contiguous_format)
    scratch = lab0.clone()
    tiles = flood_tiles(img_eff, steps) if lab0.is_cuda else None

    def step(lab, lvl):
        nonlocal scratch
        lab, scratch, painted = flood_fixed_point_block(img_eff, lab, lvl, steps=steps, scratch=scratch, tiles=tiles)
        if merging and (painted or lvl == 0):
            lab = merge_touching(lab, n_labels)
            scratch.copy_(lab)
        return lab

    return step, lab0


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


def _merge_full_depth(img, labels0, *, n_labels, steps, device, batch, batch_mins, checkpoint):
    """Merging at max_water_level >= 254 on the packed engine: relax with
    statistics, then the shortcut or the component-min tail.  Returns
    ``(labels, starved)``."""
    _, lab, starved, (n_uncl, any_border, gmin) = relax_packed_planes(
        img, labels0, steps=steps, device=device, stats=True, checkpoint=checkpoint
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
    return component_min_labels(lab, max_label=n_labels)[0], starved


def relax_claims(img, labels0, *, backend, max_water_level, steps=None, device="cuda", checkpoint=None,
                 claims: bool = True):
    """The segmenting transform on a relaxation engine: ``(labels, claim
    levels, starved)``.  ``'packed'`` is the packed-key engine
    (ops/relax.py), whose claim levels are the key's high bits, formed only
    with ``claims=True`` (None otherwise); ``'relax'`` the exact engine
    (ops/priority.py), never starved.  ``starved`` (a host bool) is the
    packed engine's d-field saturation flag: the planes are unreliable when
    it is set, and the caller re-runs on ``'relax'``."""
    dev = _ext.resolve_device(device)
    if backend == "packed":
        labels, key, starved = relax_transform_packed(
            img, labels0, max_water_level=max_water_level, steps=steps, device=dev, checkpoint=checkpoint
        )
        return labels, (key >> _key_consts(None)[0] if claims else None), starved
    if backend == "relax":
        labels, claim = relax_transform(
            torch.as_tensor(img).to(dev), torch.as_tensor(labels0).to(dev), max_water_level=max_water_level
        )
        return labels, claim, False
    raise ValueError(f"unknown backend {backend!r} (packed or relax)")


def _relax_collect(img, labels0, *, backend, max_water_level, n_labels, collect, steps, dev, checkpoint=None):
    """The segmenting transform on a relaxation engine, with the per-level
    statistics rebuilt from its claim levels: ``(labels, starved)`` or
    ``((labels, stack), starved)``."""
    labels, claim_levels, starved = relax_claims(
        img, labels0, backend=backend, max_water_level=max_water_level, steps=steps, device=dev,
        checkpoint=checkpoint, claims=collect != "none",
    )
    if collect == "none":
        return labels, starved
    if n_labels is None:
        raise ValueError("collect needs n_labels, the largest label")
    levels = max_water_level + 1
    if collect == "sizes":
        return (labels, sizes_from_levels(labels, claim_levels, n_labels, max_water_level)), starved
    if collect == "history":
        lvls = torch.arange(levels, dtype=torch.int32, device=labels.device)[:, None, None]
        return (labels, torch.where(claim_levels[None] <= lvls, labels[None], 0)), starved
    raise ValueError(f"unknown collect mode {collect!r}")


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
    sweep_fn=None,
    with_flags: bool = False,
    batch: tuple | None = None,
    batch_mins=None,
    device="cuda",
    checkpoint=None,
):
    """Run the full transform; returns the ``(h, w)`` int32 label tensor, or
    ``(labels, stack)`` with ``collect='sizes'`` (``(levels, n_labels + 1)``
    int32 lake sizes) or ``collect='history'`` (``(levels, h, w)`` int32
    snapshots), with ``with_flags=True`` followed by ``starved``.

    ``labels0=None`` takes the seeds from the image (through the pack kernel
    on ``'packed'``).  ``n_labels`` bounds the labels, 1..n_labels: merging
    and the collects need it, and the coarse tail's gate reads it (labels
    of 2**24 or more take the fine tail).
    ``steps`` is the sweeps per kernel call of ``'packed'`` or ``'flood'``;
    ``sweep_fn`` replaces ``flood_sweep`` on ``'sweep'`` (the flood kernel
    ignores it, as the JAX ``'pallas'`` backend does).  ``batch=(b, hs,
    h_img)`` with ``batch_mins`` (merging, packed, full depth) declares a
    vertically stacked batch of ``b`` images at a stride of ``hs`` rows with
    no seed on any image border, and enables the per-image broadcast
    shortcut; the minima are each image's least surviving seed label.
    ``starved`` is True iff the packed engine's d field saturated (the
    caller should re-run on ``'relax'``); always False for the others.
    ``checkpoint`` (``'packed'``, ``collect='none'``; ops/ckpt_relax.py)
    snapshots the relax planes and resumes from them.
    """
    if checkpoint is not None and (backend != "packed" or collect != "none"):
        raise ValueError("checkpoint needs backend='packed' and collect='none'")
    if merging and n_labels is None:
        raise ValueError("merging needs n_labels, the largest label")
    if labels0 is None and backend != "packed":
        raise ValueError("labels0=None requires backend='packed'")
    dev = _ext.resolve_device(device)
    if backend in ("packed", "relax") and merging and collect != "none":
        # Per-level merged statistics need the per-level unions, which the
        # one-shot relaxation cannot give: run the level sweep of the same
        # tier instead (relax tuning does not apply to it).  Seeds from the
        # image are numbered here as the pack kernel would number them.
        if labels0 is None:
            img = torch.as_tensor(img).to(dev)
            labels0 = seed_labels_from_mask(local_extrema_mask(img))
        backend, steps = ("flood" if backend == "packed" else "sweep"), None
    if backend == "packed":
        if merging and max_water_level >= 254:
            res, starved = _merge_full_depth(
                img, labels0, n_labels=n_labels, steps=steps, device=dev,
                batch=batch, batch_mins=batch_mins, checkpoint=checkpoint,
            )
        else:
            res, starved = _relax_collect(
                img, labels0, backend="packed", max_water_level=max_water_level,
                n_labels=n_labels, collect=collect, steps=steps, dev=dev, checkpoint=checkpoint,
            )
            if merging:
                _ext.launches["merge_tail"] += 1
                res = component_min_labels(res, max_label=n_labels)[0]
    elif backend == "relax":
        res, starved = _relax_collect(
            img, labels0, backend="relax", max_water_level=max_water_level,
            n_labels=n_labels, collect=collect, steps=None, dev=dev,
        )
        if merging:
            res = component_min_labels_plain(res)
    elif backend in ("flood", "sweep"):
        img = torch.as_tensor(img).to(dev)
        labels0 = torch.as_tensor(labels0).to(dev).to(torch.int32)
        if backend == "flood":
            step, labels0 = _flood_step(img, labels0, merging=merging, n_labels=n_labels, steps=steps)
        else:
            def step(lab, lvl):
                return level_step(img, lab, lvl, merging=merging, n_labels=n_labels, sweep_fn=sweep_fn)

        res = _collect_loop(
            step, labels0, levels=max_water_level + 1, vhist=value_histogram(img),
            collect=collect, n_labels=n_labels,
        )
        starved = False
    else:
        raise ValueError(f"unknown backend {backend!r} (packed, relax, flood or sweep)")
    if not with_flags:
        return res
    return (*res, starved) if isinstance(res, tuple) else (res, starved)
