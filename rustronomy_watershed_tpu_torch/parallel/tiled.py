"""The watershed tiled over a ``torch.distributed`` device mesh.

Counterpart of ``rustronomy_watershed_tpu.parallel.tiled``.  Three engines:

* ``backend='packed'`` (JAX's ``'relax_pallas'``): the tiled packed relax
  engine (``_local_relax_packed_driver``), one relax fixed point over the
  mesh on the relax kernel for the whole transform; final labels (the
  merging variant adds the mesh merge ``_merge_fixed_point``), and for
  segmenting the per-level statistics from the claim levels
  (``collect='sizes'`` / ``'history'``) or the raw ``(labels, claim
  levels)`` planes (``collect='claims'``, the builder's per-level API);
* ``backend='relax'``: JAX's jnp tiled relax engine
  (``_local_relax_driver``), the same fixed point on unpacked ``(L, d,
  label)`` int32 planes swept by plain torch ops (``ops.priority.
  relax_sweep``; no kernel, as JAX's runs no Pallas), with the same
  collects; its d field cannot saturate;
* ``backend='sweep'``: the per-level flood loop on the flood kernel
  (``_local_level_driver``), which alone gives the merging variant's
  per-level statistics.  ``MeshLevelStepper`` steps the same levels from
  the host for the builder's hooks, plots, progress, debug and
  checkpoints.

SPMD.  JAX runs one controller over every device; here every rank is a
process that calls ``tiled_transform`` with the same full image and seeds.
Each rank pads the image to a mesh-divisible domain (``_mesh_pad``), takes
its own tile (row-major over the mesh's ``("y", "x")`` dims), runs it on
its device with k-px halos exchanged between neighbour ranks
(parallel/halo.py), merges over the mesh for the merging variant, and gets
the full cropped result back by an all-gather.  No rank is a driver; the
result equals the single-device result on every rank.  A leading
``"batch"`` dim (``axis_batch``) splits a ``(B, H, W)`` stack over its
batch groups, each a ``(y, x)`` sub-mesh that walks its own images one
after another; the stack comes back by an all-gather over ``"batch"``.

Collectives: the halo strips go point to point on the ``"y"`` / ``"x"``
groups; a reduction over the mesh is one all-reduce on the ``"y"`` group
and one on the ``"x"`` group (so over this rank's ``(y, x)`` sub-mesh).
Where a group's backend is gloo and the tensors lie on the card, they go
through host memory (``halo.staged``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from ..constants import INT32_MAX, NEVER_FILL, NORMAL_MAX, UNCOLOURED
from ..ops import flood_block, priority, relax
from ..ops.histogram import value_histogram
from ..ops.level_driver import _collect_loop
from ..ops.merge import _pointer_jump
from .halo import exchange_halo, global_interior_mask, mesh_layout, mesh_line, refresh_halo_padded, staged

_BIG = INT32_MAX
_BIG_L = NEVER_FILL + 1  # the claim level of a cell no seed claimed
COLLECTS = ("none", "claims", "sizes", "history")


def _mesh_all_reduce(t: torch.Tensor, op, mesh) -> torch.Tensor:
    """``t`` reduced with ``op`` over every rank of the mesh (over ``"y"``,
    then over ``"x"``), on ``t``'s device.  Reduces a copy where it stages
    through the host, ``t`` itself otherwise."""
    out = t
    for dim in ("y", "x"):
        group = mesh.get_group(dim)
        wire = out.cpu() if staged(group, out) else out
        dist.all_reduce(wire, op=op, group=group)
        out = wire
    return out.to(t.device)


def _dim_all_gather(t: torch.Tensor, mesh, dim: str, axis: int) -> torch.Tensor:
    """Every rank's ``t`` along the mesh line ``dim``, concatenated on
    ``axis`` in the line's coordinate order."""
    group = mesh.get_group(dim)
    wire = (t.cpu() if staged(group, t) else t).contiguous()
    parts = [torch.empty_like(wire) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, wire, group=group)
    order = dist.get_process_group_ranks(group)
    line, _ = mesh_line(mesh, dim)
    return torch.cat([parts[order.index(r)] for r in line], dim=axis).to(t.device)


def _mesh_all_gather(tile: torch.Tensor, mesh) -> torch.Tensor:
    """The ``(..., ny * h, nx * w)`` plane of every rank's ``(..., h, w)``
    tile: gathered along ``"x"`` into row strips, then the strips along
    ``"y"``."""
    return _dim_all_gather(_dim_all_gather(tile, mesh, "x", -1), mesh, "y", -2)


def mesh_root(mesh) -> bool:
    """Whether this rank is the mesh's rank 0 (every coordinate 0): the one
    that writes plots and checkpoints and prints."""
    return all(int(c) == 0 for c in mesh.get_coordinate())


def mesh_barrier(mesh, device) -> None:
    """Return once every rank of the mesh has called this (an all-reduce of
    one int on ``device``)."""
    _mesh_all_reduce(torch.zeros((1,), dtype=torch.int32, device=device), dist.ReduceOp.SUM, mesh)


def _merge_fixed_point(lab: torch.Tensor, *, n_labels: int, merge_mask: torch.Tensor, mesh) -> torch.Tensor:
    """Transitive min-label union of all touching regions over the mesh
    (tiled.py:70-134 of the JAX package).

    The ``(n_labels + 1,)`` parent table is replicated: each round every
    rank scatters each pair (valid centre of its 1-px halo-padded tile,
    differing coloured 4-neighbour) into a per-label table of least
    partners, both ways; the tables combine by an all-reduce MIN over the
    mesh, the hook and the pointer jumping run identically on every rank,
    and an all-reduce MAX of one int says whether any root moved.  ``lab``
    is the ``(h, w)`` tile; ``merge_mask`` the ``(h + 2, w + 2)`` global
    interior.  Returns the relabelled tile.

    Both ways, as the reference's merge pairs and the port's single-device
    merge (ops/merge.py) do: a border pixel is never a centre, so a label
    held only on the border (a border seed whose neighbours another label
    claimed) meets its partners only through the pair's other side.  The
    JAX mesh scatters the centre's side alone and keeps such a label
    unmerged, unlike its own single-device transform: a deliberate
    divergence (ROADMAP queue 3), in the final labels and in the level
    loop alike."""
    dev = lab.device
    parent = torch.arange(n_labels + 1, dtype=torch.int32, device=dev)
    while True:
        cur_p = exchange_halo(parent[lab.long()], 1, mesh, off_grid_fill=UNCOLOURED)
        hp, wp = cur_p.shape
        pp = torch.nn.functional.pad(cur_p, (1, 1, 1, 1), value=UNCOLOURED)
        valid = (cur_p != UNCOLOURED) & merge_mask
        adj = torch.full((n_labels + 1,), _BIG, dtype=torch.int32, device=dev)
        for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            nb = pp[1 + dy : 1 + dy + hp, 1 + dx : 1 + dx + wp]
            pair = valid & (nb != UNCOLOURED) & (nb != cur_p)
            for dst, src in ((cur_p, nb), (nb, cur_p)):
                adj.scatter_reduce_(0, dst.reshape(-1).long(), torch.where(pair, src, _BIG).reshape(-1), "amin")
        adj = _mesh_all_reduce(adj, dist.ReduceOp.MIN, mesh)
        cand = torch.where(adj != _BIG, parent[adj.clamp(max=n_labels).long()], _BIG)
        new_parent = _pointer_jump(torch.minimum(parent, cand))
        moved = torch.tensor([int(not torch.equal(new_parent, parent))], dtype=torch.int32, device=dev)
        parent = new_parent
        if not int(_mesh_all_reduce(moved, dist.ReduceOp.MAX, mesh)[0]):
            return parent[lab.long()]


def _batched_sizes_from_levels(lab, lv, n_labels: int, max_water_level: int) -> torch.Tensor:
    """A tile's ``(levels, K+1)`` int32 cumulative claim counts (tiled.py:
    137-149 of the JAX package, one tile): cell counts by claim level and
    label, one ``scatter_add_``, summed over the levels.  No column-0 fix:
    the caller sums the tiles over the mesh first, then takes column 0 as
    the complement."""
    levels = max_water_level + 1
    k1 = n_labels + 1
    idx = lv.reshape(-1).clamp(0, levels).long() * k1 + lab.reshape(-1).long()
    counts = torch.zeros(((levels + 1) * k1,), dtype=torch.int32, device=lab.device)
    counts.scatter_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    return counts.view(levels + 1, k1)[:levels].cumsum(0, dtype=torch.int32)


def _complement_column0(sizes: torch.Tensor, global_shape) -> torch.Tensor:
    """Mesh-summed ``(levels, K+1)`` counts with column 0 the uncoloured
    count against the ORIGINAL domain, so the inert padding is not
    counted."""
    sizes[:, 0] = global_shape[0] * global_shape[1] - sizes[:, 1:].sum(1, dtype=torch.int32)
    return sizes


def _relax_collect_tail(labels, L, *, global_shape, n_labels, max_water_level, merging, collect, mesh):
    """The statistics / merge tail of the tiled relax engines (tiled.py:
    226-283 of the JAX package).  ``collect='claims'`` returns the raw
    ``(labels, claim levels)`` tile planes; ``'sizes'`` the mesh-summed
    ``(levels, K+1)`` cumulative counts with column 0 the complement
    against the original ``(gh, gw)``; ``'history'`` the ``(levels, h,
    w)`` snapshots of the tile.  Merging takes the transitive union over
    the global interior and serves ``collect='none'`` only
    (``tiled_transform`` checks the arguments)."""
    if collect == "claims":
        return labels, L
    if merging:
        h, w = labels.shape
        mask = global_interior_mask((h, w), global_shape, 1, mesh, labels.device)
        return _merge_fixed_point(labels, n_labels=n_labels, merge_mask=mask, mesh=mesh)
    if collect == "none":
        return labels
    if collect == "sizes":
        cum = _mesh_all_reduce(_batched_sizes_from_levels(labels, L, n_labels, max_water_level), dist.ReduceOp.SUM, mesh)
        return labels, _complement_column0(cum, global_shape)
    lvls = torch.arange(max_water_level + 1, dtype=torch.int32, device=labels.device)[:, None, None]
    return labels, torch.where(L[None] <= lvls, labels[None], UNCOLOURED)


def _image_plane(img_tile, global_shape, k: int, mesh) -> torch.Tensor:
    """The tile's ``(h + 2k, w + 2k)`` u8 value plane, exchanged once, under
    the GLOBAL border rule: NEVER_FILL outside the global interior, which
    covers the off-grid halo and the mesh padding (JAX's ``paint_mask``,
    tiled.py:606-607).  A whole-plane border ring (``flood_image``) would
    also paint the tile's own edge, which is interior."""
    h, w = img_tile.shape
    v_p = exchange_halo(img_tile.to(torch.uint8), k, mesh, off_grid_fill=NEVER_FILL)
    interior = global_interior_mask((h, w), global_shape, k, mesh, img_tile.device)
    return torch.where(interior, v_p, NEVER_FILL).to(torch.uint8).contiguous()


def _local_relax_packed_driver(img_tile, lab_tile, *, global_shape, n_labels, max_water_level, merging, halo,
                               mesh, collect="none", on_call=None):
    """The tiled packed relax engine on this rank's ``(h, w)`` tile (the
    counterpart of ``_local_relax_pallas_driver``, tiled.py:286-549).
    Returns ``(out, [rounds, tile calls run], starved)``, ``out`` as
    ``_relax_collect_tail`` gives it.
    ``on_call(v, src, dst, flags, ctr)``, when given, sees every relax call
    of this rank before the halo refresh: its value plane, input and output
    planes, flags and centre rectangle.

    The value plane is exchanged once, under the GLOBAL border rule
    (``_image_plane``).  The ``(h + 2k, w + 2k)`` key and label planes are
    carried across rounds; a round is one relax call of ``k`` sweeps whose
    flags count the centre rectangle ``(k, k + h, k, k + w)`` only, then the
    halo refresh of both planes.

    Why ``k`` sweeps a round are exact: the kernel reads the cells outside
    the plane as inert (unclaimed, label 0, value 255), which the true
    neighbours need not be.  That corruption enters through the plane's
    edge and moves one ring a sweep, in rows and in columns alike: after
    sweep j it has reached at most j - 1 rings into the k-wide halo.  After
    ``k`` sweeps the centre, k rings in, is untouched, and the refresh
    rewrites every halo cell (the off-grid ones with their fill) before the
    next call.  So a call may run at most ``k`` sweeps: ``steps == halo``.

    Convergence, the witness and the halo-stability certificate
    (tiled.py:325-338, :405-422): a rank needs another round iff its last
    call's last sweep changed a centre cell, or the end-of-round refresh
    changed an incoming strip against the previous round's strips (not
    against the in-plane halo, which holds the sweeps' corruption).  When
    no rank needs one, every tile is a fixed point against halo values that
    still are the neighbours' centre values: the global fixed point.  A
    rank with nothing to do skips its call but joins every collective.  On
    a 1 x 1 mesh every halo is off-grid and inert, so the refresh and the
    strips are skipped and the certificate is the witness alone.

    The kernel's quiet-tile skip is exact only under the ping-pong with no
    outside writes; the refresh writes into the planes between calls, so
    skipping is on for a 1 x 1 mesh only.  ``sat`` (the d-field saturation)
    is the last call's that ran, over the centre, reduced over the mesh.
    The claim levels (``key >> d_bits``, ``_BIG_L`` where unclaimed) are
    formed only where a consumer needs them (tiled.py:501-521): a collect,
    or a water level below the full depth.
    """
    h, w = lab_tile.shape
    k = halo
    dev = lab_tile.device
    d_bits, _, unclaimed = relax._key_consts(None)
    ny, nx, _, _ = mesh_layout(mesh)
    degenerate = ny == 1 and nx == 1

    v_p = _image_plane(img_tile, global_shape, k, mesh)
    hp, wp = h + 2 * k, w + 2 * k
    lab0 = lab_tile.to(torch.int32)
    key = torch.full((hp, wp), unclaimed, dtype=torch.int32, device=dev)
    key[k : k + h, k : k + w] = torch.where(lab0 != UNCOLOURED, 0, unclaimed)
    lab = torch.zeros((hp, wp), dtype=torch.int32, device=dev)
    lab[k : k + h, k : k + w] = lab0

    def refresh(planes):
        if degenerate:
            return ()
        _, ks = refresh_halo_padded(planes[0], k, h, w, mesh, off_grid_fill=unclaimed, return_strips=True)
        _, ls = refresh_halo_padded(planes[1], k, h, w, mesh, off_grid_fill=UNCOLOURED, return_strips=True)
        return ks + ls

    src, dst = (key, lab), (torch.empty_like(key), torch.empty_like(lab))
    strips = refresh(src)
    tiles = None
    if degenerate and dev.type == "cuda":
        tiles = relax._Tiles(relax.relax_plan(hp, wp, k), 3, dev)
    ctr = (k, k + h, k, k + w)
    need, sat, rounds, runs = True, 0, 0, 0
    while True:
        nc = 0
        if need:
            k2, l2, flags = relax.relax_block(v_p, *src, k, d_bits, out=dst, ctr=ctr, tiles=tiles)
            if on_call is not None:
                on_call(v_p, src, (k2, l2), flags, ctr)
            src, dst = (k2, l2), src
            if tiles is None:
                f = flags.tolist()
            else:
                f, _ = tiles.count(tiles.buf.tolist())
            nc, sat = f[relax.LAST], f[relax.SAT]
        new = refresh(src)
        moved = bool(torch.stack([(a != b).any() for a, b in zip(strips, new)]).any()) if new else False
        strips = new
        ran, need = need, bool(nc or moved)
        tot = _mesh_all_reduce(torch.tensor([int(need), int(ran)], dtype=torch.int32, device=dev),
                               dist.ReduceOp.SUM, mesh).tolist()
        rounds, runs = rounds + 1, runs + tot[1]
        if tot[0] == 0:
            break
    starved = bool(_mesh_all_reduce(torch.tensor([sat], dtype=torch.int32, device=dev), dist.ReduceOp.MAX, mesh)[0])
    key_c, lab_c = (p[k : k + h, k : k + w] for p in src)
    L = None
    if collect != "none" or max_water_level < NORMAL_MAX:
        L = torch.where(key_c == unclaimed, _BIG_L, key_c >> d_bits)
    # At full depth the claimed-ness gate keeps unclaimed cells at label 0.
    labels = lab_c.contiguous() if max_water_level >= NORMAL_MAX else torch.where(L <= max_water_level, lab_c, UNCOLOURED)
    if merging and starved:
        # A starved run is re-run on one device's exact engine: no merge.
        return labels, [rounds, runs], starved
    out = _relax_collect_tail(labels, L, global_shape=global_shape, n_labels=n_labels,
                              max_water_level=max_water_level, merging=merging, collect=collect, mesh=mesh)
    return out, [rounds, runs], starved


def _local_relax_driver(img_tile, lab_tile, *, global_shape, n_labels, max_water_level, merging, halo, mesh,
                        collect="none"):
    """JAX's jnp tiled relax engine on this rank's ``(h, w)`` tile (tiled.py:
    152-223 of the JAX package): the exact priority relaxation
    (ops/priority.py) on unpacked int32 ``(L, d, label)`` planes, plain
    torch ops on the tile's device.  Returns ``(out, [rounds, tile rounds
    run], False)``, ``out`` as ``_relax_collect_tail`` gives it.

    The ``(h + 2k, w + 2k)`` value plane is exchanged once, under the
    GLOBAL border rule (``_image_plane``).  The planes start from the seeds
    (key ``(0, 0)``; ``_BIG_L`` / ``_BIG_D`` / UNCOLOURED elsewhere).  A
    round exchanges the k-px halos of all three (off-grid: ``_BIG_L``,
    ``_BIG_D``, UNCOLOURED), runs ``k`` ``relax_sweep`` on the halo planes
    and keeps their centres; another round runs iff some rank's centre L, d
    or label changed (an all-reduce SUM of one int).

    Why ``k`` sweeps a round are exact: ``relax_sweep`` reads the cells
    outside the plane as inert (unclaimed, label 0), which the true
    neighbours need not be; JAX's rolls them in from the opposite edge.
    Either way that corruption enters at the plane's edge and moves one
    ring a sweep, so after ``k`` sweeps the centre, k rings in, is exact,
    and the next exchange rewrites every halo cell.  So a round is exactly
    k global sweeps, as JAX's is.

    d is int32 up to ``_BIG_D = 2**30`` and cannot saturate on any
    addressable image: ``starved`` is always False and nothing re-runs.
    The labels are masked by the claim level (``L <= max_water_level``) at
    every depth."""
    h, w = lab_tile.shape
    k = halo
    ny, nx, _, _ = mesh_layout(mesh)
    v_p = _image_plane(img_tile, global_shape, k, mesh).to(torch.int32)
    lab = lab_tile.to(torch.int32).contiguous()
    seeds = lab != UNCOLOURED
    L = torch.where(seeds, 0, _BIG_L).to(torch.int32)
    d = torch.where(seeds, 0, priority._BIG_D).to(torch.int32)
    rounds = 0
    while True:
        st = (exchange_halo(L, k, mesh, off_grid_fill=_BIG_L), exchange_halo(d, k, mesh, off_grid_fill=priority._BIG_D),
              exchange_halo(lab, k, mesh, off_grid_fill=UNCOLOURED))
        for _ in range(k):
            st = priority.relax_sweep(v_p, st)
        L2, d2, lab2 = (a[k : k + h, k : k + w].contiguous() for a in st)
        changed = ((L2 != L) | (d2 != d) | (lab2 != lab)).any().to(torch.int32).reshape(1)
        L, d, lab, rounds = L2, d2, lab2, rounds + 1
        if not int(_mesh_all_reduce(changed, dist.ReduceOp.SUM, mesh)[0]):
            break
    labels = torch.where(L <= max_water_level, lab, UNCOLOURED)
    out = _relax_collect_tail(labels, L, global_shape=global_shape, n_labels=n_labels,
                              max_water_level=max_water_level, merging=merging, collect=collect, mesh=mesh)
    return out, [rounds, rounds * ny * nx], False


def _tiled_flood_fixed_point(img_p, lab, lvl: int, *, halo: int, mesh, on_call=None):
    """Flood one water level of this rank's ``(h, w)`` label tile to the
    mesh-global fixed point (tiled.py:552-576 of the JAX package); shared
    by the level driver and ``MeshLevelStepper``, so that their semantics
    cannot drift apart.  ``img_p`` is the ``(h + 2k, w + 2k)`` value plane
    (``_image_plane``).  Returns ``(labels, rounds)``.

    A round exchanges the k-px label halo (off-grid: UNCOLOURED), runs ONE
    ``flood_block`` call of ``steps = k`` sweeps on the ``(h + 2k, w +
    2k)`` plane (the flood kernel on a CUDA plane, its twin on the CPU;
    every tile runs) and keeps its centre.  The ghost argument of the relax
    driver holds: the kernel reads the cells outside the plane as
    uncoloured and never floodable, which the true neighbours need not be;
    that corruption moves one ring a sweep, so after k sweeps it has not
    reached the centre, and the next exchange rewrites the halo.  So
    ``steps`` must never exceed ``k``.  The stop rule is JAX's: some rank's
    centre changed in the round (compared before and after the call, not
    by the kernel's whole-plane flags, whose halo cells evolve within a
    call), reduced with MAX over the mesh; a round is k global sweeps, so
    the round count equals JAX's.  ``on_call(v, src, dst, flags, lvl)``,
    when given, sees every call."""
    h, w = lab.shape
    k = halo
    rounds = 0
    while True:
        lab_p = exchange_halo(lab, k, mesh, off_grid_fill=UNCOLOURED).contiguous()
        out, flags = flood_block.flood_block(img_p, lab_p, lvl, k)
        if on_call is not None:
            on_call(img_p, lab_p, out, flags, lvl)
        new = out[k : k + h, k : k + w].contiguous()
        changed = (new != lab).any().to(torch.int32).reshape(1)
        lab, rounds = new, rounds + 1
        if not int(_mesh_all_reduce(changed, dist.ReduceOp.MAX, mesh)[0]):
            return lab, rounds


def _local_level_step(img_p, lab, lvl: int, *, merge_mask, n_labels: int, merging: bool, halo: int, mesh,
                      on_call=None):
    """ONE water level on this rank's tile (tiled.py:887-924 of the JAX
    package): the flood fixed point over the mesh, then for merging the
    mesh merge (``_merge_fixed_point``, both ways).  Returns ``(labels,
    rounds)``: the halo-exchange rounds, the mesh's analogue of the
    reference's per-colouring-iteration ticks (src/lib.rs:1395-1398)."""
    lab, rounds = _tiled_flood_fixed_point(img_p, lab, lvl, halo=halo, mesh=mesh, on_call=on_call)
    if merging:
        lab = _merge_fixed_point(lab, n_labels=n_labels, merge_mask=merge_mask, mesh=mesh)
    return lab, rounds


def _local_level_driver(img_tile, lab_tile, *, global_shape, n_labels, max_water_level, merging, halo, mesh,
                        collect="none", on_call=None):
    """The per-level sweep on this rank's ``(h, w)`` tile (tiled.py:579-675
    of the JAX package), through the level driver's ``_collect_loop``:
    final labels, or with them the mesh-summed ``(levels, K+1)`` sizes
    (column 0 the complement against the original domain) or the tile's
    ``(levels, h, w)`` snapshots.  A level L > 0 runs iff some pixel of the
    whole image has value L: a 256-bin histogram summed over the mesh, so
    every rank takes the same decision and joins the same collectives."""
    h, w = lab_tile.shape
    img_p = _image_plane(img_tile, global_shape, halo, mesh)
    merge_mask = global_interior_mask((h, w), global_shape, 1, mesh, lab_tile.device) if merging else None
    vhist = _mesh_all_reduce(value_histogram(img_tile), dist.ReduceOp.SUM, mesh)

    def step(lab, lvl):
        return _local_level_step(img_p, lab, lvl, merge_mask=merge_mask, n_labels=n_labels, merging=merging,
                                 halo=halo, mesh=mesh, on_call=on_call)[0]

    out = _collect_loop(step, lab_tile.to(torch.int32).contiguous(), levels=max_water_level + 1, vhist=vhist,
                        collect=collect, n_labels=n_labels)
    if collect == "sizes":
        lab, sizes = out
        return lab, _complement_column0(_mesh_all_reduce(sizes, dist.ReduceOp.SUM, mesh), global_shape)
    return out


def _mesh_pad(img, labels0, ny: int, nx: int):
    """Embed ``(H, W)`` planes in a mesh-divisible domain with INERT
    padding at the bottom and right: NEVER_FILL values, UNCOLOURED labels.
    The drivers apply the interior rule of the ORIGINAL shape, so padded
    cells can never claim, donate or act as merge centres, and the crop is
    the exact-divisible result.  H pads to a multiple of 8 * ny when it can
    (the JAX rule, tiled.py:678-697, kept so that the two packages cut the
    same tiles)."""
    gh, gw = img.shape
    pad_h = -gh % (8 * ny) if gh >= 8 * ny else -gh % ny
    pad_w = -gw % nx
    if pad_h == 0 and pad_w == 0:
        return img, labels0
    img = torch.nn.functional.pad(img, (0, pad_w, 0, pad_h), value=NEVER_FILL)
    labels0 = torch.nn.functional.pad(labels0, (0, pad_w, 0, pad_h), value=UNCOLOURED)
    return img, labels0


def _auto_backend(merging: bool, collect: str) -> str:
    """``backend='auto'`` (tiled.py:853-865): the level sweep for the
    merging variant's per-level statistics, the packed engine otherwise.
    JAX's ``'auto'`` takes its jnp engine ``'relax'`` on every mesh that is
    not a TPU mesh; the port's takes the packed engine on every device (its
    kernel's twin on the CPU), a deliberate divergence (ROADMAP queue 3)
    that changes no label."""
    return "sweep" if merging and collect != "none" else "packed"


def _tiled_run(img, labels0, mesh, *, n_labels: int, max_water_level: int, merging: bool = False,
               halo: int | None = None, collect: str = "none", backend: str = "packed", on_call=None):
    """``tiled_transform`` of one ``(H, W)`` image on ``backend`` (``'packed'``,
    ``'relax'`` or ``'sweep'``): ``(out, [rounds, tile calls run] or None,
    starved)`` (for ``'relax'`` the tile calls are tile rounds).
    ``out`` is the cropped labels, or ``(labels, second)`` with a collect:
    the claim levels or snapshots (all-gathered and cropped like the
    labels) or the sizes (already mesh-wide).  ``starved``: the packed
    key's d field saturated somewhere on the mesh, so the caller should
    re-run on the exact engine (the JAX mesh drops this flag).  ``on_call``
    goes to the driver: a relax call's ``(v, src, dst, flags, ctr)`` or a
    flood call's ``(v, src, dst, flags, lvl)`` (``'relax'`` calls no
    kernel and shows nothing)."""
    ny, nx, iy, ix = mesh_layout(mesh)
    gh, gw = img.shape
    img_p, lab_p = _mesh_pad(img, labels0, ny, nx)
    h, w = img_p.shape[0] // ny, img_p.shape[1] // nx
    if halo is None:
        halo = max(1, min(relax.DEFAULT_STEPS, h, w))
    k = int(halo)
    if not 1 <= k <= min(h, w):
        raise ValueError(f"halo {k} must lie in 1..min(tile) = {min(h, w)} for {h}x{w} tiles")
    kw = dict(global_shape=(gh, gw), n_labels=n_labels, max_water_level=max_water_level, merging=merging,
              halo=k, mesh=mesh, collect=collect)
    tile = (slice(iy * h, (iy + 1) * h), slice(ix * w, (ix + 1) * w))
    if backend == "packed":
        out, stats, starved = _local_relax_packed_driver(img_p[tile], lab_p[tile], on_call=on_call, **kw)
    elif backend == "relax":
        out, stats, starved = _local_relax_driver(img_p[tile], lab_p[tile], **kw)
    elif backend == "sweep":
        out, stats, starved = _local_level_driver(img_p[tile], lab_p[tile], on_call=on_call, **kw), None, False
    else:
        raise ValueError(f"unknown tiled backend {backend!r}")

    def full(t):
        return _mesh_all_gather(t, mesh)[..., :gh, :gw]

    if collect == "none":
        return full(out), stats, starved
    labels, second = out
    return (full(labels), second if collect == "sizes" else full(second)), stats, starved


def _tiled_batch(imgs, labels0, mesh, *, axis_batch: str = "batch", collect: str = "none", **kw):
    """``tiled_transform`` of a ``(B, H, W)`` stack over a mesh with a batch
    dim: this rank's batch group takes images ``[ib * B/nb, (ib + 1) *
    B/nb)`` and runs them one after another on its ``(y, x)`` sub-mesh; the
    results come back by an all-gather over ``axis_batch``.  Returns
    ``(out, starved)``: ``out`` as ``tiled_transform``'s with the batch
    axis (labels ``(B, H, W)``; sizes ``(levels, B, K+1)``; snapshots
    ``(levels, B, H, W)``) and ``starved`` a ``(B,)`` bool array."""
    names = tuple(mesh.mesh_dim_names or ())
    if axis_batch not in names:
        raise ValueError(f"axis_batch {axis_batch!r} is not a dim of the mesh {names}")
    d = names.index(axis_batch)
    nb, ib = int(mesh.mesh.shape[d]), int(mesh.get_coordinate()[d])
    b = imgs.shape[0]
    if imgs.dim() != 3 or b % nb:
        raise ValueError(f"a (B, H, W) stack of B divisible by the {nb} batch groups is needed, got {tuple(imgs.shape)}")
    bl = b // nb
    runs = [_tiled_run(imgs[i], labels0[i], mesh, collect=collect, **kw) for i in range(ib * bl, (ib + 1) * bl)]
    starved = torch.tensor([int(r[2]) for r in runs], dtype=torch.int32, device=imgs.device)
    starved = _dim_all_gather(starved, mesh, axis_batch, 0).cpu().numpy().astype(bool)

    def stack(parts, axis):
        return _dim_all_gather(torch.stack(parts, dim=axis), mesh, axis_batch, axis)

    if collect == "none":
        return stack([r[0] for r in runs], 0), starved
    labels = stack([r[0][0] for r in runs], 0)
    second = stack([r[0][1] for r in runs], 0 if collect == "claims" else 1)
    return (labels, second), starved


def tiled_transform(img, labels0, mesh, *, n_labels: int, max_water_level: int, merging: bool = False,
                    halo: int | None = None, collect: str = "none", axis_batch: str | None = None,
                    backend: str = "auto", with_stats: bool = False):
    """The full watershed of ``(H, W)`` ``img`` (uint8) from painted seeds
    ``labels0`` (int32), tiled over ``mesh``, on every rank (see the module
    docstring): final labels, ``(H, W)`` int32 on the device of ``img``;
    with ``collect='sizes'`` also the ``(levels, K+1)`` int32 lake sizes,
    with ``'history'`` the ``(levels, H, W)`` snapshots, with ``'claims'``
    (segmenting, ``'packed'`` or ``'relax'``) the raw claim levels
    (``_BIG_L`` = 256 where no seed claimed; the packed key leaves level
    255 unclaimed, the unpacked ``'relax'`` planes may claim it).  With ``axis_batch`` the inputs are ``(B, H, W)``
    stacks split over that mesh dim (B divisible by its size) and the
    outputs gain the batch axis (the sizes and snapshots after the level
    axis, as in the JAX package).

    Every rank passes the same full image and seeds.  ``backend``:
    ``'packed'`` (JAX's ``'relax_pallas'``), ``'relax'`` (JAX's jnp engine,
    plain torch ops), ``'sweep'`` (the per-level flood loop) or ``'auto'``
    (``_auto_backend``: the level sweep for merging with a collect, the
    packed engine otherwise).  ``halo`` is the halo width k and the
    sweeps per round; ``None`` takes ``DEFAULT_STEPS`` clamped to the tile
    extents, as tiled.py:758-761 clamps.  ``with_stats=True`` (packed,
    ``collect='none'``, no batch) also returns ``[rounds, tile calls run]``
    (the mesh scaling study's counts)."""
    if backend not in ("auto", "packed", "relax", "sweep"):
        raise ValueError(f"unknown backend {backend!r} (auto, packed, relax or sweep)")
    if collect not in COLLECTS:
        raise ValueError(f"unknown collect mode {collect!r}")
    if backend == "auto":
        backend = _auto_backend(merging, collect)
    if with_stats and (backend != "packed" or collect != "none" or axis_batch is not None):
        raise ValueError("with_stats=True needs backend='packed', collect='none' and no batch axis")
    if collect == "claims" and (merging or backend not in ("packed", "relax")):
        raise ValueError("collect='claims' is the relax engines' raw (labels, claim levels) output; "
                         "use merging=False with backend 'packed' or 'relax'")
    if merging and collect != "none" and backend in ("packed", "relax"):
        raise ValueError("tiled relax: merging supports collect='none' only")
    kw = dict(n_labels=n_labels, max_water_level=max_water_level, merging=merging, halo=halo, collect=collect,
              backend=backend)
    if axis_batch is not None:
        return _tiled_batch(img, labels0, mesh, axis_batch=axis_batch, **kw)[0]
    out, stats, _ = _tiled_run(img, labels0, mesh, **kw)
    return (out, stats) if with_stats else out


class MeshLevelStepper:
    """The host-stepped per-level loop over a mesh (tiled.py:927-1005 of
    the JAX package): the builder's hooks, plots, progress, debug and
    per-level checkpoints call ``step`` once a water level, as the single
    device's loop calls its level step, with the level's flood fixed point
    and merge running tiled over the mesh (``_local_level_step``).

    SPMD, like the rest of the module: every rank calls ``prepare`` with
    the full ``(H, W)`` image and labels and gets its own value plane and
    label tile; ``step`` returns the tile and the rounds; ``crop``
    all-gathers the ``(H, W)`` labels to every rank as numpy.  The default
    halo is JAX's, 4 (clamped to a smaller tile), so that the rounds, the
    progress ticks and debug's ``loops`` equal JAX's.  ``on_call`` sees
    every flood call (``_tiled_flood_fixed_point``)."""

    def __init__(self, mesh, *, n_labels: int, merging: bool, halo: int = 4, on_call=None):
        self.mesh = mesh
        self.ny, self.nx, self.iy, self.ix = mesh_layout(mesh)
        self.n_labels, self.merging, self.halo, self.on_call = n_labels, merging, int(halo), on_call
        self._shape = self._merge_mask = None

    def prepare(self, img, labels0):
        """``(value plane, label tile)`` of this rank from the full ``(H,
        W)`` image and labels (tensors on the tiles' device); records the
        crop.  A resume re-embeds a snapshot's labels the same way."""
        gh, gw = img.shape
        img_p, lab_p = _mesh_pad(img, labels0, self.ny, self.nx)
        h, w = img_p.shape[0] // self.ny, img_p.shape[1] // self.nx
        self._shape, self._k = (gh, gw), max(1, min(self.halo, h, w))
        tile = (slice(self.iy * h, (self.iy + 1) * h), slice(self.ix * w, (self.ix + 1) * w))
        if self.merging:
            self._merge_mask = global_interior_mask((h, w), (gh, gw), 1, self.mesh, img.device)
        return _image_plane(img_p[tile], (gh, gw), self._k, self.mesh), lab_p[tile].to(torch.int32).contiguous()

    def step(self, img, labels, lvl: int):
        """One water level: ``(label tile, rounds)``."""
        return _local_level_step(img, labels, int(lvl), merge_mask=self._merge_mask, n_labels=self.n_labels,
                                 merging=self.merging, halo=self._k, mesh=self.mesh, on_call=self.on_call)

    def crop(self, labels) -> np.ndarray:
        """The ``(H, W)`` labels of the whole mesh, on every rank."""
        gh, gw = self._shape
        return _mesh_all_gather(labels, self.mesh)[:gh, :gw].cpu().numpy()


def make_mesh(n_ranks: int | None = None, axis_names=("y", "x"), device_type: str = "cuda"):
    """A near-square 2-D ``DeviceMesh`` over ranks ``0 .. n_ranks - 1`` (the
    whole world by default) of the initialised process group, the JAX
    ``make_mesh`` rule (tiled.py:1008-1015).  ``device_type`` picks the
    mesh's backend: ``"cuda"`` (NCCL) or ``"cpu"`` (gloo)."""
    from torch.distributed.device_mesh import DeviceMesh

    n = int(n_ranks or dist.get_world_size())
    ny = math.isqrt(n)
    while n % ny:
        ny -= 1
    return DeviceMesh(device_type, torch.arange(n).reshape(ny, n // ny), mesh_dim_names=tuple(axis_names))
