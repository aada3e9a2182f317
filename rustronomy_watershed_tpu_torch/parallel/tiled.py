"""The watershed tiled over a ``torch.distributed`` device mesh.

Counterpart of ``rustronomy_watershed_tpu.parallel.tiled`` for final labels
(``collect='none'``): its tiled packed relax engine
(``_local_relax_pallas_driver``) with the merging variant's
``_merge_fixed_point``.  Per-level statistics, the host-stepped level loop
(``MeshLevelStepper``) and the batch axis are not ported yet (ROADMAP queue 1
item 13 (b)).

SPMD.  JAX runs one controller over every device; here every rank is a
process that calls ``tiled_transform`` with the same full image and seeds.
Each rank pads the image to a mesh-divisible domain (``_mesh_pad``), takes
its own tile (row-major over the mesh's ``("y", "x")`` dims), relaxes it on
its device with k-px halos exchanged between neighbour ranks
(parallel/halo.py), merges over the mesh for the merging variant, and gets
the full cropped labels back by an all-gather.  No rank is a driver; the
labels equal the single-device labels on every rank.

Collectives: the halo strips go point to point on the ``"y"`` / ``"x"``
groups; a reduction over the whole mesh is one all-reduce on the ``"y"``
group and one on the ``"x"`` group.  Where a group's backend is gloo and the
tensors lie on the card, they go through host memory (``halo.staged``).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..constants import INT32_MAX, NEVER_FILL, NORMAL_MAX, UNCOLOURED
from ..ops import relax
from ..ops.merge import _pointer_jump
from .halo import exchange_halo, global_interior_mask, mesh_layout, refresh_halo_padded, staged

_BIG = INT32_MAX


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


def _mesh_all_gather(tile: torch.Tensor, mesh) -> torch.Tensor:
    """The ``(ny * h, nx * w)`` plane of every rank's ``(h, w)`` tile:
    gathered along ``"x"`` into row strips, then the strips along ``"y"``."""
    out = tile.contiguous()
    for dim, axis in (("x", 1), ("y", 0)):
        group = mesh.get_group(dim)
        wire = out.cpu() if staged(group, out) else out
        parts = [torch.empty_like(wire) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, wire, group=group)
        out = torch.cat(parts, dim=axis)
    return out.to(tile.device)


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
    divergence (ROADMAP queue 3)."""
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


def _relax_collect_tail(labels, *, global_shape, n_labels, merging, collect, mesh):
    """The statistics / merge tail of the tiled relax engine (tiled.py:
    226-283 of the JAX package), final labels only: merging takes the
    transitive union over the global interior."""
    if collect != "none":
        raise NotImplementedError(
            f"collect={collect!r} on a mesh is not ported to the PyTorch package yet "
            "(ROADMAP queue 1 item 13 (b))"
        )
    if merging:
        h, w = labels.shape
        mask = global_interior_mask((h, w), global_shape, 1, mesh, labels.device)
        labels = _merge_fixed_point(labels, n_labels=n_labels, merge_mask=mask, mesh=mesh)
    return labels


def _local_relax_driver(img_tile, lab_tile, *, global_shape, n_labels, max_water_level, merging, halo, mesh,
                        on_call=None):
    """The tiled packed relax engine on this rank's ``(h, w)`` tile (the
    counterpart of ``_local_relax_pallas_driver``, tiled.py:286-549).
    Returns ``(labels, [rounds, tile calls run], starved)``.
    ``on_call(v, src, dst, flags, ctr)``, when given, sees every relax call
    of this rank before the halo refresh: its value plane, input and output
    planes, flags and centre rectangle.

    The value plane is exchanged once, under the GLOBAL border rule: it is
    NEVER_FILL outside the global interior, which covers the off-grid halo
    and the mesh padding.  The ``(h + 2k, w + 2k)`` key and label planes are
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
    """
    h, w = lab_tile.shape
    k = halo
    dev = lab_tile.device
    d_bits, _, unclaimed = relax._key_consts(None)
    ny, nx, _, _ = mesh_layout(mesh)
    degenerate = ny == 1 and nx == 1

    v_p = exchange_halo(img_tile.to(torch.uint8), k, mesh, off_grid_fill=NEVER_FILL)
    interior = global_interior_mask((h, w), global_shape, k, mesh, dev)
    v_p = torch.where(interior, v_p, NEVER_FILL).to(torch.uint8).contiguous()

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
            f = flags.tolist()
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
    if max_water_level >= NORMAL_MAX:
        # The claimed-ness gate keeps unclaimed cells at label 0.
        labels = lab_c.contiguous()
    else:
        labels = torch.where(key_c < (max_water_level + 1) << d_bits, lab_c, UNCOLOURED)
    if not starved:
        # A starved run is re-run on one device's exact engine: no merge.
        labels = _relax_collect_tail(
            labels, global_shape=global_shape, n_labels=n_labels, merging=merging, collect="none", mesh=mesh
        )
    return labels, [rounds, runs], starved


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


def _tiled_run(img, labels0, mesh, *, n_labels: int, max_water_level: int, merging: bool = False,
               halo: int | None = None, on_call=None):
    """``tiled_transform``'s labels, ``[rounds, tile calls run]`` and
    ``starved``: the packed key's d field saturated somewhere on the mesh,
    so the caller should re-run on the exact engine (the JAX mesh drops this
    flag).  ``on_call`` goes to the driver (``_local_relax_driver``)."""
    ny, nx, iy, ix = mesh_layout(mesh)
    gh, gw = img.shape
    img_p, lab_p = _mesh_pad(img, labels0, ny, nx)
    h, w = img_p.shape[0] // ny, img_p.shape[1] // nx
    if halo is None:
        halo = max(1, min(relax.DEFAULT_STEPS, h, w))
    k = int(halo)
    if not 1 <= k <= min(h, w):
        raise ValueError(f"halo {k} must lie in 1..min(tile) = {min(h, w)} for {h}x{w} tiles")
    labels, stats, starved = _local_relax_driver(
        img_p[iy * h : (iy + 1) * h, ix * w : (ix + 1) * w],
        lab_p[iy * h : (iy + 1) * h, ix * w : (ix + 1) * w],
        global_shape=(gh, gw), n_labels=n_labels, max_water_level=max_water_level,
        merging=merging, halo=k, mesh=mesh, on_call=on_call,
    )
    return _mesh_all_gather(labels, mesh)[:gh, :gw], stats, starved


def tiled_transform(img, labels0, mesh, *, n_labels: int, max_water_level: int, merging: bool = False,
                    halo: int | None = None, with_stats: bool = False):
    """The full watershed of ``(H, W)`` ``img`` (uint8) from painted seeds
    ``labels0`` (int32), tiled over ``mesh``: final labels, ``(H, W)`` int32
    on the device of ``img``, on every rank (see the module docstring).

    Every rank passes the same full image and seeds.  ``halo`` is the halo
    width k and the sweeps per round; ``None`` takes ``DEFAULT_STEPS``
    clamped to the tile extents, as tiled.py:758-761 clamps.
    ``with_stats=True`` also returns ``[rounds, tile calls run]`` (the mesh
    scaling study's counts)."""
    out, stats, _ = _tiled_run(img, labels0, mesh, n_labels=n_labels, max_water_level=max_water_level,
                               merging=merging, halo=halo)
    return (out, stats) if with_stats else out


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
