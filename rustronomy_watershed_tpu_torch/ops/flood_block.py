"""The level-sweep engine's flood kernel: ``steps`` fused Jacobi flood
sweeps per call, and the per-level fixed point.

Counterpart of ``rustronomy_watershed_tpu.ops.pallas_flood`` (backend
``'pallas'`` of the JAX package, ``'flood'`` inside the port).  Layers:
``flood_block`` (one call = exactly ``steps`` global sweeps of
ops/flood.py's update, csrc/flood.cu on CUDA planes, ``flood_block_plain``
on CPU planes) -> ``flood_fixed_point_block`` (host loop until a call's last
sweep changed nothing; on the card the calls skip quiet tiles) ->
ops/level_driver.py.

The planes carry no aprons: the kernel reads cells outside the image as
uncoloured and never floodable, and takes the image with its border ring
forced to NEVER_FILL (``flood_image``, the ring ``pad_domain`` writes at
pallas_flood.py:77-80), so border pixels are never painted but still donate.

A call's flags are one int32 tensor ``[painted, not_converged]``: some cell
of the output differs from the input (it gates the merge phase), and the
last sweep changed some cell (when 0, the level's fixed point is certified:
pallas_flood.py:34-40).

The reference's activity vector (pallas_flood.py:18-24: a level's first
call runs the bands that hold a pixel of value L, later calls the bands
that changed and their neighbours) becomes tile state on 2-D tiles
(``FloodTiles``): the previous call's per-tile change bytes (``CHANGED``:
some sweep changed a centre cell; ``CHANGED_LAST``: the last sweep did)
and, once per transform, the per-tile presence bits of the 256 pixel values
(``tile_presence``, the counterpart of ``band_histogram``).  The rule is
``flood_active_tiles``; why it is exact is in ``flood_fixed_point_block``.
"""

from __future__ import annotations

import torch

from .. import _ext
from ..constants import NEVER_FILL
from .flood import flood_sweep
from .relax import quiet_tiles, strip_plan

DEFAULT_STEPS = 8
PAINTED, NOT_CONVERGED = 0, 1  # indices into a call's flags
CHANGED, CHANGED_LAST = 1, 2  # bits of a tile's change byte
_IMG_GROUPS = 9  # kGroups: the 16-byte image groups one 128-column window row spans


def flood_plan(h: int, w: int, steps: int) -> dict:
    """The flood kernel's launch: the relax kernel's window geometry
    (``strip_plan``: 8-row strips in 16 warps, 128 x 128 windows, 112 x 112
    centre tiles at 8 steps, ``skip`` when steps <= the tile edge) and
    ``smem``: the row exchange (2 sweep parities x top and bottom rows x
    128 int32 per warp) and each warp's staged image masks (one int32 per
    16-byte group of each of its 8 rows)."""
    plan = strip_plan(h, w, steps, "flood")
    plan["smem"] = plan["warps"] * (2 * 2 * 128 * 4 + plan["rows"] * _IMG_GROUPS * 4)
    return plan


def flood_image(img):
    """The u8 image with its 1-px border ring at NEVER_FILL: the kernel's
    image plane (the reference never paints border pixels, src/lib.rs:
    220-233)."""
    v = img.to(torch.uint8).clone()
    v[0, :] = NEVER_FILL
    v[-1, :] = NEVER_FILL
    v[:, 0] = NEVER_FILL
    v[:, -1] = NEVER_FILL
    return v.contiguous()


def tile_presence(img, plan: dict):
    """``(n_tiles, 32)`` uint8: bit ``v % 8`` of byte ``v // 8`` of a tile's
    row says that the tile holds a pixel of value ``v``, for the plan's
    centre tiles in row-major order.  Plain PyTorch, once per transform."""
    h, w = img.shape
    ty, tx, (gy, gx) = plan["tile_y"], plan["tile_x"], plan["grid"]
    rows = torch.arange(h, device=img.device) // ty
    cols = torch.arange(w, device=img.device) // tx
    idx = ((rows[:, None] * gx + cols[None, :]) << 8) + img.long()
    seen = torch.zeros((gy * gx * 256,), dtype=torch.bool, device=img.device)
    seen[idx.reshape(-1)] = True
    bits = seen.view(gy * gx, 32, 8).to(torch.uint8) << torch.arange(8, dtype=torch.uint8, device=img.device)
    return bits.sum(-1, dtype=torch.uint8).contiguous()


def flood_active_tiles(changed, presence, lvl: int, first: bool):
    """The tiles whose sweeps a call runs, as a ``(gy, gx)`` bool plane:
    those whose 3 x 3 neighbourhood holds a tile that changed in the
    previous call's last sweep (``changed & CHANGED_LAST``), or, on a
    level's ``first`` call, a tile that holds a pixel of value ``lvl``
    (``presence``, as ``tile_presence`` gives it).  Of the others, a tile
    that changed in the previous call (``changed & CHANGED``) copies its
    centre to the destination plane.  Plain PyTorch, the rule csrc/flood.cu
    applies per block."""
    hot = (changed & CHANGED_LAST) != 0
    if first:
        hot = hot | ((presence[:, lvl >> 3] >> (lvl & 7)) & 1).bool().view(changed.shape)
    return ~quiet_tiles(hot.to(torch.int32))


def flood_block_plain(img, lab, lvl: int, steps: int, *, out=None):
    """Plain PyTorch twin of the flood kernel: ``steps`` flood sweeps with
    no interior mask (the image's border ring does its work) plus the two
    flags.  Returns ``(lab', flags)``."""
    _ext.launches["flood_plain"] += 1
    new, last = lab, torch.zeros((), dtype=torch.bool, device=lab.device)
    for _ in range(steps):
        nxt = flood_sweep(img, new, lvl, mask=True)
        last = (nxt != new).any()
        new = nxt
    flags = torch.stack([(new != lab).any(), last]).to(torch.int32)
    if out is not None:
        out.copy_(new)
        new = out
    return new, flags


class FloodTiles:
    """Tile state of a skipping flood fixed point on the card: the per-tile
    change bytes of the last two calls (ping-pong), the presence bits
    (``tile_presence``; None: every fixed point's first call runs every
    tile) and one flag buffer ``[painted, not_converged, tiles that ran no
    sweeps, of them the tiles that copied their centre]``.

    With presence bits the state spans a level sweep: the caller keeps its
    two label planes in sync where the change bytes say so, and the planes
    at the previous level's fixed point (ops/level_driver.py)."""

    def __init__(self, plan: dict, device, presence=None):
        self.plan, self.presence, self.calls = plan, presence, 0
        self.chg = torch.zeros((2, plan["n_tiles"]), dtype=torch.uint8, device=device)
        self.flags = torch.empty((4,), dtype=torch.int32, device=device)

    def next_call(self, first: bool):
        """``(chg_prev or None, chg)`` for the next call: skipping needs a
        plan whose tiles hold a call's cone and, on a first call, the
        presence bits."""
        k, self.calls = self.calls, self.calls + 1
        run_all = not self.plan["skip"] or (first and self.presence is None)
        return None if run_all else self.chg[(k + 1) % 2], self.chg[k % 2]


def flood_block_kernel(img, lab, lvl: int, steps: int, *, out=None, tiles=None, first=False):
    """Launch csrc/flood.cu: ``steps`` flood sweeps of a CUDA label plane
    into ``out`` (a fresh plane when None; never the input plane).
    ``tiles`` (a ``FloodTiles``) lets the call skip the sweeps of quiet
    tiles, ``first`` saying whether it is its level's first call; the
    counts of tiles that ran no sweeps and of those that copied follow the
    flags in ``tiles.flags``.  Without ``tiles`` every tile runs."""
    if img.dtype != torch.uint8 or lab.dtype != torch.int32:
        raise ValueError("flood kernel takes a uint8 image and an int32 label plane")
    if img.shape != lab.shape or lab.dim() != 2:
        raise ValueError("flood kernel planes must share one 2-D shape")
    out = torch.empty_like(lab) if out is None else out
    planes = (img, lab, out)
    if not lab.is_cuda or not all(t.is_contiguous() and t.device == lab.device for t in planes):
        raise ValueError("flood kernel planes must be contiguous on one CUDA device")
    if out.shape != lab.shape or out.dtype != lab.dtype:
        raise ValueError("flood kernel output plane must match the int32 label plane")
    if out.data_ptr() == lab.data_ptr():
        raise ValueError("flood kernel output plane must not alias its input")
    if not 0 <= lvl <= 255:
        raise ValueError("flood kernel needs a level in 0..255")
    h, w = lab.shape
    plan = flood_plan(h, w, steps)
    if tiles is None:
        flags, prev, chg, presence = torch.empty((4,), dtype=torch.int32, device=lab.device), None, None, None
    else:
        if tiles.plan != plan:
            raise ValueError("flood tile state does not match this call")
        flags, presence = tiles.flags, tiles.presence
        prev, chg = tiles.next_call(first)
        _ext.launches["flood_tiles"] += 1
    first = bool(first) and prev is not None
    vec = w % 16 == 0 and all(t.data_ptr() % 16 == 0 for t in planes)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = _ext.lib().rwt_flood(
        img.data_ptr(), lab.data_ptr(), out.data_ptr(), flags.data_ptr(), ptr(prev), ptr(chg),
        ptr(presence if first else None), h, w, int(lvl), steps, int(first), plan["rows"], plan["threads"],
        plan["tile_y"], plan["tile_x"], *plan["grid"], plan["smem"], int(vec), _ext.stream_ptr(lab),
    )
    _ext.check(err, "rwt_flood")
    _ext.launches["flood"] += 1
    return out, flags[:2]


def flood_block(img, lab, lvl: int, steps: int = DEFAULT_STEPS, *, out=None):
    """One call = exactly ``steps`` global flood sweeps at level ``lvl`` of
    ``lab`` over ``img`` (a ``flood_image``).  CUDA planes launch the
    kernel (every tile runs), CPU planes run the plain twin.  Returns
    ``(lab', flags)`` with flags ``[painted, not_converged]``."""
    if lab.device.type == "cuda":
        return flood_block_kernel(img, lab, lvl, steps, out=out)
    if lab.device.type == "cpu":
        return flood_block_plain(img, lab, lvl, steps, out=out)
    raise ValueError(f"unsupported device {lab.device}")


def flood_tiles(img, steps: int = DEFAULT_STEPS) -> FloodTiles:
    """The tile state of a level sweep over ``img`` (a ``flood_image`` on
    the card): no tile changed yet, and the presence bits."""
    plan = flood_plan(*img.shape, steps)
    return FloodTiles(plan, img.device, tile_presence(img, plan))


def flood_fixed_point_block(img, lab, lvl: int, *, steps: int = DEFAULT_STEPS, scratch=None, tiles=None,
                            on_call=None):
    """Iterate flood_block at level ``lvl`` until a call's last sweep
    changed nothing (at least one call, like the reference's do-while).

    ``lab`` and ``scratch`` (a plane like ``lab``; allocated when None) are
    the two ping-pong buffers and are overwritten.  Returns ``(lab,
    scratch, painted)``: the fixed point, the other buffer, and whether the
    level painted a pixel.  The host reads one flag buffer per call.
    ``on_call(src, dst, flags, skipped)``, when given, sees every call: its
    input and output planes, its flags and the number of tiles that ran no
    sweeps.

    On the card a call runs the sweeps of a tile only where its 3 x 3
    neighbourhood of tiles changed in the previous call's last sweep
    (``flood_active_tiles``); with a level sweep's ``tiles``
    (``flood_tiles``), which carry the change bytes across levels, a
    level's first call runs them where a neighbour tile holds a pixel of
    value ``lvl``.  Without ``tiles`` the first call runs every tile.  Why
    this is exact (steps <= the tile edge, so a call's dependency cone
    stays in the neighbourhood):

    * a cell changes in a sweep only if a 4-neighbour changed in the
      sweep before (it was uncoloured and floodable with no coloured
      neighbour), or, in the first sweep of a level, if it has the
      level's value: the level starts from the previous level's fixed
      point (merging relabels coloured cells and never changes which are
      coloured), where no uncoloured cell below ``lvl`` has a coloured
      neighbour.  So a cell changed in sweep j of a call lies within j
      cells of a cell changed in the previous call's last sweep, or on a
      first call within j - 1 cells of a pixel of value ``lvl``, and a
      tile with neither in its neighbourhood changes nothing.  The
      reference runs only the bands that hold such a pixel, undilated
      (level_driver.py:453); the neighbourhood keeps every call equal to
      ``steps`` global sweeps, so it can be held against the twin call by
      call.  Relax's rule (relax_fixed_point), a neighbourhood that
      changed in any sweep, skipped no tile of the 4096² uniform level
      sweep: a level's first call changes nearly every tile there;
    * a tile that runs no sweeps must find its destination (the previous
      call's source) equal to its source: true unless the tile changed in
      the previous call, and then the kernel copies its centre.  The
      change bytes carry over from the previous level's last call, whose
      earlier sweeps may have painted; the level driver copies a merged
      plane into the other buffer.
    """
    src, dst = lab, torch.empty_like(lab) if scratch is None else scratch
    if tiles is None and lab.is_cuda:
        tiles = FloodTiles(flood_plan(*lab.shape, steps), lab.device)
    painted, first = False, True
    while True:
        if tiles is None:
            new, flags = flood_block(img, src, lvl, steps, out=dst)
            f, skipped = flags.tolist(), 0
        else:
            new, flags = flood_block_kernel(img, src, lvl, steps, out=dst, tiles=tiles, first=first)
            *f, skipped, copied = tiles.flags.tolist()
            _ext.launches["flood_tiles_skipped"] += skipped
            _ext.launches["flood_tiles_copied"] += copied
        if on_call is not None:
            on_call(src, new, flags, skipped)
        first = False
        src, dst = new, src
        painted |= bool(f[PAINTED])
        if not f[NOT_CONVERGED]:
            return src, dst, painted


def make_sweep_fn(steps: int = DEFAULT_STEPS):
    """A ``sweep_fn(img, labels, lvl)`` for ``set_sweep_impl`` and the
    unpadded drivers: ``steps`` sweeps in one flood_block call, which
    equals ``flood_sweep`` iterated ``steps`` times."""

    def sweep(img, labels, lvl):
        lab = labels.to(torch.int32).contiguous()
        return flood_block(flood_image(img), lab, int(lvl), steps)[0]

    return sweep
