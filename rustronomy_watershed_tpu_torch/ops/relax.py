"""Packed-key priority relaxation: the segmenting transform on the card.

Counterpart of ``rustronomy_watershed_tpu.ops.pallas_relax``: both its
full-width band kernel and its column-striped kernel for wide images
(``relax_block2d``), which compute one function; the port tiles every width
in 2-D and has no stripe geometry (tests/test_torch_stripes.py holds the
twin against both).  The lexicographic claim key ``(L, d)`` of ops/priority.py
packs into one int32, ``key = L << d_bits | d`` (constants.py), which makes
one Jacobi sweep branch-free:

    best  = min(key, max(ext(min4 kq), vcand))
    ext(a) = min(a + 1, a | d_mask)            # saturating ring increment
    vcand = min((v << d_bits) + 1, unclaimed)  # restart at this pixel's level
    label = min label of 4-neighbours with kq < best, kept when none exists
            or when best is still unclaimed (the claimed-ness gate)

Seeds (key 0) never change, unclaimed neighbours never donate, and no
arithmetic exceeds ``unclaimed + 1 < 2**31`` (pallas_relax.py:352-368).  The
fixed point is unique, so the schedule here may differ from the TPU's while
the labels may not.

Layers: ``relax_block`` (one call = exactly ``steps`` global Jacobi sweeps,
csrc/relax.cu on CUDA tensors, ``relax_block_plain`` on CPU tensors) ->
``relax_fixed_point`` (host loop until a call's last sweep changed nothing;
on the card the calls after the first skip quiet tiles)
-> ``relax_packed_planes`` / ``relax_transform_packed`` (pack + fixed point
+ the ``max_water_level`` mask).

A call's flags are one int32 tensor ``[changed_any, changed_last, sat]``:
any centre cell changed in any sweep / in the last sweep (the fixed-point
witness) / a claimed cell holds label 0 (the d-field saturation signature at
the fixed point, pallas_relax.py:474-498).  The centre is the whole plane,
or the rectangle ``ctr=(y0, y1, x0, x1)`` (rows ``[y0, y1)``, columns
``[x0, x1)``): the counterpart of the TPU kernel's ``ctr_cols=(lo, hi)``,
which a mesh tile's plane needs because its halo cells evolve within a call
and are rewritten by the next halo refresh (parallel/tiled.py).  A call with
``stats=True``
appends the merging shortcut's statistics of its output planes
(pallas_relax.py:575-604; interior = rows 1..h-2, columns 1..w-2, claimed =
label != 0): ``[n_unclaimed_interior, any_claimed_border,
min_claimed_interior_label]``, the last ``_INF`` when no interior cell is
claimed.

A call with ``fwd_scan=True`` (statistics implied) also returns ``y0``, pass
1 of the fine component-min tail on its output label plane: the forward
vertical segmented min scan, 0 a barrier, border columns kept
(``scan_merge.fwd_v_scan``; the TPU kernels' fused-scan epilogue,
pallas_relax.py:541-580 and :1134-1212).  On the card only a call that runs
every tile may emit it: the fixed point's first, which has no previous call
to skip quiet tiles by (``relax_fixed_point(fwd_scan=True)``, the
counterpart of ``relax_fixed_point_fused``).
"""

from __future__ import annotations

import torch

from .. import _ext
from ..constants import _D_BITS, _INF, NEVER_FILL, UNCOLOURED
from ..utils.tracing import span, spanned
from .pack import pack_domain, pack_domain_fused
from .scan_merge import fwd_v_scan
from .stencil import interior_mask, shift4

DEFAULT_STEPS = 8
ANY, LAST, SAT = 0, 1, 2  # indices into a call's flags tensor
N_UNCL, ANY_BORDER, GMIN = 3, 4, 5  # ... and its statistics (stats=True)

_BIG_LAB = 2**30
# The window kernels' launch plan (csrc/relax.cu, csrc/flood.cu): a block is
# one warp of 4-column strips wide (a 128-column window) and _WARPS warps
# deep, each thread holding _STRIP_ROWS rows of its strip in registers;
# their launch bounds allow 512 threads at 8 rows (128 registers a thread).
# A relax block exchanges its strips' top and bottom rows in shared memory:
# 2 sweep parities x 4 rows (key and label, top and bottom) x 128 int32 per
# warp, 64 KB.
_WIN_X = 128
_STRIP_ROWS = 8
_WARPS = 16
_MAX_THREADS = 512


def strip_plan(h: int, w: int, steps: int, kernel: str = "relax") -> dict:
    """The launch geometry of the register-blocked window kernels (the relax
    kernel and csrc/flood.cu): ``rows`` per thread strip, ``warps`` per
    block (``threads``), centre tiles of ``tile_y`` x ``tile_x`` (the
    window less ``steps`` cells on each side), a ``grid`` of ``(gy, gx)``
    tiles, and ``skip``: whether a fixed point may skip quiet tiles (a
    call's dependency cone, steps cells, must stay inside the 8 neighbour
    tiles).  ``kernel`` names the kernel in errors."""
    rows, warps = _STRIP_ROWS, _WARPS
    if rows != 8 or not 1 <= 32 * warps <= _MAX_THREADS:
        raise ValueError(f"no {kernel} kernel for {rows}-row strips in {warps} warps")
    tile_x, tile_y = _WIN_X - 2 * steps, warps * rows - 2 * steps
    if steps < 1 or min(tile_x, tile_y) < 1:
        raise ValueError(f"steps={steps}: a {warps * rows}x{_WIN_X} window takes 1 <= steps < {min(warps * rows, _WIN_X) // 2}")
    grid = (-(-h // tile_y), -(-w // tile_x))
    return {
        "rows": rows, "warps": warps, "threads": 32 * warps, "tile_y": tile_y, "tile_x": tile_x,
        "grid": grid, "n_tiles": grid[0] * grid[1], "skip": steps <= min(tile_y, tile_x),
    }


def relax_plan(h: int, w: int, steps: int) -> dict:
    """The relax kernel's launch: ``strip_plan``'s geometry and ``smem``
    bytes of row exchange."""
    plan = strip_plan(h, w, steps)
    plan["smem"] = 2 * plan["warps"] * 4 * _WIN_X * 4
    return plan


def quiet_tiles(changed):
    """The tiles a call may skip, from the previous call's ``(gy, gx)`` tile
    flags (1: a centre cell changed; 0 or 2: none did): those whose 3x3
    neighbourhood holds no 1.  Plain PyTorch, the rule csrc/relax.cu
    applies per block."""
    hot = torch.nn.functional.pad((changed == 1).to(torch.int8)[None, None], (1, 1, 1, 1))
    near = torch.nn.functional.max_pool2d(hot.float(), 3, stride=1)[0, 0]
    return near == 0


def _key_consts(d_bits):
    """(d_bits, d_mask, unclaimed) — ``_D_BITS`` is read at call time so a
    test can narrow the d field with monkeypatch."""
    d_bits = _D_BITS if d_bits is None else int(d_bits)
    if not 1 <= d_bits <= 23:
        raise ValueError(f"d_bits must be in 1..23, got {d_bits}")
    return d_bits, (1 << d_bits) - 1, NEVER_FILL << d_bits


def _rect(ctr, h: int, w: int, stats: bool):
    """``(y0, y1, x0, x1)`` of the centre rectangle ``ctr`` (the whole
    plane when None); refuses an empty one, one outside the plane, and a
    rectangle that is not the whole plane together with ``stats``."""
    if ctr is None:
        return 0, h, 0, w
    y0, y1, x0, x1 = (int(c) for c in ctr)
    if not (0 <= y0 < y1 <= h and 0 <= x0 < x1 <= w):
        raise ValueError(f"centre rectangle {ctr} is empty or outside the {h}x{w} plane")
    if stats and (y0, y1, x0, x1) != (0, h, 0, w):
        raise ValueError("stats=True takes the whole plane as its centre, not a rectangle")
    return y0, y1, x0, x1


def merge_stats_plain(lab):
    """``[n_unclaimed_interior, any_claimed_border, min_claimed_interior_label]``
    of a label plane, as int32 tensors (see the module docstring)."""
    interior = interior_mask(lab.shape, lab.device)
    claimed = lab != 0
    return [
        (interior & ~claimed).sum(dtype=torch.int32),
        (~interior & claimed).any().to(torch.int32),
        torch.where(interior & claimed, lab, _INF).amin(),
    ]


def _scan_args(stats: bool, ctr, fwd_scan: bool) -> bool:
    """``stats`` as a call runs it: ``fwd_scan`` implies the statistics and
    takes the whole plane, as the TPU kernel's fused epilogue (no
    ``ctr_cols`` beside ``fused_scan``)."""
    if fwd_scan and ctr is not None:
        raise ValueError("fwd_scan=True takes the whole plane as its centre, not a rectangle")
    return stats or fwd_scan


def relax_block_plain(v, key, lab, steps: int, d_bits=None, *, out=None, stats=False, ctr=None, fwd_scan=False):
    """Plain PyTorch twin of the relax kernel: ``steps`` Jacobi sweeps.
    Returns ``(key', lab', flags)``, and ``y0`` after them with
    ``fwd_scan=True``: ``fwd_v`` of ``lab'``, exact for every call."""
    _ext.launches["relax_plain"] += 1
    stats = _scan_args(stats, ctr, fwd_scan)
    d_bits, d_mask, unclaimed = _key_consts(d_bits)
    y0, y1, x0, x1 = _rect(ctr, *key.shape, stats)
    vcand = torch.clamp_max((v.to(torch.int32) << d_bits) + 1, unclaimed)
    any_c = last_c = torch.zeros((), dtype=torch.bool, device=key.device)
    for _ in range(steps):
        kq = shift4(key, unclaimed)
        lq = shift4(lab, 0)
        kmin = torch.minimum(torch.minimum(kq[0], kq[1]), torch.minimum(kq[2], kq[3]))
        ext = torch.minimum(kmin + 1, kmin | d_mask)
        best = torch.minimum(key, torch.maximum(ext, vcand))
        labmin = torch.full_like(lab, _BIG_LAB)
        for k, l in zip(kq, lq):
            labmin = torch.minimum(labmin, torch.where(k < best, l, _BIG_LAB))
        new_lab = torch.where((labmin == _BIG_LAB) | (best == unclaimed), lab, labmin)
        last_c = ((best != key) | (new_lab != lab))[y0:y1, x0:x1].any()
        any_c = any_c | last_c
        key, lab = best, new_lab
    sat = ((key < unclaimed) & (lab == 0))[y0:y1, x0:x1].any()
    flags = [t.to(torch.int32) for t in (any_c, last_c, sat)]
    flags = torch.stack(flags + (merge_stats_plain(lab) if stats else []))
    if out is not None:
        out[0].copy_(key)
        out[1].copy_(lab)
        key, lab = out
    if fwd_scan:
        return key, lab, flags, fwd_v_scan(lab)
    return key, lab, flags


class _Tiles:
    """Tile state of a skipping fixed point on the card: the per-tile change
    flags of the last two calls (ping-pong), the per-tile partials of the
    saturation bit and the statistics, and one flag buffer per call with
    three words after the flags: the count of skipped tiles, then the
    pixels of the centre tiles that ran (clipped to the plane) as a 64-bit
    count, low word first."""

    def __init__(self, plan: dict, n_flags: int, device):
        self.plan, self.n_flags, self.calls = plan, n_flags, 0
        self.chg = torch.zeros((2, plan["n_tiles"]), dtype=torch.int32, device=device)
        self.part = torch.empty((plan["n_tiles"], 4), dtype=torch.int32, device=device)
        self.buf = torch.empty((n_flags + 3,), dtype=torch.int32, device=device)

    def count(self, words: list):
        """``(flags, skipped)`` of the host's read of ``buf`` (a list);
        adds the skipped tiles to ``relax_tiles_skipped``, the pixels run
        to ``relax_px_run``, and the call to ``relax_calls_sparse`` when
        the tiles it ran are fewer than an eighth of the plan's."""
        skipped, lo, hi = words[self.n_flags:]
        _ext.launches["relax_tiles_skipped"] += skipped
        _ext.launches["relax_px_run"] += (hi << 32) | (lo & 0xFFFFFFFF)
        n = self.plan["n_tiles"]
        if 8 * (n - skipped) < n:
            _ext.launches["relax_calls_sparse"] += 1
        return words[: self.n_flags], skipped

    def next_call(self):
        """``(chg_prev or None, chg)`` for the next call: skipping needs the
        previous call's flags and a plan whose tiles hold a call's cone."""
        k, self.calls = self.calls, self.calls + 1
        prev = self.chg[(k + 1) % 2] if k > 0 and self.plan["skip"] else None
        return prev, self.chg[k % 2]


def relax_block_kernel(v, key, lab, steps: int, d_bits=None, *, out=None, stats=False, tiles=None, ctr=None,
                       fwd_scan=False):
    """Launch csrc/relax.cu: ``steps`` Jacobi sweeps of CUDA planes into
    ``out`` (fresh planes when None; never the input planes).  ``tiles``
    (relax_fixed_point's state) lets the call skip the tiles that the
    previous call left quiet, and counts them, and the pixels of the tiles
    that ran, after the flags in ``tiles.buf`` (``_Tiles.count``); a call
    without it runs every pixel, counted here in ``relax_px_run``.
    ``ctr`` limits the flags to a centre rectangle.
    ``fwd_scan=True`` runs the y0 epilogue (counted as ``relax_y0``) and
    returns ``y0`` after the flags; it raises on a call that may skip tiles
    (one with a previous call in ``tiles``)."""
    stats = _scan_args(stats, ctr, fwd_scan)
    d_bits, _, _ = _key_consts(d_bits)
    h, w = key.shape
    rect = _rect(ctr, h, w, stats)
    if v.dtype != torch.uint8 or key.dtype != torch.int32 or lab.dtype != torch.int32:
        raise ValueError("relax kernel takes uint8 v and int32 key/lab planes")
    if v.shape != key.shape or lab.shape != key.shape or key.dim() != 2:
        raise ValueError("relax kernel planes must share one 2-D shape")
    key_out, lab_out = out if out is not None else (torch.empty_like(key), torch.empty_like(lab))
    planes = (v, key, lab, key_out, lab_out)
    if not key.is_cuda or not all(t.is_contiguous() and t.device == key.device for t in planes):
        raise ValueError("relax kernel planes must be contiguous on one CUDA device")
    if any(t.shape != key.shape or t.dtype != key.dtype for t in (key_out, lab_out)):
        raise ValueError("relax kernel output planes must match the int32 input planes")
    if {key_out.data_ptr(), lab_out.data_ptr()} & {key.data_ptr(), lab.data_ptr()}:
        raise ValueError("relax kernel output planes must not alias its inputs")
    if steps < 1:
        raise ValueError("steps must be >= 1")
    n_flags = 6 if stats else 3
    if tiles is None:
        plan = relax_plan(h, w, steps)
        buf = torch.empty((n_flags,), dtype=torch.int32, device=key.device)
        part = torch.empty((plan["n_tiles"], 4), dtype=torch.int32, device=key.device)
        prev = chg = skipped = None
    else:
        plan, buf, part = tiles.plan, tiles.buf, tiles.part
        if tiles.n_flags != n_flags or tuple(plan["grid"]) != relax_plan(h, w, steps)["grid"]:
            raise ValueError("relax tile state does not match this call")
        prev, chg = tiles.next_call()
        skipped = buf[n_flags:]
    y0 = status = None
    if fwd_scan:
        if prev is not None:
            raise ValueError("the y0 epilogue needs a call that runs every tile: the fixed point's first")
        # The look-back's words: a ticket, then one per tile row and column.
        y0 = torch.empty_like(lab)
        status = torch.empty((1 + plan["grid"][0] * w,), dtype=torch.int64, device=key.device)
    vec = w % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in planes[1:]) and v.data_ptr() % 4 == 0
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = _ext.lib().rwt_relax(
        v.data_ptr(), key.data_ptr(), lab.data_ptr(), key_out.data_ptr(), lab_out.data_ptr(),
        buf.data_ptr(), ptr(prev), ptr(chg), part.data_ptr(), ptr(skipped), ptr(y0), ptr(status), h, w, steps, d_bits,
        plan["rows"], plan["warps"], plan["tile_y"], plan["tile_x"], *rect, int(stats), int(vec),
        _ext.stream_ptr(key),
    )
    _ext.check(err, "rwt_relax")
    _ext.launches["relax"] += 1
    _ext.launches["relax_tiles"] += plan["n_tiles"]
    _ext.launches["relax_sweeps"] += steps
    if tiles is None:
        _ext.launches["relax_px_run"] += h * w
    if rect != (0, h, 0, w):
        _ext.launches["relax_ctr"] += 1
    if fwd_scan:
        _ext.launches["relax_y0"] += 1
        return key_out, lab_out, buf[:n_flags], y0
    return key_out, lab_out, buf[:n_flags]


def relax_block(v, key, lab, steps: int, d_bits=None, *, out=None, stats=False, ctr=None, tiles=None,
                fwd_scan=False):
    """One call = exactly ``steps`` global Jacobi sweeps of the packed update.

    CUDA planes launch the kernel, CPU planes run the plain twin.  Returns
    ``(key', lab', flags)`` with flags ``[changed_any, changed_last, sat]``
    over the centre rectangle ``ctr`` (the whole plane when None), plus the
    three statistics with ``stats=True``, and ``y0`` after the flags with
    ``fwd_scan=True``.  ``tiles`` (``_Tiles``, CUDA planes only) lets the
    kernel skip quiet tiles.
    """
    if key.device.type == "cuda":
        return relax_block_kernel(v, key, lab, steps, d_bits, out=out, stats=stats, tiles=tiles, ctr=ctr,
                                  fwd_scan=fwd_scan)
    if key.device.type == "cpu":
        if tiles is not None:
            raise ValueError("tile state is for the kernel's quiet-tile skipping on CUDA planes")
        return relax_block_plain(v, key, lab, steps, d_bits, out=out, stats=stats, ctr=ctr, fwd_scan=fwd_scan)
    raise ValueError(f"unsupported device {key.device}")


@spanned("rwt.driver.relax")
def relax_fixed_point(v, key, lab, *, steps: int = DEFAULT_STEPS, d_bits=None, stats=False, on_call=None, ctr=None,
                      fwd_scan=False):
    """Iterate relax_block until a call's last sweep changed nothing.

    ``key``/``lab`` serve as one of the two ping-pong buffers and are
    overwritten.  Returns ``(key, lab, starved)``; ``starved`` is the
    certifying call's saturation flag.  ``stats=True`` appends the
    certifying call's ``(n_unclaimed_interior, any_claimed_border,
    min_claimed_interior_label)``: its output planes are the fixed point, so
    these are the fixed point's statistics.  The host reads one small flag
    tensor per call.  ``on_call(src, dst, flags, skipped)``, when given,
    sees every call: its input and output planes, its flags and the number
    of tiles it skipped.  ``ctr`` limits every call's flags to a centre
    rectangle.

    ``fwd_scan=True`` (statistics implied, no ``ctr``; JAX's
    ``relax_fixed_point_fused``) runs the first call, which skips no tile,
    with the y0 epilogue and appends ``(y0, y0_valid)``: ``y0`` is ``fwd_v``
    of that call's output labels, and ``y0_valid`` says that the call
    certified the fixed point (its last sweep changed nothing), so that
    ``y0`` is pass 1 of the fine tail on the returned labels
    (``scan_merge.component_min_fine(y0=, y0_valid=)``).

    On the card a call skips the tiles whose 3x3 neighbourhood of tiles
    changed no centre cell in the previous call (``quiet_tiles``), which is
    exact under the ping-pong.  Such a tile's input equals the previous
    call's input on its whole dependency cone, so its output equals the
    previous call's output there, which equals its input (it did not
    change).  The destination buffer is the previous call's source, which
    still holds that input.  A skipped tile adds nothing to the change
    flags (it would change nothing); its saturation bit and statistics are
    the partials it wrote when it last ran, on the same planes.
    """
    stats = _scan_args(stats, ctr, fwd_scan)
    src = (key, lab)
    dst = (torch.empty_like(key), torch.empty_like(lab))
    tiles = None
    if key.is_cuda:
        tiles = _Tiles(relax_plan(*key.shape, steps), 6 if stats else 3, key.device)
    y0 = None
    while True:
        first = fwd_scan and y0 is None
        k2, l2, flags, *y = relax_block(v, *src, steps, d_bits, out=dst, stats=stats, ctr=ctr, tiles=tiles,
                                        fwd_scan=first)
        if tiles is None:
            f, skipped = _ext.host_read(flags), 0
        else:
            f, skipped = tiles.count(_ext.host_read(tiles.buf))
        if first:
            y0, y0_valid = y[0], not f[LAST]
        if on_call is not None:
            on_call(src, (k2, l2), flags, skipped)
        src, dst = (k2, l2), src
        if not f[LAST]:
            out = (k2, l2, bool(f[SAT]))
            if stats:
                out += ((f[N_UNCL], bool(f[ANY_BORDER]), f[GMIN]),)
            if fwd_scan:
                out += (y0, y0_valid)
            return out


def relax_packed_planes(
    img, labels0, *, steps=None, d_bits=None, device="cuda", stats=False, checkpoint=None, fwd_scan=False
):
    """Pack (seeds from ``labels0``, or from the image when it is None) and
    relax to the fixed point.  Returns what relax_fixed_point returns, with
    ``(h, w)`` planes on ``device``: with ``fwd_scan=True`` ``(key, lab,
    starved, (n_unclaimed_interior, any_claimed_border,
    min_claimed_interior_label), y0, y0_valid)``.  ``checkpoint``
    (ops/ckpt_relax.py) may replace the packed planes with a snapshot's and
    sees every call; the fused path has none, as in JAX."""
    if fwd_scan and checkpoint is not None:
        raise ValueError("fwd_scan=True runs without checkpoints, as the JAX package's fused fixed point")
    steps = DEFAULT_STEPS if steps is None else int(steps)
    d_bits, _, _ = _key_consts(d_bits)
    dev = _ext.resolve_device(device)
    with span("rwt.pack"):
        if labels0 is None:
            v, key, lab, _ = pack_domain_fused(img, dev, d_bits=d_bits)
        else:
            img = torch.as_tensor(img).to(dev)
            v, key, lab = pack_domain(img, torch.as_tensor(labels0).to(dev), d_bits=d_bits)
    on_call = None
    if checkpoint is not None:
        key, lab = checkpoint.resume(key, lab)
        on_call = checkpoint.on_call
    return relax_fixed_point(v, key, lab, steps=steps, d_bits=d_bits, stats=stats, on_call=on_call, fwd_scan=fwd_scan)


def relax_transform_packed(
    img, labels0, *, max_water_level: int = 254, steps=None, device="cuda", checkpoint=None
):
    """Full segmenting transform on the packed engine — the counterpart of
    ``pallas_relax.relax_transform_pallas``.  Bit-identical labels to
    ops/priority.relax_transform unless ``starved``.

    Returns ``(labels, key, starved)``; ``key`` is the packed claim key plane
    (claim level ``key >> d_bits``; ``NEVER_FILL << d_bits`` where never
    claimed).
    ``labels0=None`` takes the seeds from the image through the pack kernel.
    """
    d_bits, _, _ = _key_consts(None)
    key, lab, starved = relax_packed_planes(
        img, labels0, steps=steps, d_bits=d_bits, device=device, checkpoint=checkpoint
    )
    if max_water_level >= 254:
        # The claimed-ness gate keeps unclaimed cells at label 0, so the
        # label plane already is the final label image.
        labels = lab
    else:
        # claim level <= max_water_level  <=>  key < (max_water_level + 1) << d_bits;
        # unclaimed keys (NEVER_FILL << d_bits) lie above every such bound.
        labels = torch.where(key < (max_water_level + 1) << d_bits, lab, UNCOLOURED)
    return labels, key, starved
