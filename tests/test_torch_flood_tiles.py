"""The flood kernel's launch plan and its tile skipping (csrc/flood.cu,
ops/flood_block.py), and the coarse broadcast's launch plan
(csrc/coarse_broadcast.cu, ops/scan_merge.py), on the CPU.

* The flood plan: 112 x 112 centre tiles at 8 steps in 128 x 128 windows,
  a grid that covers the plane, skipping only when a call's cone stays in
  the 8 neighbour tiles.
* The run rule (``flood_active_tiles``) and the presence bits
  (``tile_presence``) against NumPy models.
* A plain model of the skipping level sweep: per call it runs the twin only
  on the tiles the rule selects, copies the centre of the tiles that
  changed in the previous call and runs no sweeps, and leaves the rest of
  the destination as it is; it carries the change bytes across levels and
  copies a merged plane into the other buffer.  Held call by call against the non-skipping twin (planes and
  flags) over whole 255-level sweeps, segmenting and merging, and its final
  labels against the port's level sweep and the JAX package's (``'jnp'``,
  and ``'pallas'`` in interpret mode), tolerance 0.
* The broadcast plan and a NumPy model of its int4 route (border folds,
  odd h, w % 4 != 0, w = 3) against ``coarse_broadcast_plain``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustronomy_watershed_tpu.ops.level_driver import run_levels_impl as jax_run_levels
from rustronomy_watershed_tpu_torch import _ext
from rustronomy_watershed_tpu_torch.ops import flood_block
from rustronomy_watershed_tpu_torch.ops import scan_merge as sm
from rustronomy_watershed_tpu_torch.ops.flood import flood_sweep
from rustronomy_watershed_tpu_torch.ops.histogram import value_histogram
from rustronomy_watershed_tpu_torch.ops.level_driver import run_levels_impl
from rustronomy_watershed_tpu_torch.ops.merge import merge_touching
from rustronomy_watershed_tpu_torch.ops.seeds import local_extrema_mask, seed_labels_from_mask
from torch_fields import plateau, poisson_u8

torch.set_num_threads(1)


@pytest.mark.parametrize("steps", [1, 4, 8, 13, 56, 63])
@pytest.mark.parametrize("shape", [(1, 9), (5, 7), (4096, 4096), (1023, 1031), (16384, 16384)])
def test_flood_plan(shape, steps):
    h, w = shape
    plan = flood_block.flood_plan(h, w, steps)
    assert (plan["tile_y"], plan["tile_x"]) == (plan["warps"] * plan["rows"] - 2 * steps, 128 - 2 * steps)
    gy, gx = plan["grid"]
    assert (gy - 1) * plan["tile_y"] < h <= gy * plan["tile_y"] and (gx - 1) * plan["tile_x"] < w <= gx * plan["tile_x"]
    assert plan["n_tiles"] == gy * gx and gy <= 65535
    assert plan["threads"] == 32 * plan["warps"] <= 512 and plan["rows"] == 8
    # Row exchange and staged image masks fit one block's shared memory
    # with the kernel's static word.
    assert plan["smem"] == plan["warps"] * (2 * 2 * 128 * 4 + 8 * 9 * 4) <= 232448 - 64
    assert plan["skip"] == (steps <= min(plan["tile_y"], plan["tile_x"]))


def test_flood_plan_at_default_steps():
    plan = flood_block.flood_plan(4096, 4096, flood_block.DEFAULT_STEPS)
    assert plan["skip"] and (plan["tile_y"], plan["tile_x"]) == (112, 112) and plan["grid"] == (37, 37)
    assert not flood_block.flood_plan(64, 64, 45)["skip"]  # steps past the tile: every tile runs


@pytest.mark.parametrize("steps", [0, 64, 200])
def test_flood_plan_refuses_steps_without_a_centre(steps):
    with pytest.raises(ValueError, match="steps"):
        flood_block.flood_plan(100, 100, steps)


def _presence_model(img, ty, tx):
    h, w = img.shape
    gy, gx = -(-h // ty), -(-w // tx)
    out = np.zeros((gy * gx, 32), np.uint8)
    for y in range(h):
        for x in range(w):
            v = int(img[y, x])
            out[(y // ty) * gx + x // tx, v // 8] |= 1 << (v % 8)
    return out


@pytest.mark.parametrize("shape,tile", [((23, 31), (5, 7)), ((40, 56), (6, 8)), ((9, 9), (112, 112)), ((1, 1), (3, 3))])
def test_tile_presence(shape, tile):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape).astype(np.uint8)
    plan = {"tile_y": tile[0], "tile_x": tile[1], "grid": (-(-shape[0] // tile[0]), -(-shape[1] // tile[1]))}
    got = flood_block.tile_presence(torch.from_numpy(img), plan)
    assert got.dtype == torch.uint8 and got.shape == (plan["grid"][0] * plan["grid"][1], 32)
    np.testing.assert_array_equal(got.numpy(), _presence_model(img, *tile))


def _changed(shape, hot, value=flood_block.CHANGED | flood_block.CHANGED_LAST):
    c = torch.zeros(shape, dtype=torch.int32)
    for y, x in hot:
        c[y, x] = value
    return c


def _presence_with(shape, lvl, tiles):
    p = torch.zeros((shape[0] * shape[1], 32), dtype=torch.uint8)
    p[:, (lvl + 1) % 256 // 8] = 0xFF  # every tile holds another value
    p[:, lvl // 8] &= ~(1 << (lvl % 8)) & 0xFF
    for y, x in tiles:
        p[y * shape[1] + x, lvl // 8] |= 1 << (lvl % 8)
    return p


def _neighbourhoods(shape, tiles):
    return {(y + dy, x + dx) for y, x in tiles for dy in (-1, 0, 1) for dx in (-1, 0, 1)
            if 0 <= y + dy < shape[0] and 0 <= x + dx < shape[1]}


@pytest.mark.parametrize("lvl", [0, 7, 8, 200, 255])
@pytest.mark.parametrize(
    "hot,present",
    [([], []), ([(2, 3)], []), ([], [(0, 0)]), ([(4, 6)], [(0, 3), (2, 2)]), ([(0, 0), (4, 6)], [(4, 0)])],
)
def test_flood_active_tiles(hot, present, lvl):
    """Later calls run the 3 x 3 neighbourhoods of the tiles changed in the
    previous call's last sweep; a level's first call also those of the
    tiles holding a pixel of the level (bit lvl of the presence bits, no
    other bit)."""
    shape = (5, 7)
    changed, presence = _changed(shape, hot), _presence_with(shape, lvl, present)
    later = flood_block.flood_active_tiles(changed, presence, lvl, False)
    first = flood_block.flood_active_tiles(changed, presence, lvl, True)
    assert later.shape == first.shape == shape and later.dtype == torch.bool
    assert {(y, x) for y in range(5) for x in range(7) if later[y, x]} == _neighbourhoods(shape, hot)
    assert {(y, x) for y in range(5) for x in range(7) if first[y, x]} == _neighbourhoods(shape, hot + present)


def test_flood_active_tiles_ignores_changes_before_the_last_sweep():
    p = torch.zeros((9, 32), dtype=torch.uint8)
    assert not flood_block.flood_active_tiles(_changed((3, 3), [(1, 1)], value=flood_block.CHANGED), p, 5, True).any()


def test_flood_tiles_next_call():
    """A standalone fixed point's first call runs every tile; a level
    sweep's first call (presence bits) and every later call read the
    previous call's change bytes; a plan past its tiles never skips."""
    plan = flood_block.flood_plan(300, 300, 8)
    alone = flood_block.FloodTiles(plan, "cpu")
    prev, chg = alone.next_call(True)
    assert prev is None and chg.data_ptr() == alone.chg[0].data_ptr()
    prev, chg = alone.next_call(False)
    assert prev.data_ptr() == alone.chg[0].data_ptr() and chg.data_ptr() == alone.chg[1].data_ptr()
    sweep = flood_block.FloodTiles(plan, "cpu", presence=torch.zeros((plan["n_tiles"], 32), dtype=torch.uint8))
    prev, chg = sweep.next_call(True)
    assert prev.data_ptr() == sweep.chg[1].data_ptr() and not prev.any()
    wide = flood_block.FloodTiles(flood_block.flood_plan(300, 300, 45), "cpu")
    assert wide.next_call(False)[0] is None


def _tile_any(x, ty, tx):
    """(gy, gx) bool: some cell of each tile of ``x`` is True."""
    h, w = x.shape
    gy, gx = -(-h // ty), -(-w // tx)
    p = torch.zeros((gy * ty, gx * tx), dtype=torch.bool)
    p[:h, :w] = x
    return p.view(gy, ty, gx, tx).any(3).any(1)


def skipping_level_sweep_model(img, lab0, *, steps, tile, merging, n_labels):
    """The card's level sweep in plain PyTorch: per call, the tiles that
    ``flood_active_tiles`` selects take the twin's output and write their
    change bytes; of the others, those that changed in the previous call
    copy their source, and the rest keep what the destination buffer
    holds.  The change bytes carry across levels, and after a merge the
    merged plane is copied into the other buffer.  Asserts call by call
    that the output buffer equals the twin's call on the same input (planes
    and flags), which is what makes the skipping exact.  Returns the final
    labels, the tiles each call ran no sweeps on and the tiles it copied."""
    img_t = torch.from_numpy(img)
    img_eff = flood_block.flood_image(img_t)
    (h, w), (ty, tx) = img.shape, tile
    plan = {"tile_y": ty, "tile_x": tx, "grid": (-(-h // ty), -(-w // tx))}
    presence = flood_block.tile_presence(img_eff, plan)
    src, dst = lab0.clone(), lab0.clone()
    chg_prev = torch.zeros(plan["grid"], dtype=torch.int32)
    vhist = value_histogram(img_t).tolist()
    skips, copies = [], []
    for lvl in range(255):
        if lvl > 0 and vhist[lvl] == 0:
            continue
        first, painted = True, False
        while True:
            want, want_flags = flood_block.flood_block_plain(img_eff, src, lvl, steps)
            before_last = src
            for _ in range(steps - 1):
                before_last = flood_sweep(img_eff, before_last, lvl, mask=True)
            run = flood_block.flood_active_tiles(chg_prev, presence, lvl, first)
            copy = ((chg_prev & flood_block.CHANGED) != 0) & ~run
            changed = _tile_any(want != src, ty, tx)
            last = _tile_any(want != before_last, ty, tx)
            assert not (changed & ~run).any(), "a tile that ran no sweeps would have changed"
            cells = (run | copy).repeat_interleave(ty, 0).repeat_interleave(tx, 1)[:h, :w]
            dst = torch.where(cells, want, dst)  # a copied tile's output is its source
            assert torch.equal(dst, want), "the skipped tiles' buffer is out of sync"
            flags = [int((changed & run).any()), int((last & run).any())]
            assert flags == want_flags.tolist()
            chg_prev = torch.where(run, changed.to(torch.int32) | last.to(torch.int32) << 1, 0)
            skips.append(int((~run).sum()))
            copies.append(int(copy.sum()))
            src, dst = dst, src
            first = False
            painted |= bool(flags[0])
            if not flags[1]:
                break
        if merging and (painted or lvl == 0):
            src = merge_touching(src, n_labels)
            dst = src.clone()
    return src, skips, copies


def _sweep_field(kind, shape=(40, 56)):
    rng = np.random.default_rng(31)
    if kind == "poisson":
        return poisson_u8(shape)
    if kind == "plateau":
        return plateau(shape, 2)
    img = rng.integers(0, 254, shape).astype(np.uint8)
    if kind == "dots":
        img[rng.random(shape) < 0.1] = 255
    return img


CASES = [  # field, shape, (tile, steps): steps == the tile edge is the rule's limit
    ("uniform", (40, 56), ((6, 8), 4)), ("dots", (40, 56), ((6, 8), 4)), ("plateau", (40, 56), ((6, 8), 4)),
    ("poisson", (40, 56), ((6, 8), 4)), ("poisson", (40, 56), ((5, 7), 5)), ("uniform", (37, 53), ((5, 7), 5)),
]


@pytest.mark.parametrize("merging", [False, True])
@pytest.mark.parametrize("kind,shape,geometry", CASES, ids=[f"{k}-{s[0]}x{s[1]}-t{g[0][0]}s{g[1]}" for k, s, g in CASES])
def test_skipping_level_sweep_model(kind, shape, geometry, merging):
    """The skipping model over a whole 255-level sweep equals the twin call
    by call (asserted inside), skips tiles, and its final labels equal the
    port's level sweep and the JAX 'jnp' level sweep."""
    img = _sweep_field(kind, shape)
    lab0 = seed_labels_from_mask(local_extrema_mask(torch.from_numpy(img)))
    n = int(lab0.max())
    tile, steps = geometry
    got, skips, copies = skipping_level_sweep_model(img, lab0, steps=steps, tile=tile, merging=merging, n_labels=n)
    assert sum(skips) > 0 and sum(copies) > 0
    want = run_levels_impl(torch.from_numpy(img), lab0, n_labels=n, max_water_level=254, merging=merging,
                           backend="flood", steps=steps, device="cpu")
    assert torch.equal(got, want)
    jax_want = jax_run_levels(jnp.asarray(img), jnp.asarray(lab0.numpy()), n_labels=n, max_water_level=254,
                              merging=merging, backend="jnp")
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_want))


@pytest.mark.parametrize("merging", [False, True])
def test_skipping_model_against_pallas_level_sweep(merging):
    """The Poisson field's final labels against the JAX package's Pallas
    level sweep in interpret mode (its band activity on)."""
    img = _sweep_field("poisson")
    lab0 = seed_labels_from_mask(local_extrema_mask(torch.from_numpy(img)))
    n = int(lab0.max())
    got, _, _ = skipping_level_sweep_model(img, lab0, steps=4, tile=(6, 8), merging=merging, n_labels=n)
    want = jax_run_levels(jnp.asarray(img), jnp.asarray(lab0.numpy()), n_labels=n, max_water_level=254,
                          merging=merging, backend="pallas", tile=8, steps=4, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fixed_point_on_call_sees_every_call():
    """On the CPU ``on_call`` sees every twin call with its input and
    output planes, flags and no skipped tile."""
    img = _sweep_field("poisson")
    fimg = flood_block.flood_image(torch.from_numpy(img))
    lab = seed_labels_from_mask(local_extrema_mask(torch.from_numpy(img)))
    log = []

    def on_call(src, dst, flags, skipped):
        want = flood_block.flood_block_plain(fimg, src, 32, 3)
        assert torch.equal(dst, want[0]) and torch.equal(flags, want[1]) and skipped == 0
        log.append(flags.tolist())

    got, _, painted = flood_block.flood_fixed_point_block(fimg, lab.clone(), 32, steps=3, on_call=on_call)
    assert len(log) >= 2 and log[-1][1] == 0 and painted
    assert torch.equal(got, flood_block.flood_fixed_point_block(fimg, lab.clone(), 32, steps=3)[0])


# -- the coarse broadcast ------------------------------------------------------


@pytest.mark.parametrize(
    "shape,aligned,route",
    [
        ((4096, 4096), True, "vec"), ((1, 4), True, "vec"), ((3, 8), True, "vec"), ((4097, 1028), True, "vec"),
        ((2048, 16384), True, "vec"), ((300000, 8), True, "vec"), ((64, 96), False, "cells"),
        ((1023, 1031), True, "cells"), ((1001, 3), True, "cells"), ((70000, 5), True, "cells"),
    ],
)
def test_broadcast_plan(shape, aligned, route):
    h, w = shape
    plan = sm.broadcast_plan(h, w, aligned)
    assert plan["route"] == route
    gx, gy = plan["grid"]
    assert plan["threads"] % 32 == 0 and 32 <= plan["threads"] <= 256 and 1 <= gy <= 65535
    if route == "vec":
        hc, cols = (h + 1) // 2, w // 4
        assert (gx - 1) * plan["threads"] < cols <= gx * plan["threads"]
        assert (gy - 1) * plan["k_rows"] < hc <= gy * plan["k_rows"] and plan["k_rows"] == max(1, -(-hc // 65535))
    else:
        assert (gx - 1) * plan["threads"] < w <= gx * plan["threads"] and gy == min(h, 65535)
    with pytest.raises(ValueError, match="w >= 3"):
        sm.broadcast_plan(h, 2)


def broadcast_model(c, lab, plan):
    """The broadcast kernels' work as NumPy: on route ``vec`` each thread's
    int4 of each coarse row of its strip, over both fine rows it stands
    for, with the border folds inside the int4; on ``cells`` each thread's
    column down the rows of its grid row.  Checks that every fine cell is
    written exactly once."""
    h, w = lab.shape
    out = np.full((h, w), -1, np.int64)
    hits = np.zeros((h, w), np.int64)
    val = c & ((1 << 24) - 1)
    gx, gy = plan["grid"]
    if plan["route"] == "vec":
        for bx in range(gx):
            x0s = 4 * (bx * plan["threads"] + np.arange(plan["threads"]))
            x0s = x0s[x0s < w]
            for by in range(gy):
                for i in range(by * plan["k_rows"], min(by * plan["k_rows"] + plan["k_rows"], (h + 1) // 2)):
                    for y in range(2 * i, min(2 * i + 2, h)):
                        row_ok = y != 0 and y != h - 1
                        for x0 in x0s:
                            ll = lab[y, x0 : x0 + 4]
                            o = np.where(ll != 0, val[i, x0 : x0 + 4], 0)
                            if x0 == 0:
                                o[0] = min(ll[0], o[1]) if ll[0] != 0 and o[1] != 0 and row_ok else ll[0]
                            if x0 + 4 == w:
                                o[3] = min(ll[3], o[2]) if ll[3] != 0 and o[2] != 0 and row_ok else ll[3]
                            out[y, x0 : x0 + 4] = o
                            hits[y, x0 : x0 + 4] += 1
    else:
        for bx in range(gx):
            for x in range(bx * plan["threads"], min((bx + 1) * plan["threads"], w)):
                for by in range(gy):
                    for y in range(by, h, gy):
                        l_ = lab[y, x]
                        if x in (0, w - 1):
                            nx = 1 if x == 0 else w - 2
                            nb = val[y // 2, nx] if lab[y, nx] != 0 else 0
                            out[y, x] = min(l_, nb) if l_ != 0 and nb != 0 and y not in (0, h - 1) else l_
                        else:
                            out[y, x] = val[y // 2, x] if l_ != 0 else 0
                        hits[y, x] += 1
    assert (hits == 1).all()
    return out


@pytest.mark.parametrize(
    "shape,aligned",
    [((7, 12), True), ((8, 4), True), ((1, 8), True), ((9, 1028), True), ((7, 13), True), ((6, 3), True),
     ((11, 12), False), ((5, 5), True)],
)
def test_broadcast_model_equals_twin(shape, aligned):
    """Odd h (the last coarse row has one fine row), w = 4 (both border
    columns in one int4), w % 4 != 0 and w = 3 (the cell route), an
    unaligned plane (the cell route), on claimed cells with unclaimed
    ones and border columns both claimed and not."""
    h, w = shape
    rng = np.random.default_rng(h * w)
    lab = np.where(rng.random(shape) < 0.3, 0, rng.integers(1, 1 << 24, shape)).astype(np.int32)
    c = sm.coarsen_plain(torch.from_numpy(lab))
    c = (c & ~((1 << 24) - 1)) | torch.from_numpy(rng.integers(1, 1 << 24, tuple(c.shape)).astype(np.int32))
    plan = sm.broadcast_plan(h, w, aligned)
    assert plan["route"] == ("vec" if w % 4 == 0 and aligned else "cells")
    _ext.reset_launches()
    want = sm.coarse_broadcast_plain(c, torch.from_numpy(lab))
    assert _ext.launches["coarse_broadcast_plain"] == 1
    np.testing.assert_array_equal(broadcast_model(c.numpy(), lab, plan), want.numpy())
