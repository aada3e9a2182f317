"""The relax kernel's launch plan and its quiet-tile skipping
(csrc/relax.cu, ops/relax.py), on the CPU.

* The plan: the centre tile is the window less ``steps`` cells on each side,
  the grid covers the plane, the block fits the kernel's launch bounds, and
  skipping is allowed only when a call's dependency cone stays inside the 8
  neighbour tiles.
* The rule (``quiet_tiles``): which tiles a call may skip, from the previous
  call's per-tile flags, on the plane's edge and inside.
* A plain model of the skipping fixed point: per call, the tiles the rule
  lets run take the twin's output and write their partials; the skipped
  ones keep what the destination buffer holds.  It must equal the twin's
  fixed point call by call (planes, flags, statistics reduced from the
  per-tile partials), which is what makes the kernel's skipping exact.
"""

import numpy as np
import pytest
import torch

from rustronomy_watershed_tpu_torch.constants import _INF
from rustronomy_watershed_tpu_torch.ops import relax
from rustronomy_watershed_tpu_torch.ops.pack import pack_domain, pack_plain

torch.set_num_threads(1)


@pytest.mark.parametrize("steps", [1, 8, 13, 16, 27, 45, 63])
@pytest.mark.parametrize("shape", [(5, 7), (4096, 4096), (16384, 16384), (300, 18440)])
def test_relax_plan(shape, steps):
    h, w = shape
    plan = relax.relax_plan(h, w, steps)
    window_y = plan["warps"] * plan["rows"]
    assert (plan["tile_y"], plan["tile_x"]) == (window_y - 2 * steps, 128 - 2 * steps)
    gy, gx = plan["grid"]
    assert (gy - 1) * plan["tile_y"] < h <= gy * plan["tile_y"] and (gx - 1) * plan["tile_x"] < w <= gx * plan["tile_x"]
    assert plan["n_tiles"] == gy * gx
    # The block fits the kernel's launch bounds (registers a thread) and
    # its row exchange one block's shared memory.
    assert plan["threads"] == 32 * plan["warps"] <= relax._MAX_THREADS and plan["rows"] == 8
    assert plan["smem"] == 2 * plan["warps"] * 4 * 128 * 4 <= 232448 - 64
    assert plan["skip"] == (steps <= min(plan["tile_y"], plan["tile_x"]))


def test_relax_plan_at_default_steps():
    plan = relax.relax_plan(4096, 4096, relax.DEFAULT_STEPS)
    assert plan["skip"] and plan["tile_x"] == 112 and plan["tile_y"] >= 64
    assert not relax.relax_plan(64, 64, 45)["skip"]  # steps past the tile: every tile runs


@pytest.mark.parametrize("steps", [0, 64, 200])
def test_relax_plan_refuses_steps_without_a_centre(steps):
    with pytest.raises(ValueError, match="steps"):
        relax.relax_plan(100, 100, steps)


@pytest.mark.parametrize("rows,warps", [(8, 17), (4, 25), (5, 8), (8, 0)])
def test_relax_plan_refuses_blocks_past_the_launch_bounds(monkeypatch, rows, warps):
    monkeypatch.setattr(relax, "_STRIP_ROWS", rows)
    monkeypatch.setattr(relax, "_WARPS", warps)
    with pytest.raises(ValueError, match="no relax kernel"):
        relax.relax_plan(100, 100, 8)


def _changed(shape, hot, value=1):
    c = torch.zeros(shape, dtype=torch.int32)
    for y, x in hot:
        c[y, x] = value
    return c


@pytest.mark.parametrize(
    "hot,busy",
    [
        ([], set()),
        ([(2, 3)], {(y, x) for y in (1, 2, 3) for x in (2, 3, 4)}),
        ([(0, 0)], {(0, 0), (0, 1), (1, 0), (1, 1)}),  # a corner: the neighbours outside do not exist
        ([(4, 6)], {(3, 5), (3, 6), (4, 5), (4, 6)}),  # the far corner
        ([(0, 3), (4, 0)], {(0, 2), (0, 3), (0, 4), (1, 2), (1, 3), (1, 4), (3, 0), (3, 1), (4, 0), (4, 1)}),
    ],
)
def test_quiet_tiles(hot, busy):
    quiet = relax.quiet_tiles(_changed((5, 7), hot))
    assert quiet.shape == (5, 7) and quiet.dtype == torch.bool
    assert {(y, x) for y in range(5) for x in range(7) if not quiet[y, x]} == busy


def test_quiet_tiles_treats_skipped_as_unchanged():
    assert relax.quiet_tiles(_changed((3, 3), [(1, 1)], value=2)).all()
    assert relax.quiet_tiles(_changed((1, 1), [])).all() and not relax.quiet_tiles(_changed((1, 1), [(0, 0)])).any()


def _tile_slices(shape, ty, tx):
    h, w = shape
    for i in range(-(-h // ty)):
        for j in range(-(-w // tx)):
            yield (i, j), (slice(i * ty, min(h, (i + 1) * ty)), slice(j * tx, min(w, (j + 1) * tx)))


def _partials(key, lab, ys, xs, unclaimed):
    """A tile's [sat, unclaimed interior, claimed border, least claimed
    interior label], as csrc/relax.cu writes them."""
    h, w = key.shape
    rows = torch.arange(h)[ys, None]
    cols = torch.arange(w)[None, xs]
    interior = (rows >= 1) & (rows <= h - 2) & (cols >= 1) & (cols <= w - 2)
    k, l = key[ys, xs], lab[ys, xs]
    claimed = l != 0
    return [
        int(((k < unclaimed) & ~claimed).any()), int((interior & ~claimed).sum()),
        int((~interior & claimed).any()), int(torch.where(interior & claimed, l, _INF).min()),
    ]


def skipping_fixed_point_model(v, key, lab, steps, tile, stats):
    """The kernel's skipping fixed point in plain PyTorch: each call runs the
    tiles ``quiet_tiles`` lets run (the twin's output, sweep by sweep for the
    per-tile change flags) and leaves the rest of the destination buffer as
    it is.  Returns the planes, each call's flags and the tiles each call
    skipped; asserts on the way that a skipped tile's destination already holds
    the twin's output."""
    ty, tx = tile
    _, _, unclaimed = relax._key_consts(None)
    gy, gx = -(-key.shape[0] // ty), -(-key.shape[1] // tx)
    src = (key, lab)
    dst = (torch.full_like(key, -7), torch.full_like(lab, -7))  # the kernel's fresh buffers: garbage
    chg_prev, part = None, torch.zeros((gy, gx, 4), dtype=torch.int64)
    skips, calls = [], []
    while True:
        # Every sweep of the call, for the tiles' change flags.
        planes = [src]
        for _ in range(steps):
            planes.append(relax.relax_block_plain(v, *planes[-1], 1)[:2])
        out_k, out_l = planes[-1]
        run = torch.ones((gy, gx), dtype=torch.bool) if chg_prev is None else ~relax.quiet_tiles(chg_prev)
        chg = torch.full((gy, gx), 2, dtype=torch.int32)
        any_c = last_c = False
        for (i, j), (ys, xs) in _tile_slices(key.shape, ty, tx):
            moved = [bool(((a[0][ys, xs] != b[0][ys, xs]) | (a[1][ys, xs] != b[1][ys, xs])).any())
                     for a, b in zip(planes, planes[1:])]
            if run[i, j]:
                dst[0][ys, xs], dst[1][ys, xs] = out_k[ys, xs], out_l[ys, xs]
                chg[i, j] = int(any(moved))
                any_c, last_c = any_c or any(moved), last_c or moved[-1]
                part[i, j] = torch.tensor(_partials(*dst, ys, xs, unclaimed))
            else:
                assert not any(moved)
                assert torch.equal(dst[0][ys, xs], out_k[ys, xs]) and torch.equal(dst[1][ys, xs], out_l[ys, xs])
        p = part.reshape(-1, 4)
        flags = [int(any_c), int(last_c), int(p[:, 0].any())]
        if stats:
            flags += [int(p[:, 1].sum()), int(p[:, 2].any()), int(p[:, 3].min())]
        skips.append(int((~run).sum()))
        calls.append(flags)
        src, dst, chg_prev = dst, src, chg
        if not last_c:
            return src, calls, skips


def _model_field(kind, shape):
    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, 254, shape).astype(np.uint8)
    if kind == "dots":
        img[rng.random(shape) < 0.1] = 255
    v, key, lab, _ = pack_plain(torch.from_numpy(img))
    if kind == "border seed":
        lab0 = lab.clone()
        lab0[0, shape[1] // 3] = int(lab.max()) + 1
        v, key, lab = pack_domain(torch.from_numpy(img), lab0)
    return v, key, lab


@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("kind", ["dense", "dots", "border seed"])
def test_skipping_model_equals_twin_fixed_point(kind, stats):
    """Tiles of 12 x 16 at 4 steps on a 150 x 170 field (13 x 11 tiles, so
    that quiet ones appear early): every call's flags, the statistics from
    the per-tile partials, the calls and the fixed point equal the twin's."""
    v, key, lab = _model_field(kind, (150, 170))
    want_calls = []
    want = relax.relax_fixed_point(v, key.clone(), lab.clone(), steps=4, stats=stats,
                                   on_call=lambda s, d, f, n: want_calls.append(f.tolist()))
    (k, l), calls, skips = skipping_fixed_point_model(v, key.clone(), lab.clone(), 4, (12, 16), stats)
    assert torch.equal(k, want[0]) and torch.equal(l, want[1])
    assert calls == want_calls
    flags = calls[-1]
    assert skips[0] == 0 and sum(skips) > 0  # the rule does skip, and stays exact
    if stats:
        assert (flags[relax.N_UNCL], bool(flags[relax.ANY_BORDER]), flags[relax.GMIN]) == want[3]
    assert bool(flags[relax.SAT]) == want[2]


def test_skipping_model_on_the_kernel_geometry():
    """The plan's own tiles at the default steps, on a plane of 3 x 4
    tiles with a hole to refill (several calls) in one corner tile."""
    plan = relax.relax_plan(230, 400, relax.DEFAULT_STEPS)
    assert plan["grid"] == (3, 4)
    v, key, lab = _model_field("dense", (230, 400))
    key, lab, _ = relax.relax_fixed_point(v, key, lab)
    key, lab = key.clone(), lab.clone()
    key[10:56, 350:396], lab[10:56, 350:396] = relax._key_consts(None)[2], 0
    want_calls = []
    want = relax.relax_fixed_point(v, key.clone(), lab.clone(), stats=True,
                                   on_call=lambda s, d, f, n: want_calls.append(f.tolist()))
    (k, l), calls, skips = skipping_fixed_point_model(
        v, key, lab, relax.DEFAULT_STEPS, (plan["tile_y"], plan["tile_x"]), True
    )
    assert torch.equal(k, want[0]) and torch.equal(l, want[1]) and calls == want_calls
    flags = calls[-1]
    assert (flags[relax.N_UNCL], bool(flags[relax.ANY_BORDER]), flags[relax.GMIN]) == want[3]
    assert len(skips) >= 3 and skips[1] == 8  # only the corner tile's 2 x 2 block runs


# -- The skip rule on a mesh ---------------------------------------------------
#
# A 1 x 2 mesh emulated in one process: each rank holds its (h + 2k, w + 2k)
# planes, a round is one call of k sweeps per rank (its flags over the
# centre rectangle), then the halo refresh writes the other rank's centre
# (and the off-grid fill) into the halo band, as parallel/tiled.py does.  The
# refresh writes into the planes between calls, which breaks the premise of
# the quiet-tile rule (the ping-pong with no outside writes).


def _model_call(v, src, dst, steps, tile, run, ctr):
    """One call of the kernel's tile model: the tiles in ``run`` take the
    twin's output and report whether they changed; the others keep what
    ``dst`` holds.  Returns ``(dst, chg, last)`` with ``last`` the
    last-sweep change over the centre rectangle of the tiles that ran."""
    planes = [src]
    for _ in range(steps):
        planes.append(relax.relax_block_plain(v, *planes[-1], 1)[:2])
    out = planes[-1]
    ty, tx = tile
    y0, y1, x0, x1 = ctr
    gy, gx = -(-src[0].shape[0] // ty), -(-src[0].shape[1] // tx)
    chg = torch.full((gy, gx), 2, dtype=torch.int32)
    inside = torch.zeros(src[0].shape, dtype=torch.bool)
    inside[y0:y1, x0:x1] = True
    last = False
    for (i, j), (ys, xs) in _tile_slices(src[0].shape, ty, tx):
        if not run[i, j]:
            continue
        dst[0][ys, xs], dst[1][ys, xs] = out[0][ys, xs], out[1][ys, xs]
        moved = [((a[0] != b[0]) | (a[1] != b[1]))[ys, xs] for a, b in zip(planes, planes[1:])]
        chg[i, j] = int(any(bool(m.any()) for m in moved))
        last = last or bool((moved[-1] & inside[ys, xs]).any())
    return dst, chg, last


def mesh_model(img, lab0, k, tile, skip):
    """The 1 x 2 mesh's round loop (witness + halo stability) with the
    quiet-tile rule on (``skip``: each rank runs the tiles whose 3 x 3
    neighbourhood changed in its previous call) or off (every tile runs).
    Returns the labels, the rounds, and how many times a refresh changed
    a halo cell of a tile that the rank's next call skipped."""
    _, _, unclaimed = relax._key_consts(None)
    v, key, lab = pack_domain(torch.from_numpy(img), torch.from_numpy(lab0))
    h, w2 = key.shape
    w = w2 // 2
    pad = lambda t, fill: torch.nn.functional.pad(t, (k, k, k, k), value=fill)  # noqa: E731
    gv, gkey, glab = pad(v, 255), pad(key, unclaimed), pad(lab, 0)
    cols = [slice(r * w, r * w + w + 2 * k) for r in range(2)]
    vs = [gv[:, c].clone() for c in cols]
    src = [(gkey[:, c].clone(), glab[:, c].clone()) for c in cols]
    dst = [(torch.full_like(s[0], -7), torch.full_like(s[1], -7)) for s in src]
    ctr = (k, k + h, k, k + w)
    halo = torch.ones(src[0][0].shape, dtype=torch.bool)
    halo[k : k + h, k : k + w] = False
    ty, tx = tile
    chg_prev = [None, None]
    need, rounds, missed = [True, True], 0, 0
    strips = [None, None]  # the halo band each rank received last

    def refresh():
        """Write the halo bands; per rank, where the incoming strips differ
        from the previous round's (not from the in-plane halo, which the
        sweeps moved)."""
        whole = [torch.cat([s[i][k : k + h, k : k + w] for s in src], dim=1) for i in (0, 1)]
        whole = [pad(whole[0], unclaimed), pad(whole[1], 0)]
        moved = []
        for r in range(2):
            new = [p[:, cols[r]][halo] for p in whole]
            old = strips[r] or new
            moved.append(torch.zeros(halo.shape, dtype=torch.bool).masked_scatter_(
                halo, (new[0] != old[0]) | (new[1] != old[1])))
            strips[r] = new
            for i in (0, 1):
                src[r][i][halo] = new[i]
        return moved

    refresh()
    while True:
        rounds += 1
        last = [False, False]
        for r in range(2):
            if not need[r]:
                continue
            gy, gx = -(-src[r][0].shape[0] // ty), -(-src[r][0].shape[1] // tx)
            run = torch.ones((gy, gx), dtype=torch.bool)
            if skip and chg_prev[r] is not None:
                run = ~relax.quiet_tiles(chg_prev[r])
            out, chg_prev[r], last[r] = _model_call(vs[r], src[r], dst[r], k, tile, run, ctr)
            src[r], dst[r] = out, src[r]
        moved = refresh()
        for r in range(2):
            if skip and chg_prev[r] is not None:
                quiet = relax.quiet_tiles(chg_prev[r])
                for (i, j), (ys, xs) in _tile_slices(moved[r].shape, ty, tx):
                    missed += int(bool(quiet[i, j]) and bool(moved[r][ys, xs].any()))
        need = [last[r] or bool(moved[r].any()) for r in range(2)]
        if not any(need):
            break
    labels = torch.cat([s[1][k : k + h, k : k + w] for s in src], dim=1)
    return labels, rounds, missed


def _twin_labels(img, lab0):
    v, key, lab = pack_domain(torch.from_numpy(img), torch.from_numpy(lab0))
    return relax.relax_fixed_point(v, key, lab, steps=2)[1]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mesh_without_skipping_ends_at_the_twin_fixed_point(seed):
    """The rule taken (skipping off on a mesh of more than one rank): the
    emulated 1 x 2 mesh's labels equal the twin's single-plane fixed point,
    on random fields with seeds on both sides."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 40, (30, 44)).astype(np.uint8)
    lab0 = np.zeros(img.shape, np.int32)
    pts = rng.integers(1, [29, 43], size=(5, 2))
    lab0[pts[:, 0], pts[:, 1]] = np.arange(1, 6)
    labels, rounds, _ = mesh_model(img, lab0, 2, (4, 5), skip=False)
    assert torch.equal(labels, _twin_labels(img, lab0)) and rounds > 2


def test_unmodified_skip_rule_is_not_exact_on_a_mesh():
    """The quiet-tile rule as it stands, on the same mesh: the right rank
    holds no seed, so its first call changes nothing and every tile goes
    quiet; the left seed's claim then arrives through the halo refresh into
    tiles that the rule skips, and the right half is never claimed.  The
    rule with skipping off gets the twin's labels."""
    img = np.full((30, 44), 10, np.uint8)
    lab0 = np.zeros(img.shape, np.int32)
    lab0[15, 5] = 1
    want = _twin_labels(img, lab0)
    assert (want[1:-1, 22:-1] == 1).all()
    labels, _, missed = mesh_model(img, lab0, 2, (4, 5), skip=True)
    assert missed > 0 and not torch.equal(labels, want)
    assert (labels[:, 22:] == 0).all()
    assert torch.equal(mesh_model(img, lab0, 2, (4, 5), skip=False)[0], want)
