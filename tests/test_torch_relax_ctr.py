"""The relax kernel's centre rectangle (``ctr=(y0, y1, x0, x1)``), on the CPU:
its plain twin against the JAX Pallas relax kernel's ``ctr_cols`` in
interpret mode, the flags against flags recomputed from the planes, and the
whole plane against no rectangle.  Integer planes and flags, tolerance 0.

The JAX band kernel freezes a plane's top and bottom ``steps`` rows (its
aprons) and lets the halo columns evolve; the port's 2-D windows let every
cell evolve.  On planes whose top and bottom ``k`` rows are inert (unclaimed
keys, label 0, NEVER_FILL values) the two coincide: inert cells never
change.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustronomy_watershed_tpu.ops import pallas_relax as jrelax
from rustronomy_watershed_tpu_torch.constants import NEVER_FILL
from rustronomy_watershed_tpu_torch.ops import relax
from rustronomy_watershed_tpu_torch.ops.pack import pack_domain, pack_plain

torch.set_num_threads(1)


def _mesh_plane(h, w, k, seed, sweeps=0, n_seeds=6):
    """A tile's ``(h + 2k, w + 2k)`` planes as a mesh rank holds them: a
    random field with seeds over the whole plane, relaxed ``sweeps`` sweeps
    (so the halo columns hold data of their own), with the top and bottom
    ``k`` rows inert."""
    rng = np.random.default_rng(seed)
    hp, wp = h + 2 * k, w + 2 * k
    img = rng.integers(0, 30, (hp, wp)).astype(np.uint8)
    img[rng.random((hp, wp)) < 0.05] = 255
    lab0 = np.zeros((hp, wp), np.int32)
    pts = rng.integers(0, [hp, wp], size=(n_seeds, 2))
    lab0[pts[:, 0], pts[:, 1]] = np.arange(1, n_seeds + 1)
    v, key, lab = pack_domain(torch.from_numpy(img), torch.from_numpy(lab0))
    if sweeps:
        key, lab, _ = relax.relax_block_plain(v, key, lab, sweeps)
    _, _, unclaimed = relax._key_consts(None)
    for rows in (slice(0, k), slice(k + h, hp)):
        v[rows], key[rows], lab[rows] = NEVER_FILL, unclaimed, 0
    return v, key.clone(), lab.clone()


def _jax_call(v, key, lab, k, tile, w):
    """One all-active pipelined JAX relax_block call with ``ctr_cols=(k, k +
    w)`` on the plane, lane-padded with inert columns (so the lane roll
    wraps onto inert cells, as the port reads the outside).  Returns the
    planes cropped back, the per-band change flags, the witness and sat."""
    hp, wp = key.shape
    lanes = -(-(wp + 1) // 128) * 128  # at least one inert padding column
    _, _, unclaimed = relax._key_consts(None)
    v8 = np.full((hp, lanes), NEVER_FILL - 128, np.int8)
    kp = np.full((hp, lanes), unclaimed, np.int32)
    lp = np.zeros((hp, lanes), np.int32)
    v8[:, :wp] = (v.numpy().astype(np.int32) - 128).astype(np.int8)
    kp[:, :wp], lp[:, :wp] = key.numpy(), lab.numpy()
    gy = (hp - 2 * k) // tile
    jk, jl, jflags, jchg, jsat = jrelax.relax_block(
        jnp.asarray(v8), jnp.asarray(kp), jnp.asarray(lp), jnp.ones((gy,), jnp.int32),
        tile=tile, steps=k, interpret=True, pipelined=True, ctr_cols=(k, k + w),
    )
    return np.asarray(jk)[:, :wp], np.asarray(jl)[:, :wp], np.asarray(jflags), bool(jchg), bool(np.asarray(jsat).any())


@pytest.mark.parametrize("k,h,w,tile", [(1, 8, 21, 8), (3, 16, 19, 8), (8, 16, 60, 8)])
def test_twin_rectangle_matches_jax_ctr_cols(k, h, w, tile):
    """Call by call from the same input planes, for the first calls (the
    JAX kernel takes about a second a call in interpret mode): the centre
    columns of every output plane, the rows of every band whose centre
    changed (the JAX kernel writes back only those; elsewhere its output is
    its input), changed_any, the witness and sat."""
    v, key, lab = _mesh_plane(h, w, k, seed=k * 100 + w, sweeps=1, n_seeds=3)
    ctr = (k, k + h, k, k + w)
    cols = slice(k, k + w)
    for call in range(5):
        k2, l2, flags = relax.relax_block_plain(v, key, lab, k, ctr=ctr)
        jk, jl, jflags, jchg, jsat = _jax_call(v, key, lab, k, tile, w)
        np.testing.assert_array_equal(k2.numpy()[:, cols], jk[:, cols], err_msg=f"call {call}")
        np.testing.assert_array_equal(l2.numpy()[:, cols], jl[:, cols], err_msg=f"call {call}")
        for i, moved in enumerate(jflags):
            rows = slice(k + i * tile, k + (i + 1) * tile)
            if moved:
                np.testing.assert_array_equal(k2.numpy()[rows], jk[rows], err_msg=f"call {call} band {i}")
                np.testing.assert_array_equal(l2.numpy()[rows], jl[rows], err_msg=f"call {call} band {i}")
            else:
                np.testing.assert_array_equal(jk[rows], key.numpy()[rows])
        assert flags.tolist() == [int(jflags.any()), int(jchg), int(jsat)], f"call {call}"
        key, lab = k2, l2
        if not jchg:
            break
    assert call >= 1


def _sweeps_flags(v, key, lab, steps, rect):
    """``[changed_any, changed_last, sat]`` over ``rect``, recomputed from
    the planes of single sweeps of the twin without a rectangle."""
    y0, y1, x0, x1 = rect
    _, _, unclaimed = relax._key_consts(None)
    moved = []
    for _ in range(steps):
        k2, l2, _ = relax.relax_block_plain(v, key, lab, 1)
        moved.append(bool(((k2 != key) | (l2 != lab))[y0:y1, x0:x1].any()))
        key, lab = k2, l2
    sat = bool(((key < unclaimed) & (lab == 0))[y0:y1, x0:x1].any())
    return key, lab, [int(any(moved)), int(moved[-1]), int(sat)]


@pytest.mark.parametrize(
    "rect",
    [(0, 150, 0, 170), (8, 142, 8, 162), (37, 101, 13, 150), (1, 2, 0, 170), (0, 150, 169, 170), (70, 71, 80, 81)],
)
@pytest.mark.parametrize("start", [0, 5, "fixed"])
def test_twin_rectangle_flags_from_planes(rect, start):
    """Rectangles that cut the kernel's 112 x 112 tiles off-centre, thin and
    one-cell ones, from a fresh, a mid and a fixed-point state; the planes
    do not depend on the rectangle."""
    img = np.random.default_rng(3).integers(0, 254, (150, 170)).astype(np.uint8)
    img[np.random.default_rng(4).random(img.shape) < 0.1] = 255
    v, key, lab, _ = pack_plain(torch.from_numpy(img))
    if start == "fixed":
        key, lab, _ = relax.relax_fixed_point(v, key, lab)
    elif start:
        key, lab, _ = relax.relax_block_plain(v, key, lab, start)
    k2, l2, flags = relax.relax_block_plain(v, key, lab, relax.DEFAULT_STEPS, ctr=rect)
    wk, wl, want = _sweeps_flags(v, key, lab, relax.DEFAULT_STEPS, rect)
    assert torch.equal(k2, wk) and torch.equal(l2, wl)
    assert flags.tolist() == want
    if start == "fixed":
        assert want[:2] == [0, 0]


@pytest.mark.parametrize("stats", [False, True])
def test_whole_plane_rectangle_is_no_rectangle(stats):
    img = np.random.default_rng(5).integers(0, 254, (61, 77)).astype(np.uint8)
    v, key, lab, _ = pack_plain(torch.from_numpy(img))
    for steps in (1, 8):
        got = relax.relax_block(v, key, lab, steps, stats=stats, ctr=(0, 61, 0, 77))
        want = relax.relax_block(v, key, lab, steps, stats=stats)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = relax.relax_fixed_point(v, key.clone(), lab.clone(), stats=stats, ctr=(0, 61, 0, 77))
    want = relax.relax_fixed_point(v, key.clone(), lab.clone(), stats=stats)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]) and got[2:] == want[2:]


def test_rectangle_refusals():
    """``stats=True`` with a rectangle raises (no path combines them), and
    so do empty rectangles and rectangles outside the plane, on the twin
    and in the kernel wrapper before any launch."""
    v, key, lab, _ = pack_plain(torch.from_numpy(np.zeros((20, 30), np.uint8)))
    for fn in (relax.relax_block_plain, relax.relax_block_kernel, relax.relax_block):
        with pytest.raises(ValueError, match="stats"):
            fn(v, key, lab, 8, stats=True, ctr=(1, 19, 0, 30))
        for bad in ((5, 5, 0, 30), (0, 21, 0, 30), (-1, 10, 0, 30), (0, 20, 7, 3)):
            with pytest.raises(ValueError, match="rectangle"):
                fn(v, key, lab, 8, ctr=bad)
    with pytest.raises(ValueError, match="tile state"):
        relax.relax_block(v, key, lab, 8, tiles=object())


def test_fixed_point_with_rectangle_stops_on_the_centre():
    """A fixed point whose rectangle leaves out a band of rows that keeps
    changing (a plateau ring moving outwards) stops once the centre is
    quiet, and its planes equal the calls' own."""
    v, key, lab = _mesh_plane(40, 50, 8, seed=9)
    calls = []
    k2, l2, _ = relax.relax_fixed_point(v, key.clone(), lab.clone(), ctr=(8, 48, 8, 58),
                                        on_call=lambda s, d, f, n: calls.append(f.tolist()))
    assert calls[-1][relax.LAST] == 0 and all(c[relax.LAST] for c in calls[:-1])
    k3, l3, f3 = relax.relax_block_plain(v, k2, l2, 8, ctr=(8, 48, 8, 58))
    assert f3.tolist()[relax.ANY] == 0


@pytest.mark.parametrize("rect,fires", [((0, 24, 0, 128), 1), ((8, 16, 8, 16), 1), ((17, 24, 0, 128), 0), ((0, 24, 20, 128), 0)])
def test_saturation_bit_counts_the_rectangle_only(rect, fires):
    """A d field pinned at its maximum (chip_smoke.py phase 4's plane):
    claimed cells with label 0 inside the 8 x 8 plateau; the saturation bit
    sees them only when the rectangle holds some."""
    d_bits = 23
    vs = np.full((24, 128), 255, np.uint8)
    vs[8:16, 8:16] = 5
    ks = np.full((24, 128), 255 << d_bits, np.int32)
    ls = np.zeros((24, 128), np.int32)
    ks[10, 10] = (5 << d_bits) | ((1 << d_bits) - 1)
    ls[10, 10] = 7
    _, _, flags = relax.relax_block_plain(*map(torch.from_numpy, (vs, ks, ls)), 8, d_bits, ctr=rect)
    assert flags.tolist()[relax.SAT] == fires
