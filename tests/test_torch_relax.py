"""Port parity: the relax stage (plain twin of csrc/relax.cu with and without
the merging statistics, the fixed point, the packed transform, the exact
engine) against the JAX Pallas relax kernel in interpret mode and the JAX
exact engine.  Integer outputs, tolerance 0."""

import warnings
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustronomy_watershed_tpu.ops import pallas_relax as jrelax
from rustronomy_watershed_tpu.ops import priority as jprio
from rustronomy_watershed_tpu.ops.seeds import local_extrema_mask as j_mask
from rustronomy_watershed_tpu.ops.seeds import seed_labels_from_mask as j_number
from rustronomy_watershed_tpu_torch import _ext
from rustronomy_watershed_tpu_torch.constants import _D_BITS, _D_MASK, _INF, _UNCLAIMED, NEVER_FILL
from rustronomy_watershed_tpu_torch.convert import planes_from_jax, planes_to_jax_layout
from rustronomy_watershed_tpu_torch.ops import priority, relax
from rustronomy_watershed_tpu_torch.ops.pack import pack_domain, pack_plain
from rustronomy_watershed_tpu_torch.ops.seeds import paint_seeds
from rustronomy_watershed_tpu_torch.prelude import TransformBuilder

torch.set_num_threads(1)


def _seeds_of(img):
    return [tuple(c) for c in np.argwhere(np.asarray(j_mask(jnp.asarray(img))))] or [(2, 2)]


@pytest.mark.parametrize("start_sweeps", [0, 3])
def test_relax_block_plain_matches_jax_relax_block(start_sweeps):
    """One call of the twin == one pipelined all-active JAX relax_block call
    (8 sweeps, tile 8), from a fresh pack state and a mid-relaxation one."""
    img = np.random.default_rng(11).integers(0, 20, size=(30, 37)).astype(np.uint8)
    v, key, lab, _ = pack_plain(torch.from_numpy(img))
    if start_sweeps:
        key, lab, _ = relax.relax_block_plain(v, key, lab, start_sweeps)
    tile = steps = 8
    v_pad, k_pad, l_pad = planes_to_jax_layout(v, key, lab, tile, steps)
    gy = (k_pad.shape[0] - 2 * steps) // tile
    jk, jl, jflags, jchg, jsat = jrelax.relax_block(
        jnp.asarray(v_pad), jnp.asarray(k_pad), jnp.asarray(l_pad), jnp.ones((gy,), jnp.int32),
        tile=tile, steps=steps, interpret=True, pipelined=True,
    )
    want = planes_from_jax(v_pad, jk, jl, steps, steps, *img.shape, device="cpu")
    k2, l2, flags = relax.relax_block_plain(v, key, lab, steps)
    np.testing.assert_array_equal(k2.numpy(), want[1].numpy())
    np.testing.assert_array_equal(l2.numpy(), want[2].numpy())
    want_flags = [int(np.asarray(jflags).any()), int(bool(jchg)), int(np.asarray(jsat).any())]
    assert flags.tolist() == want_flags


@pytest.mark.parametrize("steps", [1, 5])
def test_relax_block_is_steps_sweeps(steps):
    """A call of `steps` sweeps equals `steps` calls of one sweep, flags
    included (changed_any ORs, changed_last is the last sweep's)."""
    img = np.random.default_rng(2).integers(0, 9, size=(17, 23)).astype(np.uint8)
    v, key, lab, _ = pack_plain(torch.from_numpy(img))
    k1, l1, f1 = relax.relax_block(v, key, lab, steps)
    k, l, any_c = key, lab, 0
    for _ in range(steps):
        k, l, f = relax.relax_block(v, k, l, 1)
        any_c |= f[relax.ANY].item()
    np.testing.assert_array_equal(k1.numpy(), k.numpy())
    np.testing.assert_array_equal(l1.numpy(), l.numpy())
    assert f1.tolist() == [any_c, f[relax.LAST].item(), f[relax.SAT].item()]


@pytest.mark.parametrize("shape,hi,maxlvl", [((40, 52), 20, 18), ((24, 24), 4, 3), ((26, 31), 254, 254)])
def test_packed_transform_matches_jax_pallas_and_exact(shape, hi, maxlvl):
    img = np.random.default_rng(shape[0]).integers(0, hi, size=shape).astype(np.uint8)
    lab0 = paint_seeds(shape, _seeds_of(img))
    j_lab, j_L, j_starved = jrelax.relax_transform_pallas(
        jnp.asarray(img), jnp.asarray(lab0), max_water_level=maxlvl, tile=8, steps=8, interpret=True
    )
    labels, key, starved = relax.relax_transform_packed(
        img, lab0, max_water_level=maxlvl, steps=8, device="cpu"
    )
    claim = torch.where(key == _UNCLAIMED, NEVER_FILL + 1, key >> _D_BITS)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(j_lab))
    np.testing.assert_array_equal(claim.numpy(), np.asarray(j_L))
    assert starved is False and bool(j_starved) is False
    e_lab, _ = jprio.relax_transform(jnp.asarray(img), jnp.asarray(lab0), max_water_level=maxlvl)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(e_lab))


@pytest.mark.parametrize("steps", [1, 3, 8, 13])
def test_fixed_point_independent_of_steps(steps):
    img = np.random.default_rng(5).integers(0, 30, size=(33, 29)).astype(np.uint8)
    want, _, _ = relax.relax_transform_packed(img, None, steps=8, device="cpu")
    got, _, _ = relax.relax_transform_packed(img, None, steps=steps, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("maxlvl", [254, 9])
def test_exact_engine_matches_jax_with_border_and_never_fill(maxlvl):
    img = np.random.default_rng(8).integers(0, 20, size=(18, 18)).astype(np.uint8)
    img[7, 7] = 255
    lab0 = paint_seeds(img.shape, [(3, 3), (14, 14), (0, 5), (5, 5), (5, 6)])
    want, want_L = jprio.relax_transform(jnp.asarray(img), jnp.asarray(lab0), max_water_level=maxlvl)
    got, L, n = priority.relax_transform(
        torch.from_numpy(img), torch.from_numpy(lab0), max_water_level=maxlvl, collect_sweeps=True
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    legal = np.asarray(want_L) <= 254  # see ops/priority.py on border claims
    np.testing.assert_array_equal(L.numpy()[legal], np.asarray(want_L)[legal])
    assert n >= 2 and got[7, 7] == 0
    k = 5
    np.testing.assert_array_equal(
        priority.sizes_from_levels(got, L, k, maxlvl).numpy(),
        np.asarray(jprio.sizes_from_levels(want, want_L, k, maxlvl)),
    )


def _saturated_planes():
    """A level-5 plateau with one claimed cell whose d sits at the field max
    (tests/test_priority.py::test_relax_pallas_d_field_saturates...)."""
    v = np.full((24, 128), 255, np.uint8)
    v[8:16, 8:16] = 5
    key = np.full((24, 128), _UNCLAIMED, np.int32)
    lab = np.zeros((24, 128), np.int32)
    key[10, 10] = (5 << _D_BITS) | _D_MASK
    lab[10, 10] = 7
    return v, key, lab


def test_d_field_saturates_instead_of_carrying():
    v, key, lab = _saturated_planes()
    k2, l2, flags = relax.relax_block(*map(torch.from_numpy, (v, key, lab)), 8)
    k2 = k2.numpy()
    claimed = k2 != _UNCLAIMED
    assert claimed[10, 11] and claimed[12, 12]
    assert ((k2[claimed] >> _D_BITS) == 5).all()
    assert ((k2[claimed] & _D_MASK) == _D_MASK).all()
    assert flags[relax.SAT] == 1
    # Same planes through the JAX kernel (they already hold its apron layout:
    # NEVER_FILL / unclaimed / 0 around the plateau).
    jk, jl, _, _, jsat = jrelax.relax_block(
        jnp.asarray((v.astype(np.int32) - 128).astype(np.int8)), jnp.asarray(key), jnp.asarray(lab),
        jnp.ones((1,), jnp.int32), tile=8, steps=8, interpret=True,
    )
    np.testing.assert_array_equal(k2[8:16], np.asarray(jk)[8:16])
    np.testing.assert_array_equal(l2.numpy()[8:16], np.asarray(jl)[8:16])
    assert int(np.asarray(jsat)[0]) == 1


def _serpentine(h=41, w=38, lvl=5):
    img = np.full((h, w), 255, dtype=np.uint8)
    for i, y in enumerate(range(1, h - 1, 2)):
        img[y, 1 : w - 1] = lvl
        if y + 2 < h - 1:
            img[y + 1, w - 2 if i % 2 == 0 else 1] = lvl
    return img


@pytest.mark.parametrize("seeds", [[(1, 1)], [(1, 1), (39, 5), (1, 36)]])
def test_7bit_saturation_falls_back_to_exact_engine(monkeypatch, seeds):
    """tests/test_saturation.py at a 7-bit d field: the public API warns and
    re-runs on the exact engine, whose labels it then returns."""
    monkeypatch.setattr(relax, "_D_BITS", 7)
    img = _serpentine()
    ws = TransformBuilder.default().set_device("cpu").build_segmenting()
    with pytest.warns(RuntimeWarning, match="saturation"):
        got = ws.transform(img, seeds)
    exact = TransformBuilder.default().set_device("cpu").set_backend("relax").build_segmenting()
    np.testing.assert_array_equal(got, exact.transform(img, seeds))
    assert (got[img == 5] > 0).all()


def test_no_saturation_warning_on_normal_fields():
    img = np.random.default_rng(3).integers(0, 60, size=(48, 48)).astype(np.uint8)
    ws = TransformBuilder.default().set_device("cpu").build_segmenting()
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        out = ws.transform(img, ws.find_local_minima(img))
    assert out.max() >= 1


def test_relax_dispatch_and_fixed_point_buffers():
    img = np.random.default_rng(4).integers(0, 12, size=(12, 14)).astype(np.uint8)
    lab0 = torch.from_numpy(paint_seeds(img.shape, [(3, 3), (8, 9)]))
    v, key, lab = pack_domain(torch.from_numpy(img), lab0)
    _ext.reset_launches()
    relax.relax_fixed_point(v, key, lab, steps=2)
    assert _ext.launches["relax_plain"] >= 2 and _ext.launches["relax"] == 0
    assert lab0.tolist() == paint_seeds(img.shape, [(3, 3), (8, 9)]).tolist()
    with pytest.raises(ValueError, match="d_bits"):
        relax.relax_block(v, key, lab, 1, d_bits=24)
    plan = relax.relax_plan(4096, 4096, 8)
    assert (plan["tile_y"], plan["tile_x"]) == (plan["warps"] * plan["rows"] - 16, 112) and plan["skip"]
    assert relax.relax_plan(100, 100, 27)["tile_x"] == 74
    with pytest.raises(ValueError, match="steps"):
        relax.relax_plan(100, 100, 64)


# The JAX merging path's relax (stats-only epilogue), jitted so the fields of
# one shape share a compilation.
_j_stats_fixed_point = jax.jit(
    partial(jrelax.relax_packed_planes, fwd_scan="stats", interpret=True), static_argnames="steps"
)


def _numbered(img):
    return np.array(j_number(j_mask(jnp.asarray(img, jnp.int32))))


def _stats_field(kind, rng):
    if kind == "dense":
        img = rng.integers(0, 254, (48, 64)).astype(np.uint8)
        return img, _numbered(img)
    if kind == "nan_barrier":
        img = rng.integers(0, 200, (48, 64)).astype(np.uint8)
        img[12:36, 30:34] = NEVER_FILL
        return img, _numbered(img)
    if kind == "border_seed":
        img = rng.integers(0, 254, (48, 64)).astype(np.uint8)
        lab0 = _numbered(img)
        lab0[0, 10] = lab0.max() + 1
        return img, lab0
    img = rng.integers(0, 254, (2, 64)).astype(np.uint8)  # no interior
    return img, np.zeros((2, 64), np.int32)


@pytest.mark.parametrize("kind", ["dense", "nan_barrier", "border_seed", "empty_interior"])
def test_relax_stats_match_jax_mstats(rng, kind):
    """The twin's statistics of the fixed point equal the JAX stats-only
    epilogue's where JAX certified in its first call (tests/
    test_component_shortcut.py:47-101)."""
    img, lab0 = _stats_field(kind, rng)
    key_pad, lab_pad, p, col_off, tile, _, y0_valid, mstats, _ = _j_stats_fixed_point(
        jnp.asarray(img, jnp.int32), jnp.asarray(lab0), steps=64
    )
    assert bool(y0_valid)
    p, col_off, tile = int(p), int(col_off), int(tile)
    v_pad = jrelax.pack_domain(img, lab0, tile, p)[0]
    v, key, lab = planes_from_jax(v_pad, key_pad, lab_pad, p, col_off, *img.shape, device="cpu")
    want = tuple(int(m) for m in mstats)
    flags = relax.relax_block_plain(v, key, lab, 1, stats=True)[2].tolist()
    assert flags[relax.LAST] == 0  # the JAX planes are the fixed point
    assert tuple(flags[relax.N_UNCL :]) == want
    # The port's own fixed point, through the driver, gives the same numbers.
    _, _, starved, got = relax.relax_packed_planes(img, lab0, steps=8, device="cpu", stats=True)
    assert (got[0], int(got[1]), got[2]) == want and starved is False
    if kind == "dense":
        assert want == (0, 0, 1)  # row-major numbering: label 1 is the least
    elif kind == "nan_barrier":
        assert want[0] > 0 and want[1] == 0
    elif kind == "border_seed":
        assert want[1] == 1
    else:
        assert want == (0, 0, _INF)
