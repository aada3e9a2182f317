"""The level-sweep engine of the port against the JAX package: flood sweeps
(ops/flood.py), the flood kernel's plain twin (ops/flood_block.py) against
the Pallas flood kernel in interpret mode, the level-sweep driver
(ops/level_driver.py, backends 'flood' and 'sweep') against the JAX 'jnp'
level sweep, and the sweep counts (ops/diagnostics.py).  Integer planes,
tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustronomy_watershed_tpu.ops import flood as jflood
from rustronomy_watershed_tpu.ops import pallas_flood as jpf
from rustronomy_watershed_tpu.ops import paint_seeds, run_levels
from rustronomy_watershed_tpu.ops.diagnostics import count_fixed_point_iterations as j_count
from rustronomy_watershed_tpu_torch import _ext
from rustronomy_watershed_tpu_torch.ops import flood, flood_block
from rustronomy_watershed_tpu_torch.ops.diagnostics import count_fixed_point_iterations
from rustronomy_watershed_tpu_torch.ops.level_driver import level_step_counted, run_levels_impl

torch.set_num_threads(1)

SEEDS = [(5, 5), (30, 33), (17, 22), (1, 1), (0, 7), (39, 51), (20, 40), (33, 8)]


def _case(seed, shape=(40, 56), hi=40):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, hi, size=shape).astype(np.uint8)
    lab = paint_seeds(shape, [s for s in SEEDS if s[0] < shape[0] and s[1] < shape[1]])
    return img, np.asarray(lab)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("lvl", [0, 12, 39])
def test_sweep_candidates_and_fixed_point_match_jax(lvl):
    img, lab = _case(lvl)
    want_c, want_n, want_any = jflood.flood_candidates(jnp.asarray(img, jnp.int32), jnp.asarray(lab), lvl)
    cand, nmin, any_c = flood.flood_candidates(_t(img), _t(lab), lvl)
    np.testing.assert_array_equal(cand.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(nmin.numpy()[cand.numpy()], np.asarray(want_n)[np.asarray(want_c)])
    assert bool(any_c) == bool(want_any)
    np.testing.assert_array_equal(
        flood.flood_sweep(_t(img), _t(lab), lvl).numpy(),
        np.asarray(jflood.flood_sweep(jnp.asarray(img, jnp.int32), jnp.asarray(lab), lvl)),
    )
    want_fp, want_p = jflood.flood_fixed_point(jnp.asarray(img, jnp.int32), jnp.asarray(lab), lvl)
    got_fp, got_p = flood.flood_fixed_point(_t(img), _t(lab), lvl)
    np.testing.assert_array_equal(got_fp.numpy(), np.asarray(want_fp))
    assert got_p == bool(want_p)


@pytest.mark.parametrize("lvl,steps", [(10, 8), (39, 3)])
def test_flood_block_plain_matches_pallas_kernel_and_k_sweeps(lvl, steps):
    img, lab = _case(7)
    # The Pallas kernel in interpret mode, all bands active, tile 8.
    img_p, lab_p = jpf.pad_domain(img, lab, 8, steps)
    gy = (img_p.shape[0] - 2 * steps) // 8
    a, b, flags, chg = jpf.flood_block(
        img_p, lab_p, lab_p * 1, lvl, jnp.ones((gy,), jnp.int32), jnp.zeros((gy,), jnp.int32),
        tile=8, steps=steps, interpret=True,
    )
    plane = np.asarray(jpf.gather_current(a, b, flags, tile=8, steps=steps))
    want = plane[steps : steps + img.shape[0], steps : steps + img.shape[1]]
    # ... and k plain JAX sweeps.
    k = jnp.asarray(lab)
    for _ in range(steps):
        k = jflood.flood_sweep(jnp.asarray(img, jnp.int32), k, lvl)
    np.testing.assert_array_equal(want, np.asarray(k))

    _ext.reset_launches()
    got, got_flags = flood_block.flood_block(flood_block.flood_image(_t(img)), _t(lab), lvl, steps)
    assert _ext.launches["flood_plain"] == 1 and _ext.launches["flood"] == 0
    np.testing.assert_array_equal(got.numpy(), want)
    painted, not_conv = got_flags.tolist()
    assert painted == int(np.asarray(flags).any())
    assert not_conv == int(bool(chg))


def test_flood_fixed_point_block_and_sweep_fn():
    img, lab = _case(3)
    for lvl in (0, 5, 20):
        want, want_p = jflood.flood_fixed_point(jnp.asarray(img, jnp.int32), jnp.asarray(lab), lvl)
        got, _, painted = flood_block.flood_fixed_point_block(
            flood_block.flood_image(_t(img)), _t(lab).clone(), lvl, steps=4
        )
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert painted == bool(want_p)
        sweep = flood_block.make_sweep_fn(3)
        got2, p2 = flood.flood_fixed_point(_t(img), _t(lab), lvl, sweep_fn=sweep)
        np.testing.assert_array_equal(got2.numpy(), np.asarray(want))
        assert p2 == bool(want_p)
        lab = np.asarray(want)


@pytest.mark.parametrize("maxlvl", [254, 100])
@pytest.mark.parametrize("merging", [False, True])
def test_level_sweep_driver_matches_jax_jnp(merging, maxlvl):
    img, lab = _case(11, hi=254)
    n = len(SEEDS)
    for collect in ("none", "sizes", "history"):
        want = run_levels(
            jnp.asarray(img), jnp.asarray(lab), n_labels=n, max_water_level=maxlvl,
            merging=merging, collect=collect, backend="jnp",
        )
        want = [np.asarray(w) for w in (want if isinstance(want, tuple) else (want,))]
        for backend in ("flood", "sweep"):
            _ext.reset_launches()
            got = run_levels_impl(
                _t(img), _t(lab), n_labels=n, max_water_level=maxlvl, merging=merging,
                collect=collect, backend=backend, steps=4 if backend == "flood" else None, device="cpu",
            )
            got = got if isinstance(got, tuple) else (got,)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g.dtype == torch.int32
                np.testing.assert_array_equal(g.numpy(), w)
            assert (_ext.launches["flood_plain"] > 0) == (backend == "flood")
            assert _ext.launches["flood"] == 0


def test_custom_sweep_and_counted_step_match_jax():
    img, lab = _case(5, hi=30)
    n = len(SEEDS)
    sweep = flood_block.make_sweep_fn(2)
    want = np.asarray(run_levels(jnp.asarray(img), jnp.asarray(lab), n_labels=n, max_water_level=30, merging=True))
    got = run_levels_impl(
        _t(img), _t(lab), n_labels=n, max_water_level=30, merging=True, backend="sweep",
        sweep_fn=sweep, device="cpu",
    )
    np.testing.assert_array_equal(got.numpy(), want)
    from rustronomy_watershed_tpu.ops.level_driver import level_step_counted as j_counted

    jl, tl = jnp.asarray(lab), _t(lab)
    for lvl in range(0, 31, 3):
        jl, jloops = j_counted(jnp.asarray(img, jnp.int32), jl, lvl, merging=True, n_labels=n)
        tl, loops = level_step_counted(_t(img), tl, lvl, merging=True, n_labels=n)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        assert loops == int(jloops)


@pytest.mark.parametrize("merging", [False, True])
def test_count_fixed_point_iterations_matches_jax(merging):
    img, _ = _case(13, shape=(24, 30), hi=60)
    want = j_count(jnp.asarray(img), max_water_level=60, merging=merging)
    got = count_fixed_point_iterations(_t(img), max_water_level=60, merging=merging)
    assert got[0] == int(want[0]) and got[1] == int(want[1])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_flood_kernel_wrapper_refuses_cpu_misuse():
    img, lab = _case(1, shape=(8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        flood_block.flood_block_kernel(_t(img), _t(lab), 3, 4)
    assert flood_block.flood_plan(8, 8, 8)["tile_x"] == 112
    with pytest.raises(ValueError):
        flood_block.flood_plan(8, 8, 200)


@pytest.mark.parametrize("backend", ["pallas", "jnp"])
def test_transform_batch_on_level_sweep_matches_jax(backend):
    from rustronomy_watershed_tpu.prelude import TransformBuilder as JaxBuilder
    from rustronomy_watershed_tpu_torch.prelude import TransformBuilder

    imgs = np.stack([_case(s, shape=(20, 24), hi=80)[0] for s in (1, 2, 3)])
    seeds = [[(3, 4), (15, 20), (0, 9)], [], [(10, 10), (10, 11), (19, 23)]]
    for build in ("build_segmenting", "build_merging"):
        jws = getattr(JaxBuilder.default().set_max_water_lvl(80).set_backend("jnp"), build)()
        tws = getattr(TransformBuilder.default().set_device("cpu").set_max_water_lvl(80).set_backend(backend), build)()
        got = tws.transform_batch(imgs, seeds)
        np.testing.assert_array_equal(got, np.asarray(jws.transform_batch(imgs, seeds)))
        for i in range(len(imgs)):
            np.testing.assert_array_equal(got[i], tws.transform(imgs[i], seeds[i]))
