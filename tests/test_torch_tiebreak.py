"""The random tie-break (``set_tie_break('random', seed)``, reference
src/lib.rs:249-253): the port's ``flood_candidates_random`` /
``flood_sweep_random`` and the level sweep on them against the JAX
package's on the same float32 uniform plane (tolerance 0), and the builder
tests of tests/test_tiebreak.py on the port: the port draws its plane with
torch, not jax.random, so whole transforms agree with the JAX package's in
distribution, not pixel for pixel."""

from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustronomy_watershed_tpu.ops import flood as jflood
from rustronomy_watershed_tpu.ops import paint_seeds, run_levels
from rustronomy_watershed_tpu_torch.ops import flood
from rustronomy_watershed_tpu_torch.ops.level_driver import run_levels_impl
from rustronomy_watershed_tpu_torch.prelude import TransformBuilder

torch.set_num_threads(1)


def _tb():
    return TransformBuilder.default().set_device("cpu")


def _state(seed, shape=(23, 29), p_uncoloured=0.5):
    """Image, labels with every count of coloured 4-neighbours (0..4) and
    a float32 uniform plane holding the ``u * n == n`` corner."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 40, size=shape).astype(np.uint8)
    labels = np.where(rng.random(shape) < p_uncoloured, 0, rng.integers(1, 9, size=shape)).astype(np.int32)
    u = rng.random(shape, dtype=np.float32)
    u[::3, ::2] = np.nextafter(np.float32(1), np.float32(0))
    u[1::4, 1::3] = 0.0
    return img, labels, u


@pytest.mark.parametrize("lvl", [0, 20, 39])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_candidates_and_sweep_match_jax(seed, lvl):
    img, labels, u = _state(seed)
    neigh = [np.pad(labels, 1)[1 + dy : 1 + dy + labels.shape[0], 1 + dx : 1 + dx + labels.shape[1]] != 0
             for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1))]
    assert set(np.unique(sum(n.astype(int) for n in neigh)[1:-1, 1:-1])) == {0, 1, 2, 3, 4}
    got = flood.flood_candidates_random(torch.from_numpy(img), torch.from_numpy(labels), lvl, torch.from_numpy(u))
    want = jflood.flood_candidates_random(jnp.asarray(img, jnp.int32), jnp.asarray(labels), lvl, jnp.asarray(u))
    cand = got[0].numpy()
    np.testing.assert_array_equal(cand, np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy()[cand], np.asarray(want[1])[cand])
    assert bool(got[2]) == bool(want[2])
    sweep = flood.flood_sweep_random(torch.from_numpy(img), torch.from_numpy(labels), lvl, u=torch.from_numpy(u))
    jsweep = jflood.flood_sweep_random(jnp.asarray(img, jnp.int32), jnp.asarray(labels), lvl, u=jnp.asarray(u))
    np.testing.assert_array_equal(sweep.numpy(), np.asarray(jsweep))


@pytest.mark.parametrize("collect", ["none", "sizes"])
@pytest.mark.parametrize("merging", [False, True])
def test_random_level_sweep_matches_jax(merging, collect):
    rng = np.random.default_rng(5)
    img = rng.integers(0, 12, size=(26, 31)).astype(np.uint8)
    u = rng.random(img.shape, dtype=np.float32)
    seeds = [tuple(p) for p in rng.integers(1, 25, (12, 2))]
    lab0 = np.array(paint_seeds(img.shape, seeds))
    kw = dict(n_labels=len(seeds), max_water_level=14, merging=merging, collect=collect)
    want = run_levels(jnp.asarray(img), jnp.asarray(lab0), backend="jnp",
                      sweep_fn=partial(jflood.flood_sweep_random, u=jnp.asarray(u)), **kw)
    got = run_levels_impl(torch.from_numpy(img), torch.from_numpy(lab0), backend="sweep", device="cpu",
                          sweep_fn=partial(flood.flood_sweep_random, u=torch.from_numpy(u)), **kw)
    for g, w in zip(got, want) if collect != "none" else ((got, want),):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    min_rule = run_levels_impl(torch.from_numpy(img), torch.from_numpy(lab0), backend="sweep", device="cpu", **kw)
    g, m = (got[0], min_rule[0]) if collect != "none" else (got, min_rule)
    assert torch.equal(g != 0, m != 0)
    assert merging or not torch.equal(g, m)


def _tie_field(rows: int):
    """(img, seeds): ``rows`` 7-px plateau corridors separated by NEVER_FILL
    rows; seeds at x=1 and x=5, so x=3 is a pure two-way tie."""
    img = np.full((2 * rows + 1, 7), 255, dtype=np.uint8)
    seeds = []
    for i in range(rows):
        y = 2 * i + 1
        img[y, :] = 0
        seeds += [(y, 1), (y, 5)]
    return img, seeds


def _chi2_first(out_rows):
    n, n_first = len(out_rows), sum(out_rows)
    e = n / 2.0
    return (n_first - e) ** 2 / e + ((n - n_first) - e) ** 2 / e


def test_min_default_awards_first_seed():
    img, seeds = _tie_field(32)
    out = _tb().set_max_water_lvl(1).build_segmenting().transform(img, seeds)
    assert all(out[2 * i + 1, 3] == 2 * i + 1 for i in range(32))


def test_random_tie_break_uniform_chi_square():
    rows = 400
    img, seeds = _tie_field(rows)
    out = _tb().set_max_water_lvl(1).set_tie_break("random", seed=7).build_segmenting().transform(img, seeds)
    firsts = []
    for i in range(rows):
        got = out[2 * i + 1, 3]
        assert got in (2 * i + 1, 2 * i + 2), (i, got)
        firsts.append(got == 2 * i + 1)
    assert _chi2_first(firsts) < 10.83  # 1 dof, p = 0.001
    assert not all(firsts)


def test_random_tie_break_reproducible_and_seed_sensitive():
    img, seeds = _tie_field(64)

    def run(s):
        return _tb().set_max_water_lvl(1).set_tie_break("random", seed=s).build_segmenting().transform(img, seeds)

    a1, a2, b = run(3), run(3), run(4)
    np.testing.assert_array_equal(a1, a2)
    assert np.any(a1 != b)


def test_random_claimed_set_and_merging_invariant():
    img = np.random.default_rng(11).integers(0, 30, size=(40, 40)).astype(np.uint8)
    seeds = _tb().build_segmenting().find_local_minima(img)
    out_min = _tb().build_segmenting().transform(img, seeds)
    out_rnd = _tb().set_tie_break("random", 1).build_segmenting().transform(img, seeds)
    np.testing.assert_array_equal(out_min != 0, out_rnd != 0)
    assert np.any(out_min != out_rnd)
    np.testing.assert_array_equal(
        _tb().build_merging().transform(img, seeds),
        _tb().set_tie_break("random", 1).build_merging().transform(img, seeds),
    )


@pytest.mark.parametrize("variant", ["segmenting", "merging"])
def test_random_host_loop_paths_agree(variant, capsys):
    """The level sweep, the hooked host loop and the debug loop's split
    candidates draw the same plane: the same labels from one seed."""
    img = np.random.default_rng(12).integers(0, 16, size=(20, 24)).astype(np.uint8)
    seeds = _tb().build_segmenting().find_local_minima(img)

    def build(b):
        return getattr(b.set_max_water_lvl(15).set_tie_break("random", 9), f"build_{variant}")()

    want = build(_tb()).transform(img, seeds)
    hooked = build(_tb().set_wlvl_hook(lambda ctx: ctx.colours.copy())).transform_with_hook(img, seeds)
    np.testing.assert_array_equal(hooked[-1], want)
    np.testing.assert_array_equal(build(_tb().enable_debug()).transform(img, seeds), want)
    assert "starting with" in capsys.readouterr().out
    rows = build(_tb()).transform_to_list(img, seeds, counts_length=len(seeds) + 1)
    np.testing.assert_array_equal(rows[-1][1], np.bincount(want.ravel(), minlength=len(seeds) + 1))
    hist = build(_tb()).transform_history(img, seeds)
    np.testing.assert_array_equal(hist[-1][1], want)


def test_builder_validation():
    with pytest.raises(ValueError):
        _tb().set_tie_break("bogus")
    for backend in ("relax", "pallas", "native", "relax_pallas"):
        with pytest.raises(ValueError, match="min-label only"):
            _tb().set_tie_break("random").set_backend(backend).build_segmenting()
    with pytest.raises(ValueError, match="set_sweep_impl"):
        _tb().set_tie_break("random").set_sweep_impl(lambda img, lab, lvl: lab).build_segmenting()
    with pytest.raises(ValueError, match="single-device"):
        _tb().set_tie_break("random").set_mesh(object()).build_merging()
    _tb().set_tie_break("random").set_backend("jnp").build_merging()
    # min (the default) composes with every served backend, unchanged.
    for backend in ("auto", "relax", "pallas", "jnp", "native"):
        _tb().set_tie_break("min").set_backend(backend).build_segmenting()


def test_batch_random_tie_break_distribution_and_claimed_set():
    rows, b = 50, 8
    img, seeds = _tie_field(rows)
    imgs, seeds_list = np.stack([img] * b), [seeds] * b
    ws = _tb().set_max_water_lvl(1).set_tie_break("random", seed=7).build_segmenting()
    out = ws.transform_batch(imgs, seeds_list)
    assert out.shape == imgs.shape
    firsts = []
    for k in range(b):
        for i in range(rows):
            got = out[k, 2 * i + 1, 3]
            assert got in (2 * i + 1, 2 * i + 2), (k, i, got)
            firsts.append(got == 2 * i + 1)
    assert _chi2_first(firsts) < 10.83
    assert any(np.any(out[k] != out[0]) for k in range(1, b))
    out_min = _tb().set_max_water_lvl(1).build_segmenting().transform_batch(imgs, seeds_list)
    np.testing.assert_array_equal(out != 0, out_min != 0)
    # Image i draws its own plane: the same labels in a shorter batch.
    np.testing.assert_array_equal(ws.transform_batch(imgs[:3], seeds_list[:3]), out[:3])


def test_batch_random_reproducible_and_seed_sensitive():
    img, seeds = _tie_field(64)
    imgs, seeds_list = np.stack([img] * 3), [seeds] * 3

    def run(s):
        return _tb().set_max_water_lvl(1).set_tie_break("random", seed=s).build_segmenting().transform_batch(
            imgs, seeds_list)

    a1, a2, b = run(3), run(3), run(4)
    np.testing.assert_array_equal(a1, a2)
    assert np.any(a1 != b)


def test_batch_random_merging_invariant_and_edge_correction():
    gen = np.random.default_rng(5)
    imgs = gen.integers(0, 25, size=(3, 24, 24)).astype(np.uint8)
    seeds_list = [_tb().build_segmenting().find_local_minima(im) for im in imgs]
    for edge in (False, True):
        def mk(tb, edge=edge):
            bld = _tb().set_tie_break(*tb)
            return (bld.enable_edge_correction() if edge else bld).build_merging()

        np.testing.assert_array_equal(
            mk(("random", 1)).transform_batch(imgs, seeds_list), mk(("min",)).transform_batch(imgs, seeds_list)
        )
