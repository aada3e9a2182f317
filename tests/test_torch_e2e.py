"""Port parity for the slice as a whole: watershed_e2e against the JAX
relax_pallas pipeline (Pallas interpret mode), the public API against the
JAX public API, and the committed goldens.  Integer labels, tolerance 0."""

import contextlib
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustronomy_watershed_tpu.ops.flood import flood_sweep as j_flood_sweep
from rustronomy_watershed_tpu.ops.pipeline import watershed_e2e_impl as j_e2e
from rustronomy_watershed_tpu.prelude import TransformBuilder as JaxBuilder
from rustronomy_watershed_tpu_torch import BuildErr
from rustronomy_watershed_tpu_torch.ops.flood_block import make_sweep_fn
from rustronomy_watershed_tpu_torch.ops.level_driver import run_levels_impl
from rustronomy_watershed_tpu_torch.ops.pipeline import max_seed_count, watershed_e2e
from rustronomy_watershed_tpu_torch.prelude import TransformBuilder
from torch_mesh import mesh_of, one_rank_group

torch.set_num_threads(1)

GOLDEN = Path(__file__).parent / "golden" / "golden_v1.npz"


def _cpu_builder():
    return TransformBuilder.default().set_device("cpu")


@pytest.mark.parametrize("maxlvl", [59, 254])
def test_watershed_e2e_matches_jax_relax_pallas(maxlvl):
    img = np.random.default_rng(42).integers(0, 60, size=(48, 56)).astype(np.uint8)
    want = np.asarray(
        jax.jit(partial(j_e2e, max_water_level=maxlvl, backend="relax_pallas", interpret=True))(
            jnp.asarray(img)
        )
    )
    got = watershed_e2e(img, max_water_level=maxlvl, device="cpu")
    assert got.dtype == torch.int32 and got.shape == img.shape
    np.testing.assert_array_equal(got.numpy(), want)
    labels, starved = watershed_e2e(torch.from_numpy(img), max_water_level=maxlvl, with_flags=True, device="cpu")
    assert starved is False
    np.testing.assert_array_equal(labels.numpy(), want)


@pytest.mark.parametrize(
    "edge,maxlvl,backend",
    [(False, 254, "auto"), (True, 254, "auto"), (False, 30, "auto"), (True, 30, "relax")],
)
def test_public_api_matches_jax(edge, maxlvl, backend):
    img = np.random.default_rng(6).integers(0, 200, size=(37, 44)).astype(np.uint8)
    jb, tb = JaxBuilder.default().set_max_water_lvl(maxlvl), _cpu_builder().set_max_water_lvl(maxlvl)
    if edge:
        jb.enable_edge_correction()
        tb.enable_edge_correction()
    jws, tws = jb.build_segmenting(), tb.set_backend(backend).build_segmenting()
    seeds = tws.find_local_minima(img)
    assert seeds == jws.find_local_minima(img)
    seeds = seeds + [(0, 5), (36, 43)]  # border seeds: painted unshifted under edge correction (Q7)
    want = np.asarray(jws.transform(img, seeds))
    got = tws.transform(img, seeds)
    assert isinstance(got, np.ndarray) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    dev_out = tws.transform(img, seeds, device_output=True)
    assert isinstance(dev_out, torch.Tensor)
    np.testing.assert_array_equal(dev_out.numpy(), want)


@pytest.mark.parametrize("field", ["uniform", "poisson", "grf", "nanmasked"])
def test_golden_v1_segmenting(field):
    z = np.load(GOLDEN)
    ws = _cpu_builder().build_segmenting()
    seeds = ws.find_local_minima(z[f"{field}/img"])
    np.testing.assert_array_equal(np.asarray(seeds).reshape(-1, 2), z[f"{field}/seeds"])
    np.testing.assert_array_equal(ws.transform(z[f"{field}/img"], seeds), z[f"{field}/segmenting/labels"])


def test_pre_processor_and_minima_mode_match_jax():
    x = np.random.default_rng(1).normal(size=(20, 21))
    x[3, 4] = np.nan
    jws, tws = JaxBuilder.default().build_segmenting(), _cpu_builder().build_segmenting()
    np.testing.assert_array_equal(tws.pre_processor(x), jws.pre_processor(x))
    np.testing.assert_array_equal(tws.pre_processor_with_max(x, 99), jws.pre_processor_with_max(x, 99))
    img = tws.pre_processor(x)
    assert tws.find_local_minima(img, mode="minima") == jws.find_local_minima(img, mode="minima")


@pytest.mark.parametrize("level,kind", [(255, BuildErr.MAX_TOO_HIGH), (0, BuildErr.MAX_TOO_LOW)])
def test_build_err_matches_jax(level, kind):
    from rustronomy_watershed_tpu import BuildErr as JaxBuildErr

    with pytest.raises(BuildErr) as got:
        _cpu_builder().set_max_water_lvl(level).build_segmenting()
    with pytest.raises(JaxBuildErr) as want:
        JaxBuilder.default().set_max_water_lvl(level).build_segmenting()
    assert got.value.kind == kind and str(got.value) == str(want.value)


def _sweep_for(builder):
    """A 2-sweep flood function for the builder's own package."""
    if isinstance(builder, TransformBuilder):
        return make_sweep_fn(2)
    return lambda img, lab, lvl: j_flood_sweep(j_flood_sweep(jnp.asarray(img, jnp.int32), lab, lvl), jnp.asarray(img, jnp.int32), lvl)


def _plots(builder, folder):
    out = folder / type(builder).__module__.split(".")[0]
    out.mkdir(exist_ok=True)
    return builder.set_plot_folder(str(out))


def _one_by_one(builder):
    """A 1 x 1 ``("y", "x")`` mesh for the builder's own package: a
    DeviceMesh of the one-rank gloo group (``one_rank_group``) or a JAX
    Mesh of one virtual CPU device."""
    if isinstance(builder, TransformBuilder):
        return mesh_of((1, 1))
    return jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("y", "x"))


@pytest.mark.parametrize(
    "configure,item",
    [
        (lambda b, d: b.set_wlvl_hook(lambda ctx: None), 11),
        (lambda b, d: _plots(b, d), 11),
        (lambda b, d: b.enable_progress(), 11),
        (lambda b, d: b.enable_debug(), 11),
        (lambda b, d: b.set_sweep_impl(_sweep_for(b)), 11),
        (lambda b, d: b.set_tie_break("random", 3), 11),
        (lambda b, d: b.set_checkpoint(d / type(b).__module__.split(".")[0]), 12),
        (lambda b, d: b.set_mesh(_one_by_one(b)), 13),
        (lambda b, d: b.set_backend("jnp"), 11),
        (lambda b, d: b.set_backend("native"), 8),
    ],
)
def test_unserved_options_raise_at_build(configure, item, tmp_path):
    """Every option of this list is served and gives the JAX package's
    labels; the mesh (item 13) on a one-rank gloo group in this process.
    The random tie-break draws its plane from another generator than the
    JAX package's, so there the merging labels and the segmenting claimed
    set, which no draw changes, are held equal."""
    with one_rank_group(tmp_path) if item == 13 else contextlib.nullcontext():
        tb = configure(_cpu_builder().set_max_water_lvl(60), tmp_path)
        jb = configure(JaxBuilder.default().set_max_water_lvl(60), tmp_path)
        img = np.random.default_rng(8).integers(0, 70, size=(18, 21)).astype(np.uint8)
        seeds = _cpu_builder().build_segmenting().find_local_minima(img) + [(0, 3)]
        for build in ("build_segmenting", "build_merging"):
            got = getattr(tb, build)().transform(img, seeds)
            want = np.asarray(getattr(jb, build)().transform(img, seeds))
            if tb.tie_break == "random" and build == "build_segmenting":
                got, want = got != 0, want != 0
            np.testing.assert_array_equal(got, want)


def test_unserved_entries_raise():
    """The per-level entries and the collects, unserved before, now give the
    JAX package's results; 'relax_pallas' and unknown backends still raise."""
    img = np.zeros((8, 8), np.uint8)
    with pytest.raises(NotImplementedError, match="relax_pallas"):
        _cpu_builder().set_backend("relax_pallas").build_segmenting()
    with pytest.raises(ValueError):
        _cpu_builder().set_backend("bogus")
    wm = _cpu_builder().build_merging()
    assert wm.find_local_minima(img) == []
    ws = _cpu_builder().build_segmenting()
    jws, jwm = JaxBuilder.default().build_segmenting(), JaxBuilder.default().build_merging()
    img = np.random.default_rng(3).integers(0, 254, size=(12, 14)).astype(np.uint8)
    seeds = ws.find_local_minima(img)
    for got, want in (
        (ws.transform_to_list(img, seeds), jws.transform_to_list(img, seeds)),
        (ws.transform_history(img, seeds), jws.transform_history(img, seeds)),
        (wm.transform_to_list(img, seeds), jwm.transform_to_list(img, seeds)),
        (ws.transform_with_hook(img, seeds), jws.transform_with_hook(img, seeds)),
        (wm.transform_with_hook(img, seeds), jwm.transform_with_hook(img, seeds)),
    ):
        assert len(got) == len(want)
        for (lvl, a), (jlvl, b) in zip(got, want):
            assert lvl == jlvl
            np.testing.assert_array_equal(a, b)
    from rustronomy_watershed_tpu.ops import run_levels as j_run_levels
    from rustronomy_watershed_tpu.ops.seeds import local_extrema_mask, seed_labels_from_mask

    n = max_seed_count(img.shape)
    lab0 = seed_labels_from_mask(local_extrema_mask(jnp.asarray(img)))
    for merging in (False, True):
        _, want = j_run_levels(jnp.asarray(img), lab0, n_labels=n, max_water_level=254, merging=merging, collect="sizes")
        _, got = run_levels_impl(img, None, max_water_level=254, merging=merging, n_labels=n, collect="sizes", device="cpu")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_max_seed_count_bounds_the_seeds():
    img = np.random.default_rng(0).integers(0, 255, size=(31, 40)).astype(np.uint8)
    n = len(_cpu_builder().build_segmenting().find_local_minima(img))
    assert 0 < n <= max_seed_count(img.shape)
    assert max_seed_count((1, 1)) == 1
