"""Port parity for the slice as a whole: watershed_e2e against the JAX
relax_pallas pipeline (Pallas interpret mode), the public API against the
JAX public API, and the committed goldens.  Integer labels, tolerance 0."""

from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustronomy_watershed_tpu.ops.pipeline import watershed_e2e_impl as j_e2e
from rustronomy_watershed_tpu.prelude import TransformBuilder as JaxBuilder
from rustronomy_watershed_tpu_torch import BuildErr
from rustronomy_watershed_tpu_torch.ops.level_driver import run_levels_impl
from rustronomy_watershed_tpu_torch.ops.pipeline import max_seed_count, watershed_e2e
from rustronomy_watershed_tpu_torch.prelude import TransformBuilder

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


@pytest.mark.parametrize(
    "configure,item",
    [
        (lambda b: b.set_wlvl_hook(lambda ctx: None), 11),
        (lambda b: b.set_plot_folder("plots"), 11),
        (lambda b: b.enable_progress(), 11),
        (lambda b: b.enable_debug(), 11),
        (lambda b: b.set_sweep_impl(lambda *a: None), 11),
        (lambda b: b.set_tie_break("random", 3), 11),
        (lambda b: b.set_checkpoint("ckpt"), 12),
        (lambda b: b.set_mesh(object()), 13),
        (lambda b: b.set_backend("jnp"), 11),
        (lambda b: b.set_backend("native"), 8),
    ],
)
def test_unserved_options_raise_at_build(configure, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue 1 item {item}"):
        configure(_cpu_builder()).build_segmenting()


def test_unserved_entries_raise():
    img = np.zeros((8, 8), np.uint8)
    with pytest.raises(NotImplementedError, match="relax_pallas"):
        _cpu_builder().set_backend("relax_pallas").build_segmenting()
    with pytest.raises(ValueError):
        _cpu_builder().set_backend("bogus")
    wm = _cpu_builder().build_merging()
    assert wm.find_local_minima(img) == []
    with pytest.raises(NotImplementedError, match="item 6"):
        wm.transform(img, [(3, 3)])
    ws = _cpu_builder().build_segmenting()
    for call, item in (
        (lambda: ws.transform_to_list(img, []), 8),
        (lambda: ws.transform_history(img, []), 8),
        (lambda: ws.transform_batch(img[None], [[]]), 7),
        (lambda: ws.transform_with_hook(img, []), 11),
        (lambda: run_levels_impl(img, None, max_water_level=254, merging=True, device="cpu"), 6),
        (lambda: run_levels_impl(img, None, max_water_level=254, collect="sizes", device="cpu"), 8),
    ):
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            call()


def test_max_seed_count_bounds_the_seeds():
    img = np.random.default_rng(0).integers(0, 255, size=(31, 40)).astype(np.uint8)
    n = len(_cpu_builder().build_segmenting().find_local_minima(img))
    assert 0 < n <= max_seed_count(img.shape)
    assert max_seed_count((1, 1)) == 1
