"""Port parity for the merging public API and ``transform_batch``:
``build_merging().transform`` on the committed goldens and against the JAX
builder, and ``transform_batch`` of both variants against the JAX
``transform_batch``.  Integer labels, tolerance 0."""

from pathlib import Path

import numpy as np
import pytest
import torch

from rustronomy_watershed_tpu.constants import NEVER_FILL
from rustronomy_watershed_tpu.prelude import TransformBuilder as JaxBuilder
from rustronomy_watershed_tpu_torch import _ext
from rustronomy_watershed_tpu_torch.prelude import TransformBuilder

torch.set_num_threads(1)

GOLDEN = Path(__file__).parent / "golden" / "golden_v1.npz"


def _cpu_builder():
    return TransformBuilder.default().set_device("cpu")


@pytest.mark.parametrize("field", ["uniform", "poisson", "grf", "nanmasked", "edge"])
def test_golden_v1_merging(field):
    z = np.load(GOLDEN)
    if field == "edge":
        img, seeds = z["uniform/img"], [tuple(s) for s in z["edge/seeds"]]
        tb, jb = _cpu_builder().enable_edge_correction(), JaxBuilder.default().enable_edge_correction()
    else:
        img, seeds = z[f"{field}/img"], [tuple(s) for s in z[f"{field}/seeds"]]
        tb, jb = _cpu_builder(), JaxBuilder.default()
    want = z[f"{field}/merging/labels"]
    for backend in ("auto", "relax"):
        got = tb.set_backend(backend).build_merging().transform(img, seeds)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.asarray(jb.build_merging().transform(img, seeds)), want)


def test_merging_transform_matches_jax_builder():
    img = np.random.default_rng(6).integers(0, 200, size=(37, 44)).astype(np.uint8)
    img[np.random.default_rng(7).random(img.shape) < 0.08] = 255
    for maxlvl, edge in ((254, False), (120, True)):
        jb, tb = JaxBuilder.default().set_max_water_lvl(maxlvl), _cpu_builder().set_max_water_lvl(maxlvl)
        if edge:
            jb.enable_edge_correction()
            tb.enable_edge_correction()
        jws, tws = jb.build_merging(), tb.build_merging()
        seeds = tws.find_local_minima(img) + [(0, 5), (36, 43)]
        want = np.asarray(jws.transform(img, seeds))
        np.testing.assert_array_equal(tws.transform(img, seeds), want)
        dev_out = tws.transform(img, seeds, device_output=True)
        assert isinstance(dev_out, torch.Tensor)
        np.testing.assert_array_equal(dev_out.numpy(), want)


def _stack(case):
    """b=3 cutouts of 24x32 with per-image seed lists; image 2 repeats a
    coordinate so its least surviving label is 2 (keep-last painting)."""
    b, h, w = 3, 24, 32
    imgs = np.random.default_rng(11).integers(0, 254, size=(b, h, w)).astype(np.uint8)
    seeds = [[(3, 4), (h - 4, w - 5), (7, 9)], [(2, 2), (6, 11)], [(4, w - 4), (9, 9), (4, w - 4), (h - 3, 3)]]
    if case == "border_seed":
        seeds[1] = seeds[1] + [(0, 5)]
    if case == "nan_blob":
        imgs[1, 5:12, 6:10] = NEVER_FILL
    return imgs, seeds


@pytest.mark.parametrize("case", ["clean", "border_seed", "nan_blob"])
@pytest.mark.parametrize("variant", ["merging", "segmenting"])
def test_transform_batch_matches_jax(variant, case):
    imgs, seeds = _stack(case)
    want = np.asarray(getattr(JaxBuilder.default(), f"build_{variant}")().transform_batch(imgs, seeds))
    for backend in ("auto", "relax"):
        ws = getattr(_cpu_builder().set_backend(backend), f"build_{variant}")()
        _ext.reset_launches()
        got = ws.transform_batch(imgs, seeds)
        assert got.shape == imgs.shape and got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        if variant == "merging" and backend == "auto":
            route = "merge_shortcut" if case == "clean" else "merge_tail"
            assert _ext.launches[route] == 1, _ext.launches
    for i in range(len(seeds)):  # and equal to per-image transforms
        single = getattr(_cpu_builder(), f"build_{variant}")().transform(imgs[i], seeds[i])
        np.testing.assert_array_equal(want[i], single)


def test_transform_batch_edge_correction_and_validation():
    imgs, seeds = _stack("clean")
    jws = JaxBuilder.default().enable_edge_correction().build_merging()
    tws = _cpu_builder().enable_edge_correction().build_merging()
    np.testing.assert_array_equal(tws.transform_batch(imgs, seeds), np.asarray(jws.transform_batch(imgs, seeds)))
    out = tws.transform_batch(imgs, seeds, device_output=True)
    assert isinstance(out, torch.Tensor) and out.shape == (3, 26, 34)
    with pytest.raises(ValueError, match="B, H, W"):
        tws.transform_batch(imgs[0], seeds)
    with pytest.raises(ValueError, match="one seed list"):
        tws.transform_batch(imgs, seeds[:2])
