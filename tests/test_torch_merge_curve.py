"""The compact-plane curves (ops/merge_curve.py) against the JAX package's
ops.merge_curve, and the public per-level API (transform_to_list,
transform_history) against the JAX public API, for both variants, the
packed and level-sweep engines, with and without edge correction.  Integer
planes and counts, tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustronomy_watershed_tpu.ops import merge_curve as jmc
from rustronomy_watershed_tpu.ops import paint_seeds
from rustronomy_watershed_tpu.ops.priority import relax_transform as j_relax
from rustronomy_watershed_tpu.prelude import TransformBuilder as JaxBuilder
from rustronomy_watershed_tpu_torch import _ext
from rustronomy_watershed_tpu_torch.ops import merge_curve as mc
from rustronomy_watershed_tpu_torch.prelude import TransformBuilder

torch.set_num_threads(1)


def _field(seed, shape=(40, 56), nan=0.1):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 254, size=shape).astype(np.uint8)
    img[rng.random(shape) < nan] = 255
    return img


def _seeds(img, extra=((0, 9), (20, 0))):
    """The image's own seeds plus border seeds."""
    ws = TransformBuilder.default().set_device("cpu").build_segmenting()
    return ws.find_local_minima(img) + list(extra)


@pytest.mark.parametrize("maxlvl", [254, 120])
def test_merge_edges_matches_jax(maxlvl):
    img = _field(1)
    lab0 = np.asarray(paint_seeds(img.shape, _seeds(img)))
    labels, L = j_relax(jnp.asarray(img, jnp.int32), jnp.asarray(lab0), max_water_level=maxlvl)
    jlo, jhi, jact, n = jmc.merge_edges(labels, L, max_water_level=maxlvl)
    n = int(n)
    lo, hi, act, got_n = mc.merge_edges(torch.from_numpy(np.array(labels)), torch.from_numpy(np.array(L)), max_water_level=maxlvl)
    assert got_n == n > 0
    for g, w in ((lo, jlo), (hi, jhi), (act, jact)):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w)[:n])


@pytest.mark.parametrize("merging", [False, True])
@pytest.mark.parametrize("backend", ["packed", "relax"])
def test_relax_merging_sizes_and_history_match_jax(backend, merging):
    img = _field(2)
    seeds = _seeds(img)
    lab0 = paint_seeds(img.shape, seeds)
    n = len(seeds)
    jfinal, jsizes, _ = jmc.relax_merging_sizes(
        jnp.asarray(img), lab0, n_labels=n, max_water_level=254, merging=merging, out_width=n + 3
    )
    _ext.reset_launches()
    final, sizes, starved = mc.relax_merging_sizes(
        torch.from_numpy(img), torch.from_numpy(np.array(lab0)), n_labels=n, max_water_level=254,
        backend=backend, merging=merging, out_width=n + 3, device="cpu",
    )
    assert starved is False and sizes.dtype == np.int64
    np.testing.assert_array_equal(sizes, np.asarray(jsizes))
    np.testing.assert_array_equal(final.numpy(), np.asarray(jfinal))
    if backend == "packed" and merging:
        assert _ext.launches["coarse_round_plain"] > 0  # the merged plane's coarse tail
    jsnaps, _ = jmc.relax_history(jnp.asarray(img), lab0, n_labels=n, max_water_level=200, merging=merging)
    snaps, starved = mc.relax_history(
        torch.from_numpy(img), torch.from_numpy(np.array(lab0)), n_labels=n, max_water_level=200,
        backend=backend, merging=merging, device="cpu",
    )
    assert starved is False and len(snaps) == len(jsnaps) == 201
    for (lvl, s), (jlvl, js) in zip(snaps, jsnaps):
        assert lvl == jlvl and s.dtype == np.int32
        np.testing.assert_array_equal(s, js)


def test_host_tail_pieces_match_jax():
    rng = np.random.default_rng(4)
    labels = rng.integers(0, 12, size=(9, 10)).astype(np.int32)
    lv8 = rng.integers(0, 32, size=(9, 10)).astype(np.uint8)
    cum = mc.host_cumulative_counts(labels, lv8, 11, 30)
    np.testing.assert_array_equal(cum, jmc.host_cumulative_counts(labels, lv8, 11, 30))
    lo = np.array([1, 2, 3, 1, 7], np.int32)
    hi = np.array([2, 5, 9, 11, 8], np.int32)
    act = np.array([4, 4, 10, 30, 0], np.int32)
    np.testing.assert_array_equal(mc.merged_sizes_host(cum, lo, hi, act), jmc.merged_sizes_host(cum, lo, hi, act))
    for width in (None, 5, 40):
        np.testing.assert_array_equal(
            mc.merged_curve_host(labels, lv8, 11, 30, lo, hi, act, out_width=width),
            jmc.merged_curve_host(labels, lv8, 11, 30, lo, hi, act, out_width=width),
        )


def _pair(merging, edge, backend, maxlvl=254):
    jb = JaxBuilder.default().set_max_water_lvl(maxlvl)
    tb = TransformBuilder.default().set_device("cpu").set_max_water_lvl(maxlvl).set_backend(backend)
    if edge:
        jb.enable_edge_correction()
        tb.enable_edge_correction()
    build = "build_merging" if merging else "build_segmenting"
    return getattr(jb, build)(), getattr(tb, build)()


@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("backend", ["auto", "pallas"])
@pytest.mark.parametrize("merging", [False, True])
def test_transform_to_list_matches_jax(merging, backend, edge):
    img = _field(3, shape=(30, 36))
    jws, tws = _pair(merging, edge, backend)
    seeds = _seeds(img, extra=((0, 5), (29, 35)))
    for length in (None, len(seeds) + 1):
        want = jws.transform_to_list(img, seeds, counts_length=length)
        got = tws.transform_to_list(img, seeds, counts_length=length)
        assert len(got) == len(want) == 255
        for (lvl, row), (jlvl, jrow) in zip(got, want):
            assert lvl == jlvl and row.dtype == np.int64
            np.testing.assert_array_equal(row, jrow)
    if merging:  # the void-filling curve ends in one lake on a NaN-free field
        clean = np.minimum(img, 254)
        rows = tws.transform_to_list(clean, _seeds(clean, ()), counts_length=len(seeds) + 1)
        assert (rows[-1][1][1:] > 0).sum() == 1


@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("backend", ["auto", "pallas", "jnp"])
@pytest.mark.parametrize("merging", [False, True])
def test_transform_history_matches_jax(merging, backend, edge):
    img = _field(5, shape=(30, 36))
    jws, tws = _pair(merging, edge, backend, maxlvl=180)
    seeds = _seeds(img, extra=((0, 5), (29, 35)))
    want = jws.transform_history(img, seeds)
    got = tws.transform_history(img, seeds)
    assert len(got) == len(want) == 181
    for (lvl, s), (jlvl, js) in zip(got, want):
        assert lvl == jlvl and s.dtype == np.int32 and s.shape == np.asarray(js).shape
        np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(got[-1][1], tws.transform(img, seeds))
