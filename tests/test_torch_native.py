"""The port's native C++ engine (parity/native.py, parity/oracle.cc) against
the JAX package's, the native merged-curve pass against the NumPy pair it
replaced, and ``set_backend("native")`` against the JAX builder and the
port's ``'auto'``.  Integer labels and counts, tolerance 0."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from rustronomy_watershed_tpu.parity import native as jnative
from rustronomy_watershed_tpu.prelude import TransformBuilder as JaxBuilder
from rustronomy_watershed_tpu_torch.ops import merge_curve as mc
from rustronomy_watershed_tpu_torch.parity import native
from rustronomy_watershed_tpu_torch.prelude import TransformBuilder

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _field(seed, shape=(36, 44), hi=254, nan=0.1):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, hi, size=shape).astype(np.uint8)
    img[rng.random(shape) < nan] = 255
    return img


def _code(path):
    """The source without its comments."""
    return re.sub(r"//[^\n]*", "", path.read_text())


def test_oracle_source_is_the_reference_copy():
    """The port builds its own copy of the engine; only a comment differs."""
    ours = ROOT / "rustronomy_watershed_tpu_torch" / "parity" / "oracle.cc"
    theirs = ROOT / "rustronomy_watershed_tpu" / "parity" / "oracle.cc"
    assert _code(ours) == _code(theirs)


@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("merging", [False, True])
@pytest.mark.parametrize("maxlvl", [254, 90])
def test_native_transform_matches_jax(merging, edge, maxlvl):
    img = _field(1)
    seeds = jnative.native_find_local_minima(img) + [(0, 5), (17, 0)]
    got = native.native_transform(img, seeds, maxlvl, merging=merging, edge_correction=edge, with_sizes=True)
    want = jnative.native_transform(img, seeds, maxlvl, merging=merging, edge_correction=edge, with_sizes=True)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int64
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        native.native_transform(img, seeds, maxlvl, merging=merging, edge_correction=edge), want[0]
    )


@pytest.mark.parametrize("shape", [(36, 44), (3, 3), (1, 9)])
def test_native_find_local_minima_matches_jax(shape):
    img = _field(2, shape, nan=0.0)
    assert native.native_find_local_minima(img) == jnative.native_find_local_minima(img)


def _curve_inputs(seed, shape=(30, 34), k=23, levels=255, n_edges=40):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, k + 1, size=shape).astype(np.int32)
    lv8 = rng.integers(0, levels + 1, size=shape).astype(np.uint8)
    lv8[labels == 0] = levels  # never claimed
    lo = rng.integers(1, k, n_edges).astype(np.int32)
    hi = (lo + rng.integers(1, 4, n_edges)).clip(max=k).astype(np.int32)
    act = rng.integers(0, levels, n_edges).astype(np.int32)
    return labels, lv8, k, levels - 1, lo, hi, act


@pytest.mark.parametrize("width", [None, 7, 24, 200])
@pytest.mark.parametrize("seed", [0, 1])
def test_native_merged_curve_matches_jax_and_numpy(seed, width):
    args = _curve_inputs(seed)
    got = native.native_merged_curve(*args, out_width=width)
    np.testing.assert_array_equal(got, jnative.native_merged_curve(*args, out_width=width))
    np.testing.assert_array_equal(got, mc.merged_curve_plain(*args, out_width=width))
    np.testing.assert_array_equal(mc.merged_curve_host(*args, out_width=width), got)
    labels, lv8, k, maxlvl, lo, hi, act = args
    empty = np.zeros((0,), np.int32)
    np.testing.assert_array_equal(
        native.native_merged_curve(labels, lv8, k, maxlvl, empty, empty, empty),
        mc.merged_curve_plain(labels, lv8, k, maxlvl, empty, empty, empty),
    )


@pytest.mark.parametrize("bad", ["label", "level", "edge", "act"])
def test_native_merged_curve_refuses_out_of_range(bad):
    labels, lv8, k, maxlvl, lo, hi, act = _curve_inputs(3, levels=100)
    if bad == "label":
        labels[0, 0] = k + 1
    elif bad == "level":
        lv8[0, 0] = maxlvl + 2
    elif bad == "edge":
        hi[0] = k + 1
    else:
        act[0] = maxlvl + 1
    with pytest.raises(ValueError, match="outside"):
        native.native_merged_curve(labels, lv8, k, maxlvl, lo, hi, act)


@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("variant", ["segmenting", "merging"])
def test_native_backend_matches_jax_and_auto(variant, edge):
    img = _field(4, (30, 38), hi=80)
    seeds = jnative.native_find_local_minima(img) + [(0, 3)]

    def build(b, backend):
        b = b.set_backend(backend).set_max_water_lvl(200)
        if edge:
            b = b.enable_edge_correction()
        return getattr(b, f"build_{variant}")()

    ours = build(TransformBuilder.default().set_device("cpu"), "native")
    auto = build(TransformBuilder.default().set_device("cpu"), "auto")
    theirs = build(JaxBuilder.default(), "native")
    got = ours.transform(img, seeds)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(theirs.transform(img, seeds)))
    np.testing.assert_array_equal(got, auto.transform(img, seeds))
    dev = ours.transform(img, seeds, device_output=True)
    assert isinstance(dev, torch.Tensor) and torch.equal(dev, torch.from_numpy(got))
    for length in (None, len(seeds) + 1):
        rows = ours.transform_to_list(img, seeds, counts_length=length)
        for want in (theirs.transform_to_list(img, seeds, counts_length=length),
                     auto.transform_to_list(img, seeds, counts_length=length)):
            assert len(rows) == len(want) == 201
            for (lvl, r), (wlvl, w) in zip(rows, want):
                assert lvl == wlvl and r.dtype == np.int64
                np.testing.assert_array_equal(r, w)
    # Every other entry runs the plain level sweep, as the JAX package's 'jnp'.
    hist = ours.transform_history(img, seeds)
    want = theirs.transform_history(img, seeds)
    assert all(a[0] == b[0] and np.array_equal(a[1], b[1]) for a, b in zip(hist, want))
    np.testing.assert_array_equal(
        ours.transform_batch(np.stack([img, img[::-1]]), [seeds, seeds])[1], auto.transform(img[::-1], seeds)
    )


def test_failed_build_raises(tmp_path, monkeypatch):
    """No fallback: a compiler that is missing or fails raises, for the
    binding and for the merged-curve tail that runs on it."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "native")
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot run"):
        native.native_find_local_minima(np.zeros((4, 4), np.uint8))
    with pytest.raises(RuntimeError, match="cannot run"):
        mc.merged_curve_host(*_curve_inputs(0))
    fake = tmp_path / "fake-gxx"
    fake.write_text("#!/bin/sh\n[ \"$1\" = --version ] && echo fake && exit 0\necho broken >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(native, "CXX", str(fake))
    with pytest.raises(RuntimeError, match="build failed"):
        native.native_transform(np.zeros((4, 4), np.uint8), [])
    assert not list((tmp_path / "native").rglob("*.so"))
