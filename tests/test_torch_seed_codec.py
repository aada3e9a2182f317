"""The seed list's two conversions at the port's API boundary, on the CPU.

``find_local_minima`` reads the seed mask's coordinates as two columns and
zips them into the list of ``(y, x)`` tuples; ``seed_array`` reads such a
list back as one flat stream of pairs and sends every other input through
``np.asarray``.  Both are held against the code they replaced, copied here
as oracles, and the list against the JAX package's ``find_local_minima``;
the counters say which path each input took."""

import numpy as np
import pytest
import torch

from rustronomy_watershed_tpu.prelude import TransformBuilder as JaxBuilder
from rustronomy_watershed_tpu_torch import _ext
from rustronomy_watershed_tpu_torch.ops import seeds as tseeds
from rustronomy_watershed_tpu_torch.prelude import TransformBuilder

torch.set_num_threads(1)


def _seed_array_before(seeds):
    """``seed_array`` as it was: every input through ``np.asarray``."""
    if not isinstance(seeds, np.ndarray):
        seeds = list(seeds)
    return np.asarray(seeds, dtype=np.int64).reshape(-1, 2)


def _paint_seeds_before(shape, seeds):
    """``paint_seeds`` as it was, on ``_seed_array_before``."""
    labels = np.zeros(shape, dtype=np.int32)
    coords = _seed_array_before(seeds)
    if coords.shape[0]:
        flat = coords[:, 0] * shape[1] + coords[:, 1]
        rev_first = np.unique(flat[::-1], return_index=True)[1]
        keep = flat.shape[0] - 1 - rev_first
        cols = np.arange(1, flat.shape[0] + 1, dtype=np.int32)
        labels.reshape(-1)[flat[keep]] = cols[keep]
    return labels


def _counts():
    return _ext.launches["seed_array_flat"], _ext.launches["seed_array_generic"], _ext.launches["host_reads"]


def _field(shape, seed, hi=256, never=0.0):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, hi, size=shape).astype(np.uint8)
    img[rng.random(shape) < never] = 255
    return img


def _nan_field(shape, seed):
    """A float field with 40% NaN, through the pre-processor (NaN -> 255)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape)
    x[rng.random(shape) < 0.4] = np.nan
    return TransformBuilder.default().set_device("cpu").build_merging().pre_processor(x)


IMAGES = {
    "no_seed": (lambda: np.full((16, 16), 7, np.uint8), "reference"),
    "3x3": (lambda: np.array([[1, 1, 1], [1, 9, 1], [1, 1, 1]], np.uint8), "reference"),
    "3x3_minima": (lambda: np.array([[5, 5, 5], [5, 0, 5], [5, 5, 5]], np.uint8), "minima"),
    "non_square": (lambda: _field((37, 91), 1), "reference"),
    "never_fill_heavy": (lambda: _field((64, 48), 2, never=0.25), "reference"),
    "nan_heavy": (lambda: _nan_field((53, 40), 3), "reference"),
    "minima": (lambda: _field((40, 70), 4), "minima"),
    "plateaus": (lambda: _field((33, 33), 5, hi=3), "reference"),
}


@pytest.mark.parametrize("name", IMAGES)
def test_find_local_minima_list(name):
    make, mode = IMAGES[name]
    img = make()
    ws = TransformBuilder.default().set_device("cpu").build_merging()
    before = _counts()
    got = ws.find_local_minima(img, mode=mode)
    after = _counts()

    mask = tseeds.local_extrema_mask(torch.from_numpy(img), mode)
    assert got == list(map(tuple, torch.nonzero(mask).tolist()))
    assert got == JaxBuilder.default().build_merging().find_local_minima(img, mode=mode)
    assert type(got) is list
    assert all(type(s) is tuple and len(s) == 2 and all(type(v) is int for v in s) for s in got)
    if name == "no_seed":
        assert got == []
    elif name.startswith("3x3"):
        assert got == [(1, 1)]
    else:
        assert len(got) > 1
    assert after[2] - before[2] == 1  # one read of the seed list
    assert after[:2] == before[:2]  # no seed array is built here

    before = _counts()
    coords = tseeds.seed_array(got)
    after = _counts()
    np.testing.assert_array_equal(coords, _seed_array_before(got))
    assert coords.dtype == np.int64 and coords.shape == (len(got), 2)
    # The API's own list takes the flat read; only the empty list does not.
    assert (after[0] - before[0], after[1] - before[1]) == ((0, 1) if not got else (1, 0))


_PAIRS = [(0, 1), (2, 3), (4, 0), (2, 3), (7, 8), (1, 1)]

# name -> (a maker of the input, the path it takes: "flat", "generic" or
# None for an array, which neither counter counts).
INPUTS = {
    "list_of_tuples": (lambda: list(_PAIRS), "flat"),
    "list_of_lists": (lambda: [list(p) for p in _PAIRS], "flat"),
    "tuple_of_tuples": (lambda: tuple(_PAIRS), "flat"),
    "generator": (lambda: (p for p in _PAIRS), "flat"),
    "mixed_tuples_and_lists": (lambda: [p if i % 2 else list(p) for i, p in enumerate(_PAIRS)], "flat"),
    "numpy_integers": (lambda: [(np.int32(y), np.int64(x)) for y, x in _PAIRS], "flat"),
    "integral_floats": (lambda: [(float(y), float(x)) for y, x in _PAIRS], "flat"),
    "duplicates": (lambda: [(3, 4)] * 5 + [(0, 0), (3, 4)], "flat"),
    "single": (lambda: [(5, 6)], "flat"),
    "empty_list": (lambda: [], "generic"),
    "empty_generator": (lambda: iter(()), "generic"),
    "array_n2": (lambda: np.array(_PAIRS, dtype=np.int64), None),
    "array_int32": (lambda: np.array(_PAIRS, dtype=np.int32), None),
    "array_empty": (lambda: np.zeros((0, 2), np.int64), None),
    "ragged": (lambda: [(1, 2), (3,)], "generic"),
    "triples": (lambda: [(1, 2, 3), (4, 5, 6)], "generic"),
    "string": (lambda: "abc", "generic"),
    "two_char_strings": (lambda: ["12", "34"], "generic"),
    "bytes_pairs": (lambda: [b"ab", b"cd"], "generic"),
    "dict_entries": (lambda: [{1: 0, 2: 0}], "generic"),
    "flat_ints": (lambda: [1, 2, 3, 4], "generic"),
    "array_entries": (lambda: [np.array(p) for p in _PAIRS], "generic"),
    "nested_pairs": (lambda: [((1, 2), (3, 4))], "generic"),
    "single_item_lists": (lambda: [([1], [2]), ([3], [4])], "generic"),
    "none_entry": (lambda: [(1, 2), (None, 3)], "generic"),
    "nan_entry": (lambda: [(1.0, float("nan"))], "generic"),
    "too_large": (lambda: [(2**63, 1)], "generic"),
}


def _outcome(fn, *args):
    try:
        return fn(*args), None
    except Exception as exc:  # the exception's type is the outcome compared
        return None, type(exc)


@pytest.mark.filterwarnings("ignore::RuntimeWarning")  # NaN cast to int64 in np.asarray
@pytest.mark.parametrize("name", INPUTS)
def test_seed_array_matches_the_asarray_path(name):
    make, path = INPUTS[name]
    want, want_exc = _outcome(_seed_array_before, make())
    before = _counts()
    got, got_exc = _outcome(tseeds.seed_array, make())
    after = _counts()

    assert got_exc is want_exc
    if want_exc is None:
        assert got.dtype == np.int64 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    flat, generic = after[0] - before[0], after[1] - before[1]
    assert (flat, generic) == {"flat": (1, 0), "generic": (0, 1), None: (0, 0)}[path]

    shape = (9, 10)
    want, want_exc = _outcome(_paint_seeds_before, shape, make())
    got, got_exc = _outcome(tseeds.paint_seeds, shape, make())
    assert got_exc is want_exc
    if want_exc is None:
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def _seed_lists(shape):
    """Two seed lists for ``shape``: the image's own and a shuffled one with
    a duplicate coordinate (the later seed wins where two share one)."""
    img = _field(shape, 11)
    own = TransformBuilder.default().set_device("cpu").build_merging().find_local_minima(img)
    rng = np.random.default_rng(12)
    shuffled = [own[i] for i in rng.permutation(len(own))] + [own[0]]
    return img, [own, shuffled]


@pytest.mark.parametrize("edge_correction", [False, True])
@pytest.mark.parametrize("route", ["_prepare", "_prepare_batch"])
def test_prepare_paints_the_same_planes_from_a_list_and_an_array(route, edge_correction):
    shape = (23, 31)
    img, lists = _seed_lists(shape)
    builder = TransformBuilder.default().set_device("cpu")
    ws = (builder.enable_edge_correction() if edge_correction else builder).build_merging()
    arrays = [np.array(s, dtype=np.int64) for s in lists]
    padded = np.pad(img, 1) if edge_correction else img

    if route == "_prepare":
        for seeds, coords in zip(lists, arrays):
            before = _counts()
            img_l, lab_l = ws._prepare(img, seeds)
            mid = _counts()
            img_a, lab_a = ws._prepare(img, coords)
            after = _counts()
            np.testing.assert_array_equal(img_l.numpy(), img_a.numpy())
            np.testing.assert_array_equal(lab_l.numpy(), lab_a.numpy())
            np.testing.assert_array_equal(lab_l.numpy(), _paint_seeds_before(padded.shape, seeds))
            assert (mid[0] - before[0], mid[1] - before[1]) == (1, 0)
            assert after[:2] == mid[:2]
        return

    imgs = np.stack([img, img[::-1].copy()])
    before = _counts()
    imgs_l, lab_l, coords_l, n_l = ws._prepare_batch(imgs, lists)
    mid = _counts()
    imgs_a, lab_a, coords_a, n_a = ws._prepare_batch(imgs, arrays)
    after = _counts()
    np.testing.assert_array_equal(imgs_l, imgs_a)
    np.testing.assert_array_equal(lab_l, lab_a)
    for got_l, got_a, seeds in zip(coords_l, coords_a, lists):
        np.testing.assert_array_equal(got_l, got_a)
        np.testing.assert_array_equal(got_l, _seed_array_before(seeds))
    for plane, seeds in zip(lab_l, lists):
        np.testing.assert_array_equal(plane, _paint_seeds_before(imgs_l.shape[1:], seeds))
    assert n_l == n_a == max(map(len, lists))
    assert (mid[0] - before[0], mid[1] - before[1]) == (len(lists), 0)
    assert after[:2] == mid[:2]
