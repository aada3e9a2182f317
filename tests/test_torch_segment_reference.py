"""The benchmark's plain segmenting reference (portbench/reference/segmenting.py,
loaded by its path) against the port's segmenting paths on the CPU, its
control against it, and the port's event-driven oracle as a second witness.

The reference decides ``correct`` in the ``tile4096.segment`` cell, so it
must give the port's labels on every kind of field the port meets: uniform
values, wide plateaus, NaN dots and seeds beside the border ring."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from rustronomy_watershed_tpu_torch.ops import watershed_e2e
from rustronomy_watershed_tpu_torch.parity.heap_oracle import heap_transform
from rustronomy_watershed_tpu_torch.prelude import TransformBuilder

_PATH = Path(__file__).resolve().parents[1] / "portbench" / "reference" / "segmenting.py"


def _reference():
    spec = importlib.util.spec_from_file_location("portbench_reference_segmenting", _PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _reference()


def _border_seeds(shape, seed):
    """Uniform values below 200 with a strict maximum (253) every third
    pixel of the rows and columns next to the border ring."""
    h, w = shape
    img = np.random.default_rng(seed).integers(0, 200, shape).astype(np.uint8)
    img[1, 4 : w - 4 : 3] = img[h - 2, 4 : w - 4 : 3] = 253
    img[4 : h - 4 : 3, 1] = img[4 : h - 4 : 3, w - 2] = 253
    return img


def _field(kind, shape, seed):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.integers(0, 254, shape).astype(np.uint8)
    if kind == "plateau":  # high 4: wide plateaus, the tie-break everywhere
        return rng.integers(0, 4, shape).astype(np.uint8)
    if kind == "nan_dots":  # 10% NaN as NEVER_FILL, as the pre-processor maps it
        img = rng.integers(0, 254, shape).astype(np.uint8)
        img[rng.random(shape) < 0.1] = 255
        return img
    return _border_seeds(shape, seed)


FIELDS = [("uniform", (256, 256)), ("plateau", (128, 96)), ("nan_dots", (160, 200)), ("border_seeds", (64, 64))]


@pytest.mark.parametrize("kind,shape", FIELDS)
@pytest.mark.parametrize("path", ["e2e", "transform", "to_list"])
def test_reference_equals_the_port(kind, shape, path):
    """0 differing pixels (or row entries) between the reference and each
    of the port's segmenting paths on the CPU."""
    img = _field(kind, shape, seed=shape[0] + shape[1])
    seg = ref.Segmenting(img)
    if kind == "border_seeds":
        s = ref.seeds(img)
        assert ((s[:, 0] == 1) | (s[:, 1] == 1) | (s[:, 0] == shape[0] - 2) | (s[:, 1] == shape[1] - 2)).sum() >= 40
    if path == "e2e":
        got = watershed_e2e(torch.from_numpy(img), merging=False, device="cpu").numpy()
        assert np.count_nonzero(got != seg.labels()) == 0
        return
    ws = TransformBuilder.default().set_device("cpu").build_segmenting()
    seeds = ws.find_local_minima(img)
    assert np.array_equal(np.asarray(seeds, dtype=np.int64).reshape(-1, 2), ref.seeds(img))
    if path == "transform":
        assert np.count_nonzero(np.asarray(ws.transform(img, seeds)) != seg.labels()) == 0
        return
    rows = ws.transform_to_list(img, seeds)
    want = seg.curve()
    assert [lvl for lvl, _ in rows] == list(range(255)) and want.shape == (255, img.size + 1)
    assert sum(int(np.count_nonzero(np.asarray(r) != want[lvl])) for lvl, r in rows) == 0


@pytest.mark.parametrize("kind,shape", FIELDS)
def test_the_control_breaks_the_tie_break(kind, shape):
    """The control (greatest coloured neighbour's label) differs from the
    reference on more than 0 pixels, by its labels alone: it paints the
    same pixels."""
    img = _field(kind, shape, seed=shape[0] + shape[1])
    want, ctl = ref.labels(img), ref.labels(img, control=True)
    assert np.count_nonzero(ctl != want) > 0
    assert np.array_equal(ctl == 0, want == 0)


@pytest.mark.parametrize("kind", ["uniform", "plateau", "nan_dots", "border_seeds"])
def test_reference_equals_the_heap_oracle(kind):
    """A second witness of another algorithmic family: the port's
    event-driven oracle (parity/heap_oracle.py) at 32x32, the curve too."""
    img = _field(kind, (32, 32), seed=7)
    seeds = [tuple(map(int, s)) for s in ref.seeds(img)]
    labels, sizes = heap_transform(img, seeds, with_sizes=True)
    seg = ref.Segmenting(img)
    assert np.array_equal(np.asarray(labels), seg.labels())
    assert np.array_equal(np.asarray(sizes), seg.curve(counts_length=len(seeds) + 1))


def test_reference_levels_and_counts_length():
    """``labels(level)`` keeps the pixels painted by that level; a
    ``counts_length`` shorter than the labels is refused."""
    img = _field("uniform", (48, 40), seed=3)
    seg = ref.Segmenting(img)
    rows = seg.curve(counts_length=seg.n_seeds + 1)
    for lvl in (0, 100, 254):
        lab = seg.labels(lvl)
        assert np.array_equal(np.bincount(lab.reshape(-1), minlength=seg.n_seeds + 1), rows[lvl])
    assert rows.shape == (255, seg.n_seeds + 1) and rows[0, 0] > rows[254, 0]
    with pytest.raises(ValueError, match="counts_length"):
        seg.curve(counts_length=seg.n_seeds)
