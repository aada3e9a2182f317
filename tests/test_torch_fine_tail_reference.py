"""The fine scan tail against the judge of the benchmark's 16384² merging
cell: NaN-dot tiles merged with a label bound of 2**24, which fails the
coarse gate as every square tile of 8193² or more does, equal the plain
merging reference (portbench/reference/merging.py, loaded by its path);
``fine_tail`` counts the call and ``fine_round`` its rounds, and a bound
below 2**24 takes the coarse route, which counts in neither."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from rustronomy_watershed_tpu_torch import _ext
from rustronomy_watershed_tpu_torch.ops import scan_merge as sm
from rustronomy_watershed_tpu_torch.ops.level_driver import run_levels_impl
from rustronomy_watershed_tpu_torch.ops.pipeline import max_seed_count

torch.set_num_threads(1)
_BENCH = Path(__file__).resolve().parents[1] / "portbench"


def _load(rel):
    spec = importlib.util.spec_from_file_location("portbench_" + rel.replace("/", "_")[:-3], _BENCH / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


merging = _load("reference/merging.py")
FIELD = json.loads((_BENCH / "traffic" / "merge_nan10_16k.json").read_text())["field"]


def _tile(shape, seed):
    """The cell's field at a small shape: uniform levels below ``high``,
    ``nan_frac`` of the pixels NEVER_FILL dots."""
    gen = np.random.default_rng(seed)
    img = gen.integers(0, FIELD["high"], shape).astype(np.uint8)
    img[gen.random(shape) < FIELD["nan_frac"]] = 255
    return img


CASES = [(shape, seed) for shape in ((64, 64), (96, 80), (128, 128)) for seed in (1, 2)]


@pytest.mark.parametrize("shape,seed", CASES, ids=[f"{h}x{w}-seed{s}" for (h, w), s in CASES])
def test_fine_route_equals_the_cells_reference(monkeypatch, shape, seed):
    img = _tile(shape, seed)
    want = merging.labels(img)
    assert (want > 0).any() and merging.Merging(img).n_seeds > 10
    returned = []
    fine = sm.component_min_fine

    def spy(*a, **k):
        out = fine(*a, **k)
        returned.append(out[1])
        return out

    monkeypatch.setattr(sm, "component_min_fine", spy)
    _ext.reset_launches()
    got = run_levels_impl(img, None, max_water_level=254, merging=True, n_labels=1 << 24, backend="packed",
                          device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    n = dict(_ext.launches)
    assert n["merge_tail"] == 1 and n["coarsen_plain"] == 0 and len(returned) == 1
    assert n["fine_tail"] == 1 and n["fine_round"] == returned[0] == n["bwd_vh_plain"] >= 1

    _ext.reset_launches()
    coarse = run_levels_impl(img, None, max_water_level=254, merging=True, n_labels=max_seed_count(shape),
                             backend="packed", device="cpu")
    np.testing.assert_array_equal(coarse.numpy(), want)
    n = _ext.launches
    assert n["merge_tail"] == 1 and n["coarse_round_plain"] >= 1 and len(returned) == 1
    assert n["fine_tail"] == n["fine_round"] == n["bwd_vh_plain"] == 0
