"""The beam-smoothed survey map on the CPU: float32 maps drawn by the
benchmark's field kind (portbench/fields/beam.py, loaded by its path) are
quantised by ``ops.pre_process_jnp`` and segmented by ``watershed_e2e``,
and both equal the plain map reference (portbench/reference/
segmenting_map.py) bit for bit; a quantiser in float64 does not.  Also:
the map's plateaus really work the long relax fixed point, the
pre-processor's and the API transform's spans and counters, the sparse
relax call count at its one-eighth boundary, and the segmenting API's
``find_local_minima`` + ``transform`` against reference/segmenting.py."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from rustronomy_watershed_tpu_torch import _ext
from rustronomy_watershed_tpu_torch.ops import relax
from rustronomy_watershed_tpu_torch.ops.pipeline import watershed_e2e
from rustronomy_watershed_tpu_torch.ops.preprocess import pre_process_jnp
from rustronomy_watershed_tpu_torch.prelude import TransformBuilder
from rustronomy_watershed_tpu_torch.utils.tracing import trace, trace_artifacts

_BENCH = Path(__file__).resolve().parents[1] / "portbench"


def _load(rel):
    spec = importlib.util.spec_from_file_location("portbench_" + rel.replace("/", "_")[:-3], _BENCH / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


beam = _load("fields/beam.py")
ref = _load("reference/segmenting_map.py")
FIELD = json.loads((_BENCH / "traffic" / "segment_beam.json").read_text())["field"]
MAPS = [(n, seed) for n in (128, 256, 512) for seed in (1, 2)]
_CACHE = {}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the relax twin's ~150 calls of small ops a map
    slow down many times over when the suite's workers share the cores
    and each op spreads over all of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def beam_map(n, seed) -> np.ndarray:
    """The cell's field kind at ``n`` x ``n`` from a CPU generator."""
    if (n, seed) not in _CACHE:
        gen = torch.Generator()
        gen.manual_seed(seed)
        _CACHE[n, seed] = beam.make((n, n), FIELD, gen).numpy()
    return _CACHE[n, seed]


@pytest.mark.parametrize("n,seed", MAPS)
def test_pre_process_equals_the_reference_quantiser(n, seed):
    m = beam_map(n, seed)
    assert m.dtype == np.float32 and np.isfinite(m).all()
    got = pre_process_jnp(m, 254, device="cpu").numpy()
    want = ref.levels(m, 254)
    assert got.dtype == want.dtype == np.uint8 and np.array_equal(got, want)
    assert want.min() == 0 and want.max() == 254 and len(np.unique(want)) > 200


@pytest.mark.parametrize("n,seed", MAPS)
def test_watershed_e2e_labels_equal_the_reference(n, seed):
    m = beam_map(n, seed)
    _ext.reset_launches()
    got = watershed_e2e(pre_process_jnp(m, 254, device="cpu"), merging=False, device="cpu").numpy()
    assert np.array_equal(got, ref.labels(m))
    if n == 512:  # the plateaus work the long fixed point (a uniform tile takes ~4 calls)
        assert _ext.launches["relax_plain"] >= 40


@pytest.mark.parametrize("n,seed", MAPS)
def test_a_float64_quantiser_fails_the_level_comparison(n, seed):
    """Where the drawn map has no pixel on which float32 and float64
    round to different levels, one is placed at a level boundary, inside
    the map's range."""
    m = beam_map(n, seed).copy()
    if np.array_equal(ref.levels(m, dtype=torch.float64), ref.levels(m)):
        m[n // 2, n // 3] = ref.boundary_value(m)
    f64 = ref.levels(m, dtype=torch.float64)
    assert 0 < np.count_nonzero(f64 != pre_process_jnp(m, 254, device="cpu").numpy()) < m.size // 1000 + 8
    assert np.array_equal(pre_process_jnp(m, 254, device="cpu").numpy(), ref.levels(m))


def test_the_field_gives_plateaus_and_seeds():
    m = beam_map(512, 1)
    lv = ref.levels(m)
    assert 100 <= len(ref.seeds(m)) < 1000 and np.array_equal(beam_map(512, 1), m)
    assert np.count_nonzero(lv[1:, :] == lv[:-1, :]) > 0.1 * lv.size  # a vertical neighbour on the same level


def _span_names(log_dir) -> list:
    (art,) = trace_artifacts(log_dir)
    events = json.loads(art.read_text())["traceEvents"]
    return [e["name"] for e in events if e.get("ph") == "X" and e.get("name", "").startswith("rwt.")]


def test_pre_process_and_transform_spans_in_a_cpu_trace(tmp_path):
    m = beam_map(128, 1)
    ws = TransformBuilder.default().set_device("cpu").build_segmenting()
    with trace(tmp_path):
        u8 = pre_process_jnp(m, 254, device="cpu").numpy()
        ws.transform(u8, ws.find_local_minima(u8))
    names = _span_names(tmp_path)
    assert names.count("rwt.pre_process") == 1 and names.count("rwt.api.transform") == 1
    assert {"rwt.api.prepare", "rwt.driver.relax"} <= set(names)


@pytest.mark.parametrize("shape", [(128, 128), (3, 40, 24), (7,)])
def test_pre_process_px_counts_the_plane(shape):
    _ext.reset_launches()
    x = torch.randn(shape, generator=torch.Generator().manual_seed(4))
    pre_process_jnp(x, 254, device="cpu")
    pre_process_jnp(x.numpy(), 20, device="cpu")
    assert _ext.launches["pre_process_px"] == 2 * x.numel()


@pytest.mark.parametrize("n_tiles,run,sparse", [
    (64, 8, False), (64, 7, True), (64, 0, True), (64, 64, False),
    (1369, 172, False), (1369, 171, True), (8, 1, False), (8, 0, True),
])
def test_tiles_count_sparse_at_one_eighth(n_tiles, run, sparse):
    """A call is sparse when the tiles it ran are fewer than an eighth of
    the plan's: exactly ``n_tiles / 8`` is not, one fewer is (synthetic
    words: three flags, the skipped count, the pixels run)."""
    tiles = relax._Tiles({"n_tiles": n_tiles, "skip": True}, 3, "cpu")
    _ext.reset_launches()
    flags, skipped = tiles.count([1, 1, 0, n_tiles - run, 5, 0])
    assert (flags, skipped) == ([1, 1, 0], n_tiles - run)
    assert _ext.launches["relax_calls_sparse"] == int(sparse)
    assert _ext.launches["relax_tiles_skipped"] == n_tiles - run and _ext.launches["relax_px_run"] == 5


def _fields(kind, shape, seed):
    if kind == "uniform":
        return np.random.default_rng(seed).integers(0, 254, shape).astype(np.uint8)
    gen = torch.Generator()
    gen.manual_seed(seed)
    return ref.levels(beam.make(shape, FIELD, gen).numpy())


@pytest.mark.parametrize("kind", ["uniform", "beam"])
@pytest.mark.parametrize("shape", [(64, 64), (96, 160), (256, 256)])
def test_segmenting_api_equals_the_reference(kind, shape):
    img = _fields(kind, shape, 11)
    ws = TransformBuilder.default().set_device("cpu").build_segmenting()
    seeds = ws.find_local_minima(img)
    assert np.array_equal(np.asarray(seeds, dtype=np.int64).reshape(-1, 2), ref.segmenting.seeds(img))
    got = ws.transform(img, seeds)
    assert got.dtype == np.int32 and np.array_equal(got, ref.segmenting.labels(img))
