"""The beam-map cell ``tile4096.segment_beam`` and the API cell
``cutout1024.transform`` on the CPU at a small size: they resolve, a run
is correct, each fault that their paths can have makes ``correct``
false, the control fails the comparison, the field kind repeats from the
seed, and their three per-layer readers on made-up windows."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from control import control_reading
from harness import fields, spec
from harness.cell import run_cell
from harness.trace import CALL_SPAN, WINDOW_SPAN, Trace

BEAM, API = "tile4096.segment_beam", "cutout1024.transform"
SMALL = {BEAM: (128, 128), API: (96, 80)}
SEED = 2**31 + 23


def small(name):
    cell = spec.resolve(name)
    cell.config = dict(cell.config, shape=list(SMALL[name]))
    return cell


def run_small(name, trace=False):
    return run_cell(small(name), seed=SEED, seconds=0.05, trace=trace, device="cpu")


def test_the_cells_resolve():
    cell = spec.resolve(BEAM)
    assert cell.chips == 1 and cell.config["name"] == "beam4096_f32" and cell.config["shape"] == [4096, 4096]
    assert cell.config["reduced"] == [] and cell.config["dtype"] == "float32" and cell.config["max_val"] == 254
    assert cell.traffic["entry"] == "e2e_map" and cell.traffic["reference"] == "segmenting_map"
    assert cell.traffic["pool"] == 4 and cell.traffic["check"]["sample"] == 4 and cell.traffic["trace_calls"] == 40
    assert cell.traffic["field"] == {"kind": "beam", "power": -3.0, "fwhm_px": 3.3}
    assert [m["name"] for m in cell.end_to_end] == ["mpix_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["preprocess.roofline_pct", "relax.sparse_calls_pct"]
    cell = spec.resolve(API)
    assert cell.chips == 1 and cell.config["name"] == "cutout1024_u8" and cell.traffic["variant"] == "segmenting"
    assert cell.traffic["entry"] == "api_transform" and cell.traffic["reference"] == "segmenting"
    assert cell.traffic["pool"] == 8 and cell.traffic["check"]["sample"] == 2 and cell.traffic["trace_calls"] == 24
    assert [m["name"] for m in cell.end_to_end] == ["mpix_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["api.transform_ms"]


def test_the_beam_field_repeats_from_the_seed_and_has_seeds():
    cell = spec.resolve(BEAM)
    a = fields.make_pool(cell, SEED, "cpu", (512, 512))
    b = fields.make_pool(cell, SEED, "cpu", (512, 512))
    c = fields.make_pool(cell, SEED + 1, "cpu", (512, 512))
    assert all(torch.equal(x, y) for x, y in zip(a, b)) and not any(torch.equal(x, y) for x, y in zip(a, c))
    assert all(x.dtype == torch.float32 and torch.isfinite(x).all() for x in a)
    ref = cell.module("reference", "segmenting_map")
    assert all(len(ref.seeds(x.numpy())) >= 100 for x in a)


@pytest.mark.parametrize("name", [BEAM, API])
def test_a_run_is_correct(name):
    r = run_small(name)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= small(name).traffic["check"]["sample"]
    assert set(r["metrics"]) == {"mpix_per_s", "setup_s"}
    assert all(v == {"value": 0, "limit": 0} for v in r["compared"].values())
    assert set(r["compared"]) == ({"level_mismatch_px", "label_mismatch_px"} if name == BEAM
                                  else {"seed_mismatch", "label_mismatch_px"})


@pytest.mark.parametrize("name", [BEAM, API])
def test_a_traced_run_on_the_cpu_reads_no_device_metric(name):
    r = run_small(name, trace=True)
    assert r["correct"] is True and "busy_s" in r["device"]
    assert set(r["metrics"]) == (set() if name == BEAM else {"api.transform_ms"})


# -- faults planted under the timed path: each must make `correct` false ----


def _level_off_by_one(real):
    def call(self, i):
        u8, labels = real(self, i)
        u8 = u8.clone()
        u8[u8.shape[0] // 2, u8.shape[1] // 2] += 1
        return u8, labels
    return call


def _float64_quantiser(real):
    """The host float64 pre-processor in the device one's place."""
    def call(self, i):
        from rustronomy_watershed_tpu_torch.ops import watershed_e2e
        from rustronomy_watershed_tpu_torch.ops.preprocess import pre_process

        u8 = torch.from_numpy(pre_process(self.inputs[i % len(self.inputs)].numpy(), self.max_val))
        return u8, watershed_e2e(u8, merging=False, device="cpu")
    return call


def _seed_dropped_map(real):
    def call(self, i):
        from rustronomy_watershed_tpu_torch.prelude import TransformBuilder

        u8, _ = real(self, i)
        img = u8.numpy()
        ws = TransformBuilder.default().set_device("cpu").build_segmenting()
        return u8, torch.from_numpy(np.asarray(ws.transform(img, ws.find_local_minima(img)[1:])))
    return call


def _max_label_map(real):
    def call(self, i):
        u8, _ = real(self, i)
        return u8, torch.from_numpy(self.reference().segmenting.labels(u8.numpy(), control=True))
    return call


def _pixel_uncoloured_map(real):
    def call(self, i):
        u8, labels = real(self, i)
        labels = labels.clone()
        labels[labels.shape[0] // 2, labels.shape[1] // 2] = 0
        return u8, labels
    return call


def _seed_dropped_api(real):
    def call(self, i):
        img = self.inputs[i % len(self.inputs)]
        seeds = self.ws.find_local_minima(img)[1:]
        return seeds, self.ws.transform(img, seeds)
    return call


def _max_label_api(real):
    def call(self, i):
        seeds, _ = real(self, i)
        return seeds, self.reference().labels(self.inputs[i % len(self.inputs)], control=True)
    return call


def _pixel_uncoloured_api(real):
    def call(self, i):
        seeds, labels = real(self, i)
        labels = labels.copy()
        labels[labels.shape[0] // 2, labels.shape[1] // 2] = 0
        return seeds, labels
    return call


def _boundary_in_every_map(monkeypatch, cell):
    """Each pool map gets a value on which float32 and float64 round to
    different levels, so that a float64 quantiser shows on every map."""
    kind, ref = cell.module("fields", "beam"), cell.module("reference", "segmenting_map")
    make = kind.make

    def planted(shape, field, gen):
        m = make(shape, field, gen)
        m[shape[0] // 2, shape[1] // 3] = float(ref.boundary_value(m.numpy()))
        return m
    monkeypatch.setattr(kind, "make", planted)


@pytest.mark.parametrize("fault,number", [
    (_level_off_by_one, "level_mismatch_px"), (_float64_quantiser, "level_mismatch_px"),
    (_seed_dropped_map, "label_mismatch_px"), (_max_label_map, "label_mismatch_px"),
    (_pixel_uncoloured_map, "label_mismatch_px"),
])
def test_a_broken_map_path_is_not_correct(monkeypatch, fault, number):
    cell = small(BEAM)
    cls = cell.module("entries", "e2e_map").Entry
    monkeypatch.setattr(cls, "call", fault(cls.call))
    if fault is _float64_quantiser:
        _boundary_in_every_map(monkeypatch, cell)
    r = run_cell(cell, seed=SEED, seconds=0.05, trace=False, device="cpu")
    assert r["correct"] is False and r["compared"][number]["value"] > 0


@pytest.mark.parametrize("fault,numbers", [
    (_seed_dropped_api, ("seed_mismatch", "label_mismatch_px")), (_max_label_api, ("label_mismatch_px",)),
    (_pixel_uncoloured_api, ("label_mismatch_px",)),
])
def test_a_broken_api_path_is_not_correct(monkeypatch, fault, numbers):
    cls = spec.resolve(API).module("entries", "api_transform").Entry
    monkeypatch.setattr(cls, "call", fault(cls.call))
    r = run_small(API)
    assert r["correct"] is False and all(r["compared"][k]["value"] > 0 for k in numbers)


@pytest.mark.parametrize("name", [BEAM, API])
def test_control_fails_the_comparison(name):
    compared = control_reading(small(name), SEED, "cpu")
    h, w = SMALL[name]
    assert 0 < compared["label_mismatch_px"] < 4 * h * w
    assert compared.get("level_mismatch_px", 0) == 0 and compared.get("seed_mismatch", 0) == 0


# -- the three readers on made-up windows -------------------------------------


def _ev(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 0, "tid": tid}


ELEM = "void at::native::vectorized_elementwise_kernel<4, at::native::AbsFunctor<float>>(int, float)"


def _trace():
    """Two calls; in each, ``rwt.pre_process`` launches three operations
    (host 10-40 us), which run on the device after the span has closed
    (50-110 us), then ``rwt.api.transform`` spans the rest, with a launch
    of its own; one operation runs between the calls."""
    ev = [_ev(WINDOW_SPAN, "user_annotation", 0, 1000)]
    for c in (0, 500):
        ev += [
            _ev(CALL_SPAN, "user_annotation", c, 400),
            _ev("rwt.pre_process", "user_annotation", c + 10, 30),
            _ev("cudaLaunchKernel", "cuda_runtime", c + 12, 3),
            _ev("cudaLaunchKernel", "cuda_runtime", c + 20, 3),
            _ev("cudaMemsetAsync", "cuda_runtime", c + 30, 3),
            _ev(ELEM, "kernel", c + 50, 20, tid=7),
            _ev(ELEM, "kernel", c + 70, 20, tid=7),
            _ev("Memset (Device)", "gpu_memset", c + 90, 20, tid=7),
            _ev("rwt.api.transform", "user_annotation", c + 40, 300 + c // 50),
            _ev("cudaLaunchKernel", "cuda_runtime", c + 45, 3),
            _ev("void pack_bands<true>(unsigned char const*)", "kernel", c + 110, 5, tid=7),
        ]
    return Trace(ev + [_ev(ELEM, "kernel", 450, 30, tid=7)])


def _readers(name):
    return spec.resolve(name).readers


def test_preprocess_roofline_counts_the_operations_launched_in_the_span():
    px = 4096 * 4096
    ctx = SimpleNamespace(calls=2, counters={"pre_process_px": 2 * px}, trace=_trace(), shape=(4096, 4096), spans={})
    want = 100 * 2 * px * 5 / 3.35e12 / 120e-6  # 2 calls x 60 us of device time
    assert _readers(BEAM)["preprocess.roofline_pct"](ctx) == pytest.approx(want)


def test_sparse_calls_share():
    ctx = SimpleNamespace(calls=2, counters={"relax": 300, "relax_calls_sparse": 210}, trace=_trace(),
                          shape=(4096, 4096), spans={})
    assert _readers(BEAM)["relax.sparse_calls_pct"](ctx) == pytest.approx(70.0)
    ctx.counters = {"relax": 8}
    assert _readers(BEAM)["relax.sparse_calls_pct"](ctx) == 0.0


def test_api_transform_median():
    ctx = SimpleNamespace(calls=2, counters={}, trace=_trace(), shape=(1024, 1024), spans={})
    assert _readers(API)["api.transform_ms"](ctx) == pytest.approx(0.305)


def test_the_readers_on_a_program_without_the_spans_and_counters(monkeypatch):
    """The parent's program has neither the spans nor the counters: each
    reader returns None, and raises nothing."""
    from rustronomy_watershed_tpu_torch import _ext

    monkeypatch.delitem(_ext.launches, "relax_calls_sparse")
    monkeypatch.delitem(_ext.launches, "pre_process_px")
    bare = Trace([_ev(WINDOW_SPAN, "user_annotation", 0, 1000), _ev(CALL_SPAN, "user_annotation", 0, 400),
                  _ev(ELEM, "kernel", 50, 20, tid=7)])
    ctx = SimpleNamespace(calls=2, counters={"relax": 300, "relax_tiles": 800}, trace=bare, shape=(4096, 4096),
                          spans={})
    readers = {**_readers(BEAM), **_readers(API)}
    assert len(readers) == 3 and all(fn(ctx) is None for fn in readers.values())
