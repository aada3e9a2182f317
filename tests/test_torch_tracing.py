"""``rustronomy_watershed_tpu_torch.utils.tracing`` (``trace``,
``trace_artifacts`` and ``step_annotation`` on ``torch.profiler``): a CPU
transform leaves a real trace file, and every capture failure is a loud
RuntimeWarning while the traced block still runs, as the JAX package's
``utils/tracing.py`` rules (tests/test_api.py::test_tracing_context)."""

import json
import warnings

import numpy as np
import pytest
import torch

from rustronomy_watershed_tpu_torch.prelude import TransformBuilder
from rustronomy_watershed_tpu_torch.utils import tracing
from rustronomy_watershed_tpu_torch.utils.tracing import step_annotation, trace, trace_artifacts


def _transform():
    img = np.random.default_rng(3).integers(0, 20, (24, 28)).astype(np.uint8)
    ws = TransformBuilder().set_device("cpu").set_max_water_lvl(12).build_segmenting()
    return ws.transform(img, ws.find_local_minima(img))


def _traced(log_dir, **kw):
    """``(result, runtime warnings)`` of the transform under ``trace``."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with trace(log_dir, **kw):
            with step_annotation("level 3"):
                out = _transform()
    return out, [str(c.message) for c in caught if issubclass(c.category, RuntimeWarning)]


def test_cpu_transform_leaves_a_trace_with_its_annotation(tmp_path):
    out, warned = _traced(tmp_path)
    np.testing.assert_array_equal(out, _transform())
    assert warned == []
    (art,) = trace_artifacts(tmp_path)
    assert art.name.endswith(".pt.trace.json") and art.stat().st_size > 0
    events = json.loads(art.read_text())["traceEvents"]
    assert any(e.get("name") == "level 3" for e in events)
    assert any(e.get("cat") == "cpu_op" for e in events)
    # A second session in the same log dir is checked against the files
    # that were there before it.
    _, warned = _traced(tmp_path)
    assert warned == [] and len(trace_artifacts(tmp_path)) == 2


def test_a_profiler_that_fails_to_start_warns_and_the_block_runs(tmp_path, monkeypatch):
    class Refusing:
        def __init__(self, *a, **k):
            pass

        def start(self):
            raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", Refusing)
    out, warned = _traced(tmp_path)
    np.testing.assert_array_equal(out, _transform())
    assert len(warned) == 1 and "failed to start" in warned[0] and "UNTRACED" in warned[0]
    assert trace_artifacts(tmp_path) == []


def test_a_profiler_that_fails_to_stop_warns(tmp_path, monkeypatch):
    real = torch.profiler.profile

    class Unstoppable(real):
        def stop(self):
            super().stop()
            raise RuntimeError("stuck")

    monkeypatch.setattr(torch.profiler, "profile", Unstoppable)
    out, warned = _traced(tmp_path)
    np.testing.assert_array_equal(out, _transform())
    assert len(warned) == 1 and "failed to stop" in warned[0]


def test_a_session_that_leaves_no_trace_file_warns(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.profiler, "tensorboard_trace_handler", lambda d: lambda prof: None)
    out, warned = _traced(tmp_path)
    np.testing.assert_array_equal(out, _transform())
    assert len(warned) == 1 and "no trace file" in warned[0]
    _, warned = _traced(tmp_path, check=False)
    assert warned == []


def test_a_session_with_launches_but_no_device_kernel_warns(tmp_path, monkeypatch):
    """The torch form of a backend that accepts the session but exports
    nothing: kernel launches among the CPU events, no kernel on the
    device."""
    monkeypatch.setattr(tracing, "_events", lambda prof: [("aten::add", False), ("cudaLaunchKernel", False),
                                                          ("Memcpy HtoD (Pageable -> Device)", True)])
    out, warned = _traced(tmp_path)
    np.testing.assert_array_equal(out, _transform())
    assert len(warned) == 1 and "no kernel on the device" in warned[0]
    assert trace_artifacts(tmp_path)


@pytest.mark.parametrize("events,silent", [
    ([], True),
    ([("aten::add", False)], True),  # a CPU transform launches nothing
    ([("cudaLaunchKernel", False), ("void relax_kernel<false, false>(...)", True)], True),
    ([("cuLaunchKernel", False), ("pack_bands", True)], True),
    ([("cudaLaunchKernel", False)], False),
    ([("cuLaunchKernel", False), ("Memset (Device)", True)], False),
])
def test_launches_without_kernels(events, silent):
    assert tracing.launches_without_kernels(events) is not silent


def test_tracing_context_mirrors_jax(tmp_path):
    """tests/test_api.py::test_tracing_context on the port: real artifacts
    and no warning, or a warning and no artifact; never silent loss."""
    img = np.random.default_rng(42).integers(0, 5, size=(8, 8)).astype(np.uint8)
    ws = TransformBuilder().set_device("cpu").set_max_water_lvl(3).build_segmenting()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        with trace(tmp_path):
            ws.transform(img, ws.find_local_minima(img))
    arts = trace_artifacts(tmp_path)
    if arts:
        assert all(a.stat().st_size > 0 for a in arts)
        assert not any(issubclass(x.category, RuntimeWarning) and "trace" in str(x.message).lower() for x in w)
    else:
        assert any(issubclass(x.category, RuntimeWarning) for x in w), "no artifact and no warning: silent trace loss"
