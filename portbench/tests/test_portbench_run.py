"""A run of each cell driven on the CPU at a small size (the harness's look
for a card skipped): the result line's schema, the import guard, the
faults that must make ``correct`` false, the control, and the reference
against the port.  The ``cuda`` tests run the real command on a card."""

import json
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from control import control_reading
from harness import plugins, spec
from harness.cell import ForbiddenImport, run_cell
from harness.guard import forbidden_modules
from reference.merging import Merging, seeds

SMALL = {"tile4096.merge_nan10": (96, 80), "cutout1024.to_list": (48, 56)}
SEED = 2**31 + 77


def small(name):
    cell = spec.resolve(name)
    cell.config = dict(cell.config, shape=list(SMALL[name]))
    return cell


def run_small(name):
    return run_cell(small(name), seed=SEED, seconds=0.05, trace=False, device="cpu")


def entry_class(name):
    cell = spec.resolve(name)
    return cell.module("entries", cell.traffic["entry"]).Entry


@pytest.mark.parametrize("name", sorted(SMALL))
def test_last_line_schema(name):
    r = run_small(name)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"] and list(r)[-1] == "compared"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= r["attempted"] > 0
    cell = spec.resolve(name)
    assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end:
        v = r["metrics"][m["name"]]
        assert set(v) == {"value", "unit"} and v["unit"] == m["unit"] and v["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])
    assert all(set(v) == {"value", "limit"} and v["value"] == 0 == v["limit"] for v in r["compared"].values())
    json.dumps(r)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_traced_run_reports_per_layer_metrics(name):
    r = run_cell(small(name), seed=SEED, seconds=0.05, trace=True, device="cpu")
    assert r["correct"] is True and "window_s" in r["device"] and "busy_s" in r["device"]
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    per_layer = {m["name"] for m in spec.resolve(name).per_layer}
    assert set(r["metrics"]) <= per_layer  # CPU twins launch no kernel: device metrics read nothing


def test_runner_refuses_a_host_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    p = subprocess.run([sys.executable, str(spec.BENCH_DIR / "run.py"), "--workload", "tile4096.merge_nan10",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_import_guard_compares_whole_top_level_names():
    assert forbidden_modules(["rustronomy_watershed_tpu_torch.ops", "rustronomy_watershed_tpu_torch", "jaxtyping"]) == []
    assert forbidden_modules(["rustronomy_watershed_tpu.ops"]) == ["rustronomy_watershed_tpu"]
    assert forbidden_modules(["jax.numpy", "jaxlib", "flax.linen", "numpy"]) == ["flax", "jax", "jaxlib"]


def test_a_run_that_loaded_jax_prints_no_result(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(ForbiddenImport) as e:
        run_small("tile4096.merge_nan10")
    assert e.value.names == ["jax"]


# -- faults planted under the timed path: each must make `correct` false ----


def _e2e_unchanged(real):
    """The step returns its state unchanged: the painted seeds, unflooded."""
    def call(self, i):
        img = self.inputs[i % len(self.inputs)].numpy()
        lab = np.zeros(img.shape, np.int32)
        s = seeds(img)
        lab[s[:, 0], s[:, 1]] = np.arange(1, len(s) + 1)
        return torch.from_numpy(lab)
    return call


def _e2e_altered(real):
    """One label altered where it is produced."""
    def call(self, i):
        out = real(self, i).clone()
        out[out.shape[0] // 2, out.shape[1] // 2] += 1
        return out
    return call


def _list_unchanged(real):
    """Every level's row left as level 0's."""
    def call(self, i):
        s, rows = real(self, i)
        return s, [(lvl, rows[0][1].copy()) for lvl, _ in rows]
    return call


def _list_altered(real):
    """One entry of one row altered where it is produced."""
    def call(self, i):
        s, rows = real(self, i)
        rows[100][1][1] += 1
        return s, rows
    return call


def _list_seed_dropped(real):
    def call(self, i):
        s, rows = real(self, i)
        return s[1:], rows
    return call


@pytest.mark.parametrize("name,fault", [
    ("tile4096.merge_nan10", _e2e_unchanged),
    ("tile4096.merge_nan10", _e2e_altered),
    ("cutout1024.to_list", _list_unchanged),
    ("cutout1024.to_list", _list_altered),
    ("cutout1024.to_list", _list_seed_dropped),
])
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    cls = entry_class(name)
    monkeypatch.setattr(cls, "call", fault(cls.call))
    r = run_small(name)
    assert r["correct"] is False
    assert any(v["value"] > v["limit"] for v in r["compared"].values())


def test_a_failing_call_is_not_correct(monkeypatch):
    cls, made = entry_class("tile4096.merge_nan10"), []
    real = cls.call

    def call(self, i):
        made.append(i)
        if len(made) == 6:  # the window's second call, after the 4 warm-up calls
            raise RuntimeError("planted")
        return real(self, i)
    monkeypatch.setattr(cls, "call", call)
    r = run_small("tile4096.merge_nan10")
    assert r["correct"] is False and r["failed"] == 1


# -- the control: the reference with the max-label rule in the program's place


@pytest.mark.parametrize("name", sorted(SMALL))
def test_control_fails_the_comparison(name):
    cell = small(name)
    compared = control_reading(cell, SEED, "cpu")
    assert any(v > 0 for v in compared.values())
    # It fails by its labels, not by a shape the program would never give.
    if name == "cutout1024.to_list":
        k = cell.traffic["check"]["sample"]
        width = int(np.prod(SMALL[name])) + 1
        assert 0 < compared["curve_mismatch"] < k * 255 * width and compared["seed_mismatch"] == 0


# -- the reference against the port (its CPU twins), which the JAX package holds


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("nan", [0.0, 0.1, 0.4])
def test_reference_equals_the_port_on_the_cpu(seed, nan):
    from rustronomy_watershed_tpu_torch.ops import watershed_e2e
    from rustronomy_watershed_tpu_torch.prelude import TransformBuilder

    rng = np.random.default_rng(seed)
    img = rng.integers(0, 254 if seed % 2 else 5, (37, 29)).astype(np.uint8)
    img[rng.random(img.shape) < nan] = 255
    ref = Merging(img)
    out = watershed_e2e(torch.from_numpy(img), merging=True, device="cpu").numpy()
    assert np.array_equal(out, ref.labels())
    ws = TransformBuilder.default().set_device("cpu").build_merging()
    s = ws.find_local_minima(img)
    assert np.array_equal(np.asarray(s, dtype=np.int64).reshape(-1, 2), seeds(img))
    curve_mismatch = plugins.load(spec.BENCH_DIR, "entries", "api_to_list").curve_mismatch
    assert curve_mismatch(ws.transform_to_list(img, s), ref.curve(), img.size + 1) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_command_on_a_card(cuda_device, name):
    p = subprocess.run([sys.executable, str(spec.BENCH_DIR / "run.py"), "--workload", name, "--seed", str(SEED),
                        "--seconds", "3", "--trace", "0"], capture_output=True, text=True, timeout=600,
                       cwd=spec.ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["device"]["platform"] == "gpu"
