"""BENCHMARK.json against the contract's shape, and every cell resolving
by name to its files; a new configuration, traffic mix or metric needs
only new files and entries."""

import json
import re
import shutil
from pathlib import Path

import pytest

from harness import spec

ROOT = spec.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def _one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_entries_keep_to_the_contract():
    confs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _one_line(c["source"]) and _one_line(c["why"])
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    assert len({c["file"] for c in BENCH["configs"]}) == len(confs)
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in confs
        assert w["chips"] in (1, 4) and _one_line(w["why"])
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(BENCH["workloads"]) == len({w["name"] for w in BENCH["workloads"]})
    assert {w["config"] for w in BENCH["workloads"]} == set(confs)
    names = set()
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        names.add(m["name"])
    assert "setup_s" in names
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in names and _one_line(m["layer"]) and set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len({m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}) == len(BENCH["end_to_end"]) + len(BENCH["per_layer"])


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_to_its_files(name):
    cell = spec.resolve(name)
    w = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert cell.config["name"] == w["config"] and cell.traffic["name"] == w["traffic"]
    for folder, mod in spec.code_files(cell.traffic):
        assert (ROOT / "portbench" / folder / f"{mod}.py").is_file()
        assert cell.module(folder, mod) is not None
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"} and len(cell.end_to_end) >= 2
    assert cell.per_layer and all(callable(cell.readers[m["name"]]) for m in cell.per_layer)


def test_total_check_time_fits():
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def _copy_bench(tmp_path) -> Path:
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


NEW_ENTRY = """
import numpy as np
from rustronomy_watershed_tpu_torch.prelude import TransformBuilder


class Entry:
    def __init__(self, cell, device):
        self.ws = TransformBuilder.default().set_device(device).build_merging()
        self.reference = lambda: cell.module("reference", cell.traffic["reference"])
        self.spans = {}

    def prepare(self, pool):
        self.inputs = [p.cpu().numpy() for p in pool]

    def call(self, i):
        img = self.inputs[i % len(self.inputs)]
        return self.ws.transform(img, self.ws.find_local_minima(img))

    def to_host(self, out):
        return np.asarray(out)

    def control(self, img):
        return self.reference().labels(img, control=True)

    def compare(self, kept, pool):
        ref = self.reference()
        bad = sum(int(np.count_nonzero(out != ref.labels(pool[i % len(pool)]))) for i, out in kept)
        return {"label_mismatch_px": (bad, 0)}
"""

NEW_LAYOUT = """
import torch


def make(shape, field, gen):
    rows = torch.rand((shape[0], 1), generator=gen, device=gen.device) < float(field["nan_frac"])
    return rows.expand(shape).clone()
"""


@pytest.mark.parametrize("what", ["config", "traffic", "metric", "entry", "nan_layout"])
def test_new_cell_needs_only_new_files(tmp_path, what):
    from harness import fields
    from harness.cell import run_cell

    root = _copy_bench(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg, traffic = "tile4096_u8", "merge_nan10"
    t = json.loads((root / "portbench/traffic/merge_nan10.json").read_text())
    if what == "config":
        cfg = "tile2048_u8"
        conf = json.loads((root / "portbench/configs/tile4096_u8.json").read_text())
        conf.update(name=cfg, shape=[2048, 2048])
        (root / "portbench/configs" / f"{cfg}.json").write_text(json.dumps(conf))
        bench["configs"].append({"name": cfg, "source": "https://example.org/x", "file": f"portbench/configs/{cfg}.json",
                                 "reduced": [], "why": "a test"})
    elif what == "traffic":
        traffic = "merge_nan30"
        t.update(name=traffic, field=dict(t["field"], nan_frac=0.3))
    elif what == "entry":
        traffic = "api_transform"
        (root / "portbench/entries/api_transform.py").write_text(NEW_ENTRY)
        t.update(name=traffic, entry="api_transform", pool=2, check={"sample": 2})
    elif what == "nan_layout":
        traffic = "merge_nan_rows"
        (root / "portbench/masks/rows.py").write_text(NEW_LAYOUT)
        t.update(name=traffic, field=dict(t["field"], nan_frac=0.2, nan_layout="rows"))
    else:
        (root / "portbench/metrics/pack.calls.py").write_text(
            "def read(ctx):\n    n = ctx.counters.get('pack', 0)\n    return n / ctx.calls if n else None\n")
        bench["per_layer"].append({"name": "pack.calls", "unit": "calls", "better": "lower", "source": "program_counter",
                                   "layer": "pack kernel", "moves": "mpix_per_s", "workloads": ["new.cell"]})
    if traffic != "merge_nan10":
        (root / "portbench/traffic" / f"{traffic}.json").write_text(json.dumps(t))
    bench["workloads"].append({"name": "new.cell", "config": cfg, "traffic": traffic, "chips": 1, "why": "a test"})
    cell = spec.resolve("new.cell", bench=bench, bench_dir=root / "portbench")
    assert cell.config["name"] == cfg and cell.traffic["name"] == traffic
    if what == "config":
        assert cell.config["shape"] == [2048, 2048]
    if what == "traffic":
        assert cell.traffic["field"]["nan_frac"] == 0.3
    if what == "metric":
        ctx = type("Ctx", (), {"counters": {"pack": 6}, "calls": 3})()
        assert cell.readers["pack.calls"](ctx) == 2
    if what == "nan_layout":
        img = fields.make_pool(cell, 5, "cpu", (64, 48))[0].numpy()
        nan_rows = (img == 255).all(axis=1)
        assert nan_rows.any() and not nan_rows.all() and ((img == 255) == nan_rows[:, None]).all()
    if what in ("entry", "nan_layout"):  # the new cell runs, and its answers are judged
        cell.config = dict(cell.config, shape=[40, 36])
        r = run_cell(cell, seed=2**31 + 3, seconds=0.05, trace=False, device="cpu")
        assert r["correct"] is True and r["attempted"] >= cell.traffic["check"]["sample"]
        assert r["compared"]["label_mismatch_px"] == {"value": 0, "limit": 0}
