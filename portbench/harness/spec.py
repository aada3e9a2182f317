"""Find a cell's configuration, traffic mix and per-layer metric readers by
the names in BENCHMARK.json.

Everything that belongs to one configuration, one traffic mix or one
metric sits in a file of its own under ``portbench/``:

* ``configs/<config>.json``: the deployment (shape, value range,
  guarantees, what was assumed and reduced);
* ``traffic/<traffic>.json``: data only: the parameters that
  ``harness/fields.py`` turns into inputs (a field kind of
  ``fields/<kind>.py``, a NaN layout of ``masks/<layout>.py``), the entry
  of ``entries/<entry>.py`` that the window drives, and the plain
  reference of ``reference/<reference>.py`` that judges its answers;
* ``metrics/<metric>.py``: a ``read(ctx)`` that returns the metric's value
  from a traced window, or None when it finds nothing to read.

A new cell adds such files and entries; no harness file changes.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

from . import plugins

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    readers: dict = field(default_factory=dict)
    bench_dir: Path = BENCH_DIR

    def module(self, folder: str, name: str):
        """The cell's ``<folder>/<name>.py`` (an entry, field kind, NaN
        layout or reference)."""
        return plugins.load(self.bench_dir, folder, name)


def load_bench(path: Path | None = None) -> dict:
    with open(path or ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def code_files(traffic: dict) -> list:
    """``(folder, name)`` of every code file the traffic mix names."""
    out = [("entries", traffic["entry"]), ("reference", traffic["reference"]), ("fields", traffic["field"]["kind"])]
    if traffic["field"].get("nan_frac"):
        out.append(("masks", traffic["field"]["nan_layout"]))
    return out


def resolve(name: str, bench: dict | None = None, bench_dir: Path | None = None) -> Cell:
    """The cell ``name`` of BENCHMARK.json with its files found."""
    bench = bench if bench is not None else load_bench()
    bench_dir = Path(bench_dir or BENCH_DIR)
    root = bench_dir.parent
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({', '.join(cells)})")
    w = cells[name]
    confs = {c["name"]: c for c in bench["configs"]}
    conf = dict(_load_json(root / confs[w["config"]]["file"]))
    traffic = _load_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    for folder, mod in code_files(traffic):
        if not plugins.path_of(bench_dir, folder, mod).is_file():
            raise KeyError(f"traffic {w['traffic']!r} names {folder}/{mod}.py, which does not exist")
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    per_layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    readers = {m["name"]: plugins.load(bench_dir, "metrics", m["name"]).read for m in per_layer}
    return Cell(name, int(w["chips"]), conf, traffic, e2e, per_layer, readers, bench_dir)
