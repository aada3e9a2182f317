"""Load a file of the benchmark by its folder and name.

Everything that belongs to one entry, one field kind, one NaN layout, one
reference or one per-layer metric is a file ``<bench>/<folder>/<name>.py``
that the harness finds by the name that a configuration, a traffic mix or
BENCHMARK.json gives; a new one is a new file, and no harness file changes.
"""

from __future__ import annotations

import hashlib
import importlib.util
import re
from pathlib import Path

_LOADED: dict = {}


def path_of(bench_dir: Path, folder: str, name: str) -> Path:
    return Path(bench_dir) / folder / f"{name}.py"


def load(bench_dir: Path, folder: str, name: str):
    """The module ``<bench_dir>/<folder>/<name>.py``, loaded once."""
    path = path_of(bench_dir, folder, name).resolve()
    if not path.is_file():
        raise KeyError(f"no {folder} file {name!r} ({path})")
    key = str(path)
    if key not in _LOADED:
        tag = hashlib.sha1(key.encode()).hexdigest()[:8]
        spec = importlib.util.spec_from_file_location(f"portbench_{folder}_{re.sub(r'\W', '_', name)}_{tag}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[key] = mod
    return _LOADED[key]
