"""One run of one cell: inputs from the seed, warm-up, the measured
window, the check against the plain reference, and the result line."""

from __future__ import annotations

import gc
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np

from . import fields
from .guard import forbidden_modules
from .spec import Cell
from .trace import CALL_SPAN, WINDOW_SPAN, read_profile


def process_age_s() -> float:
    """Seconds since this process started (``/proc``: the set-up clock
    starts before the interpreter does)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start_ticks / os.sysconf("SC_CLK_TCK")


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def p95(values) -> float:
    """The 95th percentile (linear between order statistics)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95))


def _say(*a):
    print(*a, file=sys.stderr, flush=True)


class Reservoir:
    """A uniform sample of ``k`` of the window's calls, drawn from the seed
    (reservoir sampling): every call of the window, the last included, is
    kept with the same chance, whatever the window's length."""

    def __init__(self, k: int, seed: int):
        self.k = int(k)
        self.rng = np.random.default_rng([int(seed) % (1 << 64), 0x5EED])
        self.kept = []

    def offer(self, n: int, answer) -> None:
        if n < self.k:
            self.kept.append((n, answer))
        else:
            j = int(self.rng.integers(0, n + 1))
            if j < self.k:
                self.kept[j] = (n, answer)


def run_cell(cell: Cell, *, seed: int, seconds: float, trace: bool, device: str = "cuda") -> dict:
    """Run the cell once and return the result object."""
    import torch

    from rustronomy_watershed_tpu_torch import _ext

    marks = [("imports", process_age_s())]
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.empty(1, device=dev)
        torch.cuda.synchronize(dev)
        marks.append(("cuda context", process_age_s()))
    shape = tuple(cell.config["shape"])
    pix = shape[0] * shape[1]
    pool = fields.make_pool(cell, seed, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    marks.append(("inputs", process_age_s()))
    entry = cell.module("entries", cell.traffic["entry"]).Entry(cell, dev)
    entry.prepare(pool)
    marks.append(("prepared", process_age_s()))
    sample = Reservoir(cell.traffic["check"]["sample"], seed)
    held = []
    for i in range(len(pool)):  # warm-up: every pool image once, as many answers held as the window keeps
        held = (held + [entry.call(i)])[-sample.k:]
    del held
    marks.append(("warm-up", process_age_s()))
    _say("set-up by the process clock (s): " + ", ".join(f"{k} {v:.2f}" for k, v in marks))
    for v in entry.spans.values():
        v.clear()
    trace_calls = int(cell.traffic["trace_calls"]) if trace else None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    gc.collect()
    _ext.reset_launches()

    lat, failed, n = [], 0, 0
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
    setup_s = process_age_s()
    with torch.profiler.record_function(WINDOW_SPAN):
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            now = time.perf_counter()
            if n >= sample.k and (now >= deadline or (trace_calls is not None and n >= trace_calls)):
                break
            a = time.perf_counter()
            try:
                with torch.profiler.record_function(CALL_SPAN):
                    out = entry.call(n)
            except Exception as exc:  # a failed call counts; the window goes on
                _say(f"call {n} failed: {type(exc).__name__}: {exc}")
                failed += 1
                out = None
            lat.append((time.perf_counter() - a) * 1e3)
            sample.offer(n, out)
            del out
            n += 1
        t_end = time.perf_counter()
    if prof is not None:
        prof.__exit__(None, None, None)
    window_s = t_end - t0
    counters = {k: v for k, v in _ext.launches.items() if v}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    # After the window: the program's answers and the inputs to the host,
    # its state freed, then the reference.
    kept = sorted((i, None if out is None else entry.to_host(out)) for i, out in sample.kept)
    sample.kept = []
    pool = [p.cpu().numpy() for p in pool]
    entry.inputs = None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    compared = entry.compare(kept, pool)
    ref_s = time.perf_counter() - t_ref

    _say(f"cell {cell.name} seed {seed}: {n} calls in {window_s:.3f} s, {failed} failed; "
         f"latency samples {len(lat)}; checked calls {[i for i, _ in kept]}; reference {ref_s:.3f} s; "
         f"counters {counters}")
    metrics = {}
    if not trace:
        done_pix = pix * (n - failed)
        values = {"mpix_per_s": done_pix / window_s / 1e6, "latency_p95_ms": p95(lat), "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        q = np.percentile(np.asarray(lat), [50, 90, 95, 99])
        _say(f"latency over {len(lat)} calls: p50 {q[0]} p90 {q[1]} p95 {q[2]} p99 {q[3]} ms")
        _say("mean latency by tenth of the window's calls (ms): "
             + " ".join(f"{float(np.mean(c)):.4f}" for c in np.array_split(np.asarray(lat), 10) if len(c)))
    dev_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": 1,
        "memory_peak_bytes": int(peak),
    }
    result = {"correct": None, "attempted": n, "failed": failed, "metrics": metrics, "device": dev_info}
    if trace:
        tr = read_profile(prof)
        ctx = SimpleNamespace(calls=n, counters=counters, trace=tr, spans=entry.spans, shape=shape,
                              config=cell.config, traffic=cell.traffic)
        for m in cell.per_layer:
            v = cell.readers[m["name"]](ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev_info["busy_s"] = tr.busy_us / 1e6
        dev_info["window_s"] = tr.window_us / 1e6
        result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    if dev.type == "cuda":
        dev_info["power"] = power_limit()
    ok = failed == 0 and len(kept) == sample.k and all(v <= lim for v, lim in compared.values())
    result["correct"] = bool(ok)
    result["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    bad = forbidden_modules(sys.modules)
    if bad:
        raise ForbiddenImport(bad)
    return result


class ForbiddenImport(RuntimeError):
    def __init__(self, names):
        super().__init__(f"the run loaded {', '.join(names)} (JAX or the JAX package)")
        self.names = names
