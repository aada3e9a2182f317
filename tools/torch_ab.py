#!/usr/bin/env python3
"""Time the PyTorch port's end-to-end transforms of one or more checkouts,
in turns, on one NVIDIA GPU.

    python3 tools/torch_ab.py [--profile] [--side N] [--level-sweep] DIR [DIR ...]

Each DIR is the root of a checkout of this repository (``.`` for this one);
name a DIR twice to run it twice, e.g. ``old new new old`` for an A/B on one
card.  For each DIR in the order given, a fresh process imports the port from
that checkout (building its kernels there) and times ``watershed_e2e`` on the
4096^2 fields of ``bench.py`` (N^2 with ``--side N``): the uniform u8 field
``default_rng(0).integers(0, 254)`` and the same draw with 10% of its pixels
set to 255 (NaN dots).  Segmenting on the uniform field; merging on both, where the checkout
serves it; at 4096^2 and below also NaN-dot merging on the legacy coarse
rounds (``RWT_COARSE_MULTI=0``).  Median of 9 warm runs, CUDA events around
each call (the host's flag reads inside), and the host's time to issue one
relax call of the merging path (``relax_host_us``: launches only, no flag
read).  ``--profile`` also traces 5 runs of each under ``torch.profiler``:
device busy time per run (the union of the card's kernel, copy and set
intervals), the wall of the same traced runs (CUDA events), the idle share
1 - busy / wall, and the device time per kernel name.
``--level-sweep`` times the level-sweep engine instead (``run_levels_impl``,
``backend="flood"``, the flood kernel) from the seeds of the image, painted:
segmenting on the uniform field and on the Poisson(30) counts field of
``tests/torch_fields.py`` (median of 5; traced once with ``--profile``),
and merging on the uniform field once (its merge phase runs about a minute
at 4096^2).

Prints the card's name and power limit, then one JSON line per run.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

def _fields(side: int):
    import numpy as np

    rng = np.random.default_rng(0)
    dense = rng.integers(0, 254, (side, side)).astype(np.uint8)
    dots = dense.copy()
    dots[rng.random((side, side)) < 0.1] = 255
    return dense, dots


def _busy_us(events) -> float:
    """Union of the device intervals of the traced events, in us."""
    from torch.autograd import DeviceType

    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in events if e.device_type == DeviceType.CUDA
    )
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def _level_sweep_cases(side: int, dev) -> dict:
    import numpy as np
    import torch

    from rustronomy_watershed_tpu_torch.ops.level_driver import run_levels_impl
    from rustronomy_watershed_tpu_torch.ops.seeds import local_extrema_mask, seed_labels_from_mask

    dense = _fields(side)[0]
    poisson = np.clip(np.random.default_rng(0).poisson(30.0, (side, side)), 0, 254).astype(np.uint8)
    cases = {}
    for name, a, merging in (("level_sweep_segmenting", dense, False), ("level_sweep_segmenting_poisson", poisson, False),
                             ("level_sweep_merging", dense, True)):
        img = torch.from_numpy(a).to(dev)
        lab0 = seed_labels_from_mask(local_extrema_mask(img))
        n = int(lab0.max())
        cases[name] = (lambda img=img, lab0=lab0, n=n, merging=merging: run_levels_impl(
            img, lab0, n_labels=n, max_water_level=254, merging=merging, backend="flood", device=dev))
    return cases


def child(profile: bool, side: int, level_sweep: bool = False) -> dict:
    import numpy as np
    import torch

    from rustronomy_watershed_tpu_torch import _ext
    from rustronomy_watershed_tpu_torch.ops.pipeline import watershed_e2e

    dev = torch.device("cuda")
    _ext.lib()
    if level_sweep:
        return _timed_cases(_level_sweep_cases(side, dev), profile, side, reps=5, traced=1, once={"level_sweep_merging"})
    dense, dots = (torch.from_numpy(a).to(dev) for a in _fields(side))
    host_us = _relax_host_us(dense)
    cases = {
        "segmenting": lambda: watershed_e2e(dense, device=dev),
        "merging_dense": lambda: watershed_e2e(dense, merging=True, device=dev),
        "merging_nan10": lambda: watershed_e2e(dots, merging=True, device=dev),
    }
    if side <= 4096:  # the coarse tail's legacy rounds; larger fields may exceed the coarse label bound
        from rustronomy_watershed_tpu_torch.ops import scan_merge as sm

        def legacy():
            sm._COARSE_MULTI = False
            try:
                return watershed_e2e(dots, merging=True, device=dev)
            finally:
                sm._COARSE_MULTI = True

        cases["merging_nan10_legacy"] = legacy
    return dict(_timed_cases(cases, profile, side, reps=9, traced=5), relax_host_us=host_us)


def _relax_host_us(img) -> float:
    """The host's time to issue one relax call as the merging path makes it
    (``relax_block`` with statistics on the packed planes of ``img``): 10
    calls queued after a synchronise, the median of 5 such batches (after
    one warm batch), in us a call.  No flag is read, so nothing waits for
    the card."""
    import time

    import numpy as np
    import torch

    from rustronomy_watershed_tpu_torch.ops import pack, relax

    v, key, lab = pack.pack_kernel(img)[:3]
    out = (torch.empty_like(key), torch.empty_like(lab))
    ts = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            relax.relax_block(v, key, lab, relax.DEFAULT_STEPS, out=out, stats=True)
        ts.append((time.perf_counter() - t0) / 10 * 1e6)
    torch.cuda.synchronize()
    return float(np.median(ts[1:]))


def _timed_cases(cases: dict, profile: bool, side: int, *, reps: int, traced: int, once=frozenset()) -> dict:
    """Time each case (median of ``reps`` warm runs, one for the cases in
    ``once``) and, with ``profile``, trace ``traced`` more runs of the
    others."""
    import numpy as np
    import torch

    from rustronomy_watershed_tpu_torch import _ext

    def timed(fn, reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b)

    out = {"checkout": os.getcwd(), "side": side}
    for name, fn in cases.items():
        if name in once:  # one run, counted and timed (its kernels are warm from the others)
            _ext.reset_launches()
            ms = timed(fn, 1)
            counts = {k: v for k, v in _ext.launches.items() if v}
        else:
            try:
                fn()
            except NotImplementedError:  # a checkout that does not serve it
                out[name] = None
                continue
            torch.cuda.synchronize()
            _ext.reset_launches()
            fn()
            counts = {k: v for k, v in _ext.launches.items() if v}
            ms = float(np.median([timed(fn, 1) for _ in range(reps)]))
        res = {"ms": ms, "mpix_s": side * side / ms / 1e3, "launches": counts}
        if profile and name not in once:
            from torch.profiler import ProfilerActivity, profile as prof_ctx

            with prof_ctx(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                wall = timed(fn, traced)
            busy = _busy_us(prof.events()) / 1e3
            per_kernel = {}
            for e in prof.key_averages():
                t = getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0))
                if t and e.device_type.name == "CUDA":
                    per_kernel[e.key[:60]] = t / 1e3 / traced
            res.update(
                traced_wall_ms=wall / traced, busy_ms=busy / traced, idle_share=1 - busy / wall,
                device_ms_by_kernel=dict(sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]),
            )
        out[name] = res
    return out


def main(argv) -> int:
    profile, level_sweep = "--profile" in argv, "--level-sweep" in argv
    argv = [a for a in argv if a not in ("--profile", "--level-sweep")]
    side = 4096
    if "--side" in argv:
        i = argv.index("--side")
        side = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2 :]
    if argv and argv[0] == "--child":
        print(json.dumps(child(profile, side, level_sweep)))
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    me = os.path.abspath(__file__)
    for d in argv:
        d = os.path.abspath(d)
        env = dict(os.environ, PYTHONPATH=d)
        cmd = ([sys.executable, me, "--child", "--side", str(side)] + (["--profile"] if profile else [])
               + (["--level-sweep"] if level_sweep else []))
        res = subprocess.run(cmd, cwd=d, env=env, capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stderr[-4000:], file=sys.stderr)
            return res.returncode
        print(res.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
