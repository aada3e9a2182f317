#!/usr/bin/env python3
"""Time the legacy coarse pass 2 (``cbwd_vh``) under launch plans that
differ in their band height, on one NVIDIA GPU.

    python3 tools/torch_legacy_plans.py [--bands 4,8,16,32] [--profile]

On the coarse plane of the 4096^2 NaN-dot field of ``bench.py`` (relaxed
labels, coarsened, one ``cfwd_v`` pass: a legacy round's pass-2 input), for
the h-window of 256 lanes and for full width, it runs
``rwt_coarse_bwd_vh`` with ``legacy_row_plan``'s plan and with that plan's
bands set to each height given (every other value as the plan has it),
holds each output plane and flag against the twin, and prints the median
of 20 CUDA-event timings of one call, the card's name and power limit.
``--profile`` also traces 10 calls of each with the plan under
``torch.profiler`` and prints the device time per launch of each kernel
(median).
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bands", default="4,8,16,32")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_legacy_plans: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from rustronomy_watershed_tpu_torch import _ext
    from rustronomy_watershed_tpu_torch.ops import relax
    from rustronomy_watershed_tpu_torch.ops import scan_merge as sm

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    dots = rng.integers(0, 254, (4096, 4096)).astype(np.uint8)
    dots[rng.random(dots.shape) < 0.1] = 255
    lab = relax.relax_packed_planes(torch.from_numpy(dots).to(dev), None, device=dev)[1]
    c = sm.cfwd_v_kernel(sm.coarsen_kernel(lab))[0]
    hc, w = c.shape
    scratch, out, flag = torch.empty_like(c), torch.empty_like(c), torch.empty(1, dtype=torch.int32, device=dev)
    n_sm = _ext.sm_count(0)

    def run(reach, plan):
        err = _ext.lib().rwt_coarse_bwd_vh(
            c.data_ptr(), scratch.data_ptr(), out.data_ptr(), flag.data_ptr(), hc, w, reach,
            plan["rows_per_step"], plan["band_rows"], plan["threads"], plan["smem"], _ext.stream_ptr(c),
        )
        _ext.check(err, "rwt_coarse_bwd_vh")

    windows = (("window 256", 256), ("full width", None))
    for label, h_window in windows:
        reach = sm._reach(w, h_window)
        want = sm.cbwd_vh_plain(c, h_window)
        base = sm.legacy_row_plan(hc, w, n_sm, reach)
        plans = [("plan", base)] + [(f"bands of {b}", {**base, "band_rows": b}) for b in map(int, args.bands.split(","))]
        for name, plan in plans:
            run(reach, plan)
            torch.cuda.synchronize()
            if not (torch.equal(out, want[0]) and torch.equal(flag, want[1])):
                raise SystemExit(f"{label}, {name}: the kernel differs from the twin")
            ts = []
            for _ in range(20):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                run(reach, plan)
                b.record()
                torch.cuda.synchronize()
                ts.append(a.elapsed_time(b))
            print(f"{label} {hc}x{w}, {name} ({-(-hc // plan['band_rows'])} blocks of {plan['threads']} threads, "
                  f"{plan['smem']} B): {float(np.median(ts)):.4f} ms (median of 20, CUDA events); equal to the twin")
    if args.profile:  # one session: a second one in a process may see no device activity
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for label, h_window in windows:
                reach = sm._reach(w, h_window)
                for _ in range(10):
                    run(reach, sm.legacy_row_plan(hc, w, n_sm, reach))
                torch.cuda.synchronize()
        by = {}
        for e in prof.events():
            if e.device_type.name == "CUDA":
                kernel = re.search(r"::(\w+(<[^>]*>)?)", e.name)
                by.setdefault(kernel.group(1) if kernel else e.name, []).append(e.time_range.elapsed_us() / 1e3)
        print("plan, device time per launch (torch.profiler, median over 10 windowed and 10 full-width calls): "
              + ", ".join(f"{k} {float(np.median(t)):.4f} ms ({len(t)} launches)" for k, t in by.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
