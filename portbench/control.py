#!/usr/bin/env python3
"""The two readings that each compared number's limit is set from.

    python3 portbench/control.py --workload <name> --seeds 1,2,... \
        --control-seeds 7,8,9 --seconds 3 [--out FILE]

For each of ``--seeds`` a run of the cell with a short window (the lower
reading: what sound runs of the program give), and for each of
``--control-seeds`` the control put in the program's place on as many
pool images as a run checks (the upper reading: the reference with its min-label
tie-break broken, the greatest label winning), both through the run's own
comparison.  One process; prints a JSON line per run and writes them all
to ``--out``.  The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE)]


def control_reading(cell, seed: int, device: str = "cuda") -> dict:
    """The control's compared numbers on as many pool images as a run of
    ``seed`` checks (its first ``check["sample"]``)."""
    from harness import fields

    pool = [p.cpu().numpy() for p in fields.make_pool(cell, seed, device)]
    entry = cell.module("entries", cell.traffic["entry"]).Entry(cell, device)
    k = min(int(cell.traffic["check"]["sample"]), len(pool))
    kept = [(i, entry.control(pool[i])) for i in range(k)]
    return {name: v for name, (v, _) in entry.compare(kept, pool).items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from harness.cell import run_cell
    from harness.spec import resolve

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = resolve(args.workload)
    rows = []
    for s in (int(x) for x in args.seeds.split(",")):
        t = time.perf_counter()
        r = run_cell(cell, seed=s, seconds=args.seconds, trace=False)
        rows.append({"kind": "program", "seed": s, "correct": r["correct"], "attempted": r["attempted"],
                     "compared": {k: v["value"] for k, v in r["compared"].items()}, "s": time.perf_counter() - t})
        print(json.dumps(rows[-1]), flush=True)
    for s in (int(x) for x in args.control_seeds.split(",")):
        t = time.perf_counter()
        rows.append({"kind": "control", "seed": s, "compared": control_reading(cell, s),
                     "s": time.perf_counter() - t})
        print(json.dumps(rows[-1]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
