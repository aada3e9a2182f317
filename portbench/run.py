#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Builds the cell's inputs from the seed, warms
up every pool image once, drives the cell's entry in a closed loop (one
caller, the next call when the last returns) for ``--seconds``, checks the
sampled answers against the plain reference, and prints one JSON object as
the last line of standard output; the numbers compared, each with its
limit, are also the last lines of standard error.  ``--trace 1`` runs the
window under ``torch.profiler`` (ending early after the traffic's
``trace_calls`` calls) and reports the per-layer metrics instead of the
end-to-end ones.  Exits nonzero, and prints no result, on a host without
enough CUDA devices or when the run has loaded JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE)]
# Python's bytecode cache at a fixed path inside the checkout: where the
# environment forbids writing it (PYTHONDONTWRITEBYTECODE) or the installed
# packages hold none, every run would compile torch's sources again, which
# is most of a run's set-up.  Only the first run in a checkout writes it.
sys.dont_write_bytecode = False
sys.pycache_prefix = str(HERE.parent / "build" / "portbench_pycache")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness.spec import resolve

    cell = resolve(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell needs {cell.chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2

    from harness.cell import ForbiddenImport, run_cell

    try:
        result = run_cell(cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace))
    except ForbiddenImport as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    print(f"correct {result['correct']}; the numbers compared, each with its limit:", file=sys.stderr)
    for k, v in result["compared"].items():
        print(f"{k} {v['value']} limit {v['limit']}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
