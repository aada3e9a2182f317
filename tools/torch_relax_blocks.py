#!/usr/bin/env python3
"""Time the relax fixed point's block size on the card.

    python3 tools/torch_relax_blocks.py [--rounds 5] [--blocks 1,2,3,4,5,6,7,8]

From the repository root on a CUDA host.  Draws the benchmark's pools on
the card from ``portbench/fields``, each field as the cell's traffic file
in ``portbench/traffic`` gives it (4 uniform 4096^2 u8 tiles, as cell
``tile4096.segment``; 4 beam-smoothed float32 4096^2 maps, as cell
``tile4096.segment_beam``), warms every shape up, then in each round
times a fixed number of calls of each cell's work (``watershed_e2e``
segmenting; the maps through ``pre_process_jnp`` first; each call ends in
a synchronise) at each block size in turn, with
``ops.relax._RELAX_BLOCK`` set to it; the order of the block sizes
alternates between rounds.  Prints a JSON line per cell, block and round
(Mpix/s; relax calls, reads and stopped calls a call), then one with each
cell's median Mpix/s a block size over the rounds, and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from rustronomy_watershed_tpu_torch import _ext  # noqa: E402
from rustronomy_watershed_tpu_torch.ops import pre_process_jnp, relax, watershed_e2e  # noqa: E402

SIDE = 4096
# Calls a timing of each cell: about half a second of the uniform tile
# (~2 ms a call) and a second of the beam map (~45 ms a call).
CALLS = {"segment": 200, "segment_beam": 24}


def _field(kind: str):
    spec = importlib.util.spec_from_file_location(f"fields_{kind}", ROOT / "portbench" / "fields" / f"{kind}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pool(traffic: str, gen):
    """The 4 fields of a cell's pool, drawn as its traffic file gives them."""
    field = json.loads((ROOT / "portbench" / "traffic" / f"{traffic}.json").read_text())["field"]
    return [_field(field["kind"]).make((SIDE, SIDE), field, gen) for _ in range(4)]


def _pools(seed: int):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    tiles, maps = _pool("segment", gen), _pool("segment_beam", gen)
    return {
        "segment": lambda i: watershed_e2e(tiles[i % 4], merging=False, device="cuda"),
        "segment_beam": lambda i: watershed_e2e(pre_process_jnp(maps[i % 4], 254, device="cuda"), merging=False,
                                                device="cuda"),
    }


def _time(call, n: int) -> tuple[float, dict]:
    torch.cuda.synchronize()
    _ext.reset_launches()
    t0 = time.perf_counter()
    for i in range(n):
        call(i)
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    c = _ext.launches
    per = {k: c[k] / n for k in ("relax", "relax_reads", "relax_stopped")}
    return n * SIDE * SIDE / dt / 1e6, per


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--blocks", default="1,2,3,4,5,6,7,8")
    ap.add_argument("--seed", type=int, default=2**31 + 7)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    blocks = [int(b) for b in args.blocks.split(",")]
    cells = _pools(args.seed)
    for call in cells.values():  # build the library, warm every shape
        for i in range(4):
            call(i)
    rates: dict = {(c, b): [] for c in cells for b in blocks}
    for r in range(args.rounds):
        for b in blocks if r % 2 == 0 else blocks[::-1]:
            relax._RELAX_BLOCK = b
            for cell, call in cells.items():
                mpix, per = _time(call, CALLS[cell])
                rates[cell, b].append(mpix)
                print(json.dumps({"cell": cell, "block": b, "round": r, "mpix_per_s": mpix, **per}), flush=True)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    medians = {cell: {b: statistics.median(rates[cell, b]) for b in blocks} for cell in cells}
    print(json.dumps({"median_mpix_per_s": medians, "gpu": gpu}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
