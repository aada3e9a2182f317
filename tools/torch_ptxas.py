#!/usr/bin/env python3
"""Registers, spills and static shared memory of every kernel in the port's
CUDA sources, as ``nvcc -Xptxas -v`` reports them, for one or more
checkouts.

    python3 tools/torch_ptxas.py [--source NAME] [--match TEXT] DIR [DIR ...]

Each DIR is the root of a checkout of this repository (``.`` for this one).
For each, ``rustronomy_watershed_tpu_torch/csrc/NAME`` (default
``scan_round.cu``) is compiled with the port's own flags into a temporary
object, and one line is printed per kernel whose demangled name contains
TEXT (default: every kernel): checkout, kernel, registers, spill stores and
loads in bytes, static shared memory in bytes.  Needs ``nvcc`` (the GPU
host).
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _demangle(names: list[str], nvcc: str) -> dict[str, str]:
    tool = shutil.which("cu++filt") or os.path.join(os.path.dirname(nvcc), "cu++filt")
    if not os.path.exists(tool):
        tool = shutil.which("c++filt")
    if tool is None:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True, check=True).stdout
    return dict(zip(names, out.splitlines()))


def kernels(src: str) -> list[dict]:
    """Compile ``src`` with -Xptxas -v and parse ptxas's report."""
    sys.path.insert(0, ROOT)
    from rustronomy_watershed_tpu_torch import _ext

    nvcc = _ext._nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        res = subprocess.run([nvcc, *_ext.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", os.path.join(tmp, "k.o"), src],
                             capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"nvcc failed on {src}:\n{res.stderr}")
    rows, cur = {}, None
    for line in res.stderr.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            cur = m.group(1)
            rows[cur] = {"mangled": cur, "regs": None, "spill_st": None, "spill_ld": None, "smem": 0}
        elif cur and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            rows[cur]["spill_st"], rows[cur]["spill_ld"] = int(m.group(1)), int(m.group(2))
        elif cur and (m := re.search(r"Used (\d+) registers", line)):
            rows[cur]["regs"] = int(m.group(1))
            if s := re.search(r"(\d+) bytes smem", line):
                rows[cur]["smem"] = int(s.group(1))
    names = _demangle(list(rows), nvcc)
    for k, r in rows.items():
        r["name"] = names.get(k, k)
    return list(rows.values())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", default="scan_round.cu")
    ap.add_argument("--match", default="")
    ap.add_argument("dirs", nargs="+")
    args = ap.parse_args()
    for d in args.dirs:
        src = os.path.join(d, "rustronomy_watershed_tpu_torch", "csrc", args.source)
        for r in sorted(kernels(src), key=lambda r: r["name"]):
            if args.match in r["name"]:
                print(f"{d}\t{r['name']}\tregs {r['regs']}\tspill st {r['spill_st']} ld {r['spill_ld']}"
                      f"\tsmem {r['smem']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
