#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (rustronomy_watershed_tpu_torch) on
one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from csrc/, holds each against its plain
PyTorch twin on the card, drives the segmenting main path through both entry
points a user calls (the public builder API on the committed goldens, and
``watershed_e2e`` on the 4096^2 u8 field), checks the labels, and times the
card.  One line per phase; the line before the last is the kernel table as
JSON, the last line ``{"ok": true, "device": {...}}``.  Any failed check
raises and the run exits non-zero; without CUDA it exits non-zero at once.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "golden")
SIDE = 4096  # the benchmarked field: bench.py's uniform u8 input


def check(ok, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1

    from rustronomy_watershed_tpu_torch import _ext
    from rustronomy_watershed_tpu_torch.ops import pack, priority, relax
    from rustronomy_watershed_tpu_torch.ops.pipeline import watershed_e2e
    from rustronomy_watershed_tpu_torch.ops.seeds import paint_seeds
    from rustronomy_watershed_tpu_torch.prelude import TransformBuilder

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    gpu = gpu_line()
    print(gpu)
    print(f"[1 device] {name}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    _ext.lib()
    print(f"[2 build] nvcc + load {time.perf_counter() - t0:.2f} s -> {_ext.library_path()}")

    def to_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def max_err(xs, ys) -> int:
        return max(int((x.long() - y.long()).abs().max()) if x.numel() else 0 for x, y in zip(xs, ys))

    # -- 3: pack kernel against its twin -------------------------------------
    rng = np.random.default_rng(0)
    dots = rng.integers(0, 254, (SIDE, SIDE)).astype(np.uint8)
    dots[rng.random((SIDE, SIDE)) < 0.1] = 255
    fields = {
        "uniform 63x97": rng.integers(0, 256, (63, 97)).astype(np.uint8),
        "uniform 1024^2": rng.integers(0, 256, (1024, 1024)).astype(np.uint8),
        "10% 255-dots 4096^2": dots,
        "plateau 0..3 1024^2": rng.integers(0, 4, (1024, 1024)).astype(np.uint8),
    }
    pack_err = 0
    for label, a in fields.items():
        img = to_dev(a)
        got, want = pack.pack_kernel(img), pack.pack_plain(img)
        torch.cuda.synchronize()
        err = max_err(got, want)
        check(err == 0, f"pack kernel == twin on {label}")
        pack_err = max(pack_err, err)
        print(f"[3 pack] {label}: bit-equal to twin, {int(got[3])} seeds")

    # -- 4: relax kernel against its twin ------------------------------------
    img = to_dev(np.random.default_rng(0).integers(0, 254, (SIDE, SIDE)).astype(np.uint8))
    v, key0, lab0, _ = pack.pack_kernel(img)
    mid_k, mid_l, _ = relax.relax_block_kernel(v, key0, lab0, 8)
    relax_err = 0
    for steps in sorted({1, 8, 16, relax.DEFAULT_STEPS}):
        for state, start in (((key0, lab0), "fresh"), ((mid_k, mid_l), "mid")):
            got = relax.relax_block_kernel(v, *state, steps)
            want = relax.relax_block_plain(v, *state, steps)
            torch.cuda.synchronize()
            err = max_err(got, want)
            check(err == 0, f"relax kernel == {steps} plain sweeps from {start} state")
            relax_err = max(relax_err, err)
            print(f"[4 relax] steps={steps} {start}: planes and flags {got[2].tolist()} bit-equal to twin")

    # d field pinned at its maximum: the saturated key spreads without
    # carrying into the level field, and the detector fires.
    d_bits = 23
    vs = np.full((24, 128), 255, np.uint8)
    vs[8:16, 8:16] = 5
    ks = np.full((24, 128), 255 << d_bits, np.int32)
    ls = np.zeros((24, 128), np.int32)
    ks[10, 10] = (5 << d_bits) | ((1 << d_bits) - 1)
    ls[10, 10] = 7
    got = relax.relax_block_kernel(to_dev(vs), to_dev(ks), to_dev(ls), 8, d_bits)
    want = relax.relax_block_plain(to_dev(vs), to_dev(ks), to_dev(ls), 8, d_bits)
    check(max_err(got, want) == 0, "saturated relax kernel == twin")
    k2 = got[0].cpu().numpy()
    claimed = k2 != 255 << d_bits
    check(claimed[10, 11] and claimed[12, 12], "saturated key spreads")
    check(((k2[claimed] >> d_bits) == 5).all(), "level field not corrupted")
    check(got[2].tolist()[relax.SAT] == 1, "saturation detector fires")
    print("[4 relax] d-field saturation at d_bits=23: pinned, no carry, sat fires")

    # 7-bit d field: a serpentine plateau saturates it; the public API warns
    # and re-runs on the exact engine.
    h, w, lvl = 41, 38, 5
    serp = np.full((h, w), 255, np.uint8)
    for i, y in enumerate(range(1, h - 1, 2)):
        serp[y, 1 : w - 1] = lvl
        if y + 2 < h - 1:
            serp[y + 1, w - 2 if i % 2 == 0 else 1] = lvl
    saved = relax._D_BITS
    relax._D_BITS = 7
    try:
        ws = TransformBuilder.default().set_device("cuda").build_segmenting()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got7 = ws.transform(serp, [(1, 1)])
    finally:
        relax._D_BITS = saved
    exact = TransformBuilder.default().set_device("cuda").set_backend("relax").build_segmenting()
    check(any("saturation" in str(c.message) for c in caught), "7-bit saturation warns")
    check(np.array_equal(got7, exact.transform(serp, [(1, 1)])), "7-bit fallback == exact engine")
    check((got7[serp == lvl] == 1).all(), "every corridor pixel coloured")
    print("[4 relax] 7-bit d field: saturation warned, fallback equals the exact engine")

    # -- 5: the public API, its launches counted on their own ----------------
    _ext.reset_launches()
    ws = TransformBuilder.default().set_device("cuda").build_segmenting()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        z = np.load(os.path.join(GOLDEN, "golden_morph_v1.npz"))
        cases = [("golden_morph_v1 1024^2", z["img"], z["seeds"], z["segmenting/labels"])]
        z = np.load(os.path.join(GOLDEN, "golden_v1.npz"))
        for f in ("uniform", "poisson", "grf", "nanmasked"):
            cases.append((f"golden_v1 {f} 64^2", z[f"{f}/img"], z[f"{f}/seeds"], z[f"{f}/segmenting/labels"]))
        for label, gimg, gseeds, glabels in cases:
            seeds = ws.find_local_minima(gimg)
            check(np.array_equal(np.asarray(seeds, np.int64).reshape(-1, 2), gseeds), f"seeds of {label}")
            out = ws.transform(gimg, seeds)
            check(out.dtype == np.int32 and np.array_equal(out, glabels), f"segmenting labels of {label}")
            print(f"[5 api] {label}: {len(seeds)} seeds and segmenting labels equal the golden")
    check(not [c for c in caught if "saturation" in str(c.message)], "no saturation warning")
    api = dict(_ext.launches)
    check(api["relax"] > 0, "public API launched the relax kernel")
    check(api["pack_plain"] == 0 and api["relax_plain"] == 0, "no plain twin on the public API path")
    print(f"[5 api] launches {api}")

    # -- 6: the benchmarked path: one watershed_e2e, its launches counted -----
    _ext.reset_launches()
    e2e = watershed_e2e(img, device=dev)
    torch.cuda.synchronize()
    launches = dict(_ext.launches)
    check(launches["pack"] > 0 and launches["relax"] > 0, "e2e launched both kernels")
    check(launches["pack_plain"] == 0 and launches["relax_plain"] == 0, "no plain twin on the main path")
    seeds = ws.find_local_minima(img)
    lab_seeds = to_dev(paint_seeds(tuple(img.shape), seeds))
    want, _ = priority.relax_transform(img, lab_seeds)
    check(e2e.shape == img.shape and e2e.dtype == torch.int32, "e2e labels shape and dtype")
    check(torch.equal(e2e, want), "e2e labels == exact engine")
    check(int(e2e.max()) == len(seeds) and int(e2e[0].abs().max()) == 0, "e2e labels in range, border uncoloured")
    print(f"[6 e2e] {SIDE}^2 watershed_e2e equals the exact engine ({len(seeds)} seeds); launches {launches}")

    # -- 7: times on the card --------------------------------------------------
    def median_ms(fn, reps: int) -> float:
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            ts.append(a.elapsed_time(b))
        return float(np.median(ts))

    calls = launches["relax"]
    e2e_ms = median_ms(lambda: watershed_e2e(img, device=dev), 9)
    print(
        f"[7 time] {SIDE}^2 e2e {e2e_ms:.3f} ms = {SIDE * SIDE / e2e_ms / 1e3:.1f} Mpix/s, "
        f"{calls} relax calls of {relax.DEFAULT_STEPS} sweeps; gpu={gpu}"
    )
    pack_ms = median_ms(lambda: pack.pack_kernel(img), 20)
    pack_plain_ms = median_ms(lambda: pack.pack_plain(img), 5)
    print(f"[7 time] pack {SIDE}^2: kernel {pack_ms:.3f} ms, plain {pack_plain_ms:.3f} ms; gpu={gpu}")
    s = relax.DEFAULT_STEPS
    relax_ms = median_ms(lambda: relax.relax_block_kernel(v, key0, lab0, s), 20)
    relax_plain_ms = median_ms(lambda: relax.relax_block_plain(v, key0, lab0, s), 5)
    print(f"[7 time] relax {SIDE}^2 one call of {s} sweeps: kernel {relax_ms:.3f} ms, plain {relax_plain_ms:.3f} ms; gpu={gpu}")

    kernels = [
        dict(name="pack", route="cuda", source="rustronomy_watershed_tpu_torch/csrc/pack.cu",
             replaces="rustronomy_watershed_tpu/ops/pallas_pack.py:85", launches=launches["pack"],
             max_abs_err=pack_err, ms=pack_ms, plain_ms=pack_plain_ms),
        dict(name="relax", route="cuda", source="rustronomy_watershed_tpu_torch/csrc/relax.cu",
             replaces="rustronomy_watershed_tpu/ops/pallas_relax.py:254", launches=launches["relax"],
             max_abs_err=relax_err, ms=relax_ms, plain_ms=relax_plain_ms),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
