#!/usr/bin/env python3
"""Rehearse ``chip_smoke.py`` on a host without a GPU.

    python3 tools/torch_smoke_rehearsal.py

Runs every phase of ``chip_smoke.py`` on the CPU at cut sizes, with each
CUDA kernel wrapper replaced by its plain PyTorch twin (counted as the
kernel, so the launch checks see the kernels), ``torch.cuda``'s
availability, events and synchronise faked, and no ``nvcc``.  It finds wrong
paths, arguments, shapes and control flow in the script before a chip call;
it says nothing about the kernels themselves or about times (the printed
times are the CPU's).  The size cuts are textual replacements in the
script's source: each must match, so a change to the script that moves one
fails here loudly.  Phase 20 (the single-device options) runs on the cut
fields too: checkpoints at 256^2 and a 320^2 plane snapshot, the flood
kernel's host loop on the cut golden_morph_v1, the random tie-break on a
512^2 Poisson field on both "devices", the native engine on the host.
Phases 21-23 (the relax kernel's centre rectangle, the one-rank mesh on
gloo instead of NCCL, the 2 x 2 gloo mesh and the (2, 1, 2) batch mesh
whose four ranks run the twins; the per-level API and the host loop on the
cut golden_morph_v1 and its quadrants; ``backend='relax'`` on both meshes)
run on the cut fields; ``--mesh`` runs phases 1, 2 and 21-23 alone (their
inputs made as main() makes them), in a few minutes, ``--late`` phases 24
and 25 alone, ``--y0`` phase 26 (the relax kernel's y0 epilogue) alone.
Phase 24 (tracing)
runs in its own process on the CPU (its trace holds no device kernel, so
the kernel counts are held at 0), phase 25 on the morphology field at
256^2 with a 48^2 corner.
"""

from __future__ import annotations

import importlib
import os
import sys
import time
import types

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUTS = [
    ('SIDE = 4096', 'SIDE = 256'),
    ('BIG = 16384', 'BIG = 320'),
    ('WIDE = (2048, BIG)', 'WIDE = (64, BIG)'),
    ('TALL = (9001, 700)', 'TALL = (301, 70)'),
    ('PAST_CAP = (300, 18440)', 'PAST_CAP = (7, 18440)'),
    ('MORPH, MORPH_CROP, MORPH_SEED, MORPH_MAX = 4096, 256,', 'MORPH, MORPH_CROP, MORPH_SEED, MORPH_MAX = 256, 48,'),
    # Phase 24's process has no fakes: its transforms run the twins on the
    # CPU, whose trace holds no device kernel.
    ('        check(n == per * routes[counter] > 0, f"the trace holds', '        check(n == 0, f"the trace holds'),
    ('    check(routes["pack_vec"] == routes["pack"]', '    check(routes["pack_plain"] > 0'),
    ('    check((n2 > 0 and not second["warnings"]) or (n2 == 0 and warned2',
     '    check((n2 == 0 and not second["warnings"]) or (n2 == 0 and warned2'),
    ('    split, rsplit = {}, {}\n', '    split, rsplit = {"column scan": 1.0, "row kernel": 1.0}, '
     '{"v-pass forward": 1.0, "v-pass backward": 1.0, "h-pass": 1.0}  # no device trace on the CPU\n'),
    ('    packs = [e.time_range.elapsed_us() / 1e3 for e in on_card if "pack_bands" in e.name]\n',
     '    packs = [1.0] * 15  # no device trace on the CPU\n'),
    ('    coarsens = [e.time_range.elapsed_us() / 1e3 for e in on_card if "coarsen_strips" in e.name]\n',
     '    coarsens = [1.0] * 10\n'),
    # The CPU profiler records every op of the twin: keep the traced level
    # sweep out of it (phase 13 runs it untraced).
    ('        flood_level_sweep(img, fresh.clone(), lambda lvl_, first, *call: sweep_first.append(first))\n',
     '        sweep_first = [True, False]\n'),
    ('    floods = [e.time_range.elapsed_us() / 1e3 for e in on_card if "flood_kernel" in e.name]\n',
     '    floods = [1.0] * (20 + len(sweep_first))\n'),
    ('    bcasts = [e.time_range.elapsed_us() / 1e3 for e in on_card if "broadcast_rows" in e.name]\n',
     '    bcasts = [1.0] * 10\n'),
    ('    cfwds = [e.time_range.elapsed_us() / 1e3 for e in on_card if "v_pass<true, true>" in e.name]\n',
     '    cfwds = [1.0] * 10\n'),
    ('    vcols = [e.time_range.elapsed_us() / 1e3 for e in on_card if "v_pass<true, false>" in e.name]\n',
     '    vcols = [1.0] * 20\n'),
    ('    hwins = [e.time_range.elapsed_us() / 1e3 for e in on_card if "hwin_ring" in e.name]\n',
     '    hwins = [1.0] * 20\n'),
    ('        ts = [e.time_range.elapsed_us() / 1e3 for e in on_card if tmpl in e.name]\n',
     '        ts = [1.0] * 15\n'),
    # The level driver keeps tile state for CUDA planes only; a 256^2 field has
    # too few tiles for its level sweep to skip any.
    ('check(counts["flood_tiles"] == counts["flood"], f"every level-sweep flood call ran with tile state ({label})")',
     'pass'),
    ('check(sum(skips) > 0, f"the {label} level sweep skipped tiles")', 'print("skips", sum(skips))'),
    ('check(counts["flood_tiles_skipped"] > 0 or label.startswith("10%"), f"the level sweep skipped tiles ({label})")',
     'pass'),
    ('(1024, 1024)', '(512, 512)'),
    ('0, 1024, 60', '0, 512, 60'),
    ('integers(1, 1023, (40, 2))', 'integers(1, 511, (40, 2))'),
    ('(1023, 500)', '(511, 500)'),
    ('(301, 1023)', '(301, 511)'),
    ('(16, 1024, 1024)', '(4, 64, 64)'),
    ('pimg = zc["img"]', 'pimg = zc["img"][:96, :112]'),
    ('zc["merging/sizes"]', 'np.stack([r for _, r in results[("auto", "list")]])'),
    ('torch.device("cuda")', 'torch.device("cpu")'),
    ('set_device("cuda")', 'set_device("cpu")'),
    # The one-rank mesh on gloo and the CPU; the 2x2 mesh's ranks are fresh
    # processes without the fakes, so they run the twins on the CPU.
    ('dist.init_process_group("nccl"', 'dist.init_process_group("gloo"'),
    ('mesh1.get_group("y")) == "nccl"', 'mesh1.get_group("y")) == "gloo"'),
    ('DeviceMesh("cuda", [[0]]', 'DeviceMesh("cpu", [[0]]'),
    ('    torch.cuda.set_device(0)\n', ''),
    ('        check(all(mesh_kernel_path(p["launches"]) for p in per),',
     '        check(all(p["launches"]["relax_plain"] > 0 for p in per),'),
    ('            check(mesh_flood_path(got["loop_launches"]), f"rank {rank}',
     '            check(got["loop_launches"]["flood_plain"] > 0, f"rank {rank}'),
    ('        check(all(mesh_kernel_path(b["launches"]) for b in bat),',
     '        check(all(b["launches"]["relax_plain"] > 0 for b in bat),'),
]


def _fake_kernels():
    from rustronomy_watershed_tpu_torch import _ext
    from rustronomy_watershed_tpu_torch.ops import flood, flood_block, pack, pipeline, relax
    from rustronomy_watershed_tpu_torch.ops import scan_merge as sm

    def as_kernel(plain, key):
        def run(*args, **kw):
            out = plain(*args, **kw)
            _ext.launches[key + "_plain"] -= 1
            _ext.launches[key] += 1
            return out

        return run

    pack_kernel = as_kernel(pack.pack_plain, "pack")

    def pack_routed(img, **kw):  # the route the card's plan would take
        _ext.launches[f"pack_{pack.pack_plan(*img.shape)['route']}"] += 1
        return pack_kernel(img, **kw)

    pack.pack_kernel = pack_routed
    relax_plain = as_kernel(relax.relax_block_plain, "relax")

    def relax_kernel(v, key, lab, steps, d_bits=None, *, tiles=None, ctr=None, stats=False, fwd_scan=False, **kw):
        """The twin (no tile state), counted as the kernel with its centre
        rectangle and its y0 epilogue."""
        if relax._rect(ctr, *key.shape, stats) != (0, key.shape[0], 0, key.shape[1]):
            _ext.launches["relax_ctr"] += 1
        if fwd_scan:
            _ext.launches["relax_y0"] += 1
        return relax_plain(v, key, lab, steps, d_bits, ctr=ctr, stats=stats, fwd_scan=fwd_scan, **kw)

    relax.relax_block_kernel = relax_kernel
    relax.relax_block = lambda *a, **k: relax.relax_block_kernel(*a, **k)

    class RelaxLauncher(relax._PlainRelaxLauncher):
        """The fixed point's twin launcher, its calls counted as the
        kernel's: each at its launch (with the y0 epilogue), those that ran
        and those that stopped when settled, with the plane's pixels and
        the centre rectangle (no tiles, as ``relax_kernel``)."""

        n_tiles = 0  # the twin plans no tiles
        settle = relax._RelaxLauncher.settle

        def __init__(self, v, planes, steps, d_bits, **kw):
            super().__init__(v, planes, steps, d_bits, **kw)
            h, w = v.shape
            self.px, self.rect = h * w, relax._rect(self.ctr, h, w, self.stats) != (0, h, 0, w)

        def __call__(self, c, i, g=None):
            stopped = g is not None and not self.words[g, relax.LAST]
            super().__call__(c, i, g)
            _ext.launches["relax_stopped" if stopped else "relax_plain"] -= 1
            _ext.launches["relax_launched"] += 1
            _ext.launches["relax_y0"] += self.fwd_scan and c == 0

    relax._PlainRelaxLauncher = RelaxLauncher

    def pack_fused(img, device, **kw):
        return pack.pack_kernel(torch.as_tensor(img).to(torch.uint8).contiguous(), **kw)

    pack.pack_domain_fused = relax.pack_domain_fused = pack_fused
    coarsen_kernel = as_kernel(sm.coarsen_plain, "coarsen")

    def coarsen_routed(lab):
        _ext.launches[f"coarsen_{sm.coarsen_plan(*lab.shape, sm._vec(lab.shape[1], lab))['route']}"] += 1
        return coarsen_kernel(lab)

    sm.coarsen_kernel = coarsen_routed
    broadcast = as_kernel(sm.coarse_broadcast_plain, "coarse_broadcast")

    def broadcast_routed(c, lab):
        _ext.launches[f"coarse_broadcast_{sm.broadcast_plan(*lab.shape, sm._vec(lab.shape[1], c, lab))['route']}"] += 1
        return broadcast(c, lab)

    sm.coarse_broadcast_kernel = broadcast_routed
    for name in ("fwd_v", "bwd_vh", "cfwd_v", "cbwd_vh"):
        setattr(sm, f"{name}_kernel", as_kernel(getattr(sm, f"{name}_plain"), name))
    bwd_vh = sm.bwd_vh_kernel

    def bwd_vh_routed(y, **kw):  # the row route the card's plan would take
        _ext.launches[f"bwd_vh_{sm.row_plan(*y.shape, 132)['route']}"] += 1
        return bwd_vh(y, **kw)

    sm.bwd_vh_kernel = bwd_vh_routed

    def round_launcher(c, out, scratch, words):
        """The twin's rounds, each counted at its launch as the kernel's
        are, on the row route the card's plan would take."""
        route = f"coarse_round_{sm.row_plan(*c.shape, 132, coarse=True)['route']}"

        def launch(i, g):
            sm._plain_round(c, out, None if g is None else words[g : g + 1], words[i : i + 1])
            _ext.launches["coarse_round_launched"] += 1
            _ext.launches[route] += 1

        launch.settle = sm._count_coarse_rounds
        return launch

    sm._round_launcher = round_launcher
    sm._check_cuda_planes = lambda *planes: None  # coarse_round_kernel's planes, on the CPU
    cbwd_vh = sm.cbwd_vh_kernel

    def cbwd_vh_routed(c, h_window=None, **kw):
        reach = sm._reach(c.shape[1], h_window)
        _ext.launches[f"cbwd_vh_{sm.legacy_row_plan(*c.shape, 132, reach)['route']}"] += 1
        return cbwd_vh(c, h_window, **kw)

    sm.cbwd_vh_kernel = cbwd_vh_routed
    _ext.sm_count = lambda dev: 132
    # Shallower windows (32 x 128, 16 x 112 tiles at 8 steps), so that the
    # cut fields have tiles to skip.
    relax._WARPS = 4
    # The cut BIG x BIG field keeps the full size's label bound, so that it
    # takes the fine tail as 16384^2 does.
    bound = pipeline.max_seed_count
    pipeline.max_seed_count = lambda shape: 1 << 26 if tuple(shape) == (320, 320) else bound(shape)
    sm._dispatch = lambda kernel, plain, lead: kernel
    flood_plain = as_kernel(flood_block.flood_block_plain, "flood")

    def flood_tiled(img, lab, lvl, steps, *, out=None, tiles=None, first=False):
        """The twin, with the kernel's tile state: the run rule on the
        plan's tiles, the change bytes and the counts of tiles that ran no
        sweeps and of those that copied."""
        new, flags = flood_plain(img, lab, lvl, steps, out=out)
        if tiles is None:
            return new, flags
        _ext.launches["flood_tiles"] += 1
        (gy, gx), ty, tx = tiles.plan["grid"], tiles.plan["tile_y"], tiles.plan["tile_x"]
        prev, chg = tiles.next_call(first)
        if prev is None:
            run = copy = torch.ones((gy, gx), dtype=torch.bool)
        else:
            prev = prev.view(gy, gx).to(torch.int32)
            run = flood_block.flood_active_tiles(prev, tiles.presence, lvl, first)
            copy = ((prev & flood_block.CHANGED) != 0) & ~run
        before_last = lab
        for _ in range(steps - 1):
            before_last = flood.flood_sweep(img, before_last, lvl, mask=True)

        def per_tile(moved_cells):
            moved = torch.zeros((gy * ty, gx * tx), dtype=torch.bool)
            moved[: lab.shape[0], : lab.shape[1]] = moved_cells
            return moved.view(gy, ty, gx, tx).any(3).any(1).to(torch.uint8)

        bits = per_tile(new != lab) | per_tile(new != before_last) << 1
        chg.copy_(torch.where(run, bits, 0).view(-1))
        tiles.flags[:2] = flags
        tiles.flags[2] = int((~run).sum())
        tiles.flags[3] = int((copy & ~run).sum())
        return new, tiles.flags[:2]

    flood_block.flood_block_kernel = flood_tiled
    flood_block.flood_block = lambda *a, **k: flood_block.flood_block_kernel(*a, **k)
    _ext.lib = lambda: None
    _ext.library_path = lambda: "(no library: rehearsal)"


class _Event:
    def __init__(self, **_):
        self.t = 0.0

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def main() -> int:
    sys.path.insert(0, ROOT)
    path = os.path.join(ROOT, "chip_smoke.py")
    src = open(path).read()
    for old, new in CUTS:
        if old not in src:
            raise SystemExit(f"chip_smoke.py no longer contains {old!r}: update CUTS")
        src = src.replace(old, new)
    _fake_kernels()
    torch.cuda.is_available = lambda: True
    torch.cuda.get_device_name = lambda i=0: "rehearsal (CPU)"
    torch.cuda.device_count = lambda: 1
    torch.cuda.synchronize = lambda *a: None
    torch.cuda.Event = _Event
    mod = types.ModuleType("chip_smoke_rehearsal")
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    mod.gpu_line = lambda: "rehearsal (CPU), no power limit"
    # The spawned processes (the 2x2 mesh's ranks, phase 24, phase 25's
    # references) import their function by name: take it from chip_smoke.py
    # itself (this module exists in this process only).
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    smoke = importlib.import_module("chip_smoke")
    mod.mesh_rank, mod.traced_rank, mod.morph_reference = smoke.mesh_rank, smoke.traced_rank, smoke.morph_reference
    if "--mesh" in sys.argv[1:]:
        return mesh_only(mod)
    if "--late" in sys.argv[1:]:
        return late_only(mod)
    if "--y0" in sys.argv[1:]:
        return y0_only(mod)
    return mod.main()


def mesh_only(mod) -> int:
    """Phases 21-23 of the rehearsal alone, their inputs made as main()
    makes them at the cut size."""
    import numpy as np

    from rustronomy_watershed_tpu_torch.ops import pack
    from rustronomy_watershed_tpu_torch.prelude import TransformBuilder

    dev, side = torch.device("cpu"), mod.SIDE
    rng = np.random.default_rng(0)
    dots = rng.integers(0, 254, (side, side)).astype(np.uint8)
    dots[rng.random((side, side)) < 0.1] = 255
    img_np = np.random.default_rng(0).integers(0, 254, (side, side)).astype(np.uint8)
    v, key0, lab0, _ = pack.pack_kernel(torch.from_numpy(img_np))
    pimg = np.load(os.path.join(mod.GOLDEN, "golden_morph_v1.npz"))["img"][:96, :112]

    def timed(fn):
        t0 = time.perf_counter()
        return fn(), (time.perf_counter() - t0) * 1e3

    def builder(variant, device=None, **opts):
        tb = TransformBuilder.default().set_device(device or dev)
        for setter, args in opts.items():
            tb = getattr(tb, setter)(*args)
        return getattr(tb, f"build_{variant}")()

    ws = builder("segmenting")
    out = mod.mesh_phases(types.SimpleNamespace(
        dev=dev, gpu=mod.gpu_line(), to_dev=lambda a: torch.from_numpy(np.ascontiguousarray(a)),
        median_ms=lambda fn, reps: timed(fn)[1], timed=timed, builder=builder,
        ws=ws, v=v, key0=key0, lab0=lab0, img_np=img_np, dots=dots, pimg=pimg, pseeds=ws.find_local_minima(pimg),
    ))
    print(out)
    return 0


def late_only(mod) -> int:
    """Phases 24-25 of the rehearsal alone."""
    import numpy as np

    from rustronomy_watershed_tpu_torch.prelude import TransformBuilder

    dev = torch.device("cpu")

    def timed(fn):
        t0 = time.perf_counter()
        return fn(), (time.perf_counter() - t0) * 1e3

    def builder(variant):
        return getattr(TransformBuilder.default().set_device(dev), f"build_{variant}")()

    mod.late_phases(types.SimpleNamespace(
        dev=dev, gpu=mod.gpu_line(), to_dev=lambda a: torch.from_numpy(np.ascontiguousarray(a)), timed=timed,
        builder=builder, ws=builder("segmenting"),
    ))
    return 0


def y0_only(mod) -> int:
    """Phase 26 of the rehearsal alone, on planes packed as main() and
    phase 19 pack them at the cut sizes."""
    import numpy as np

    from rustronomy_watershed_tpu_torch.ops import pack
    from torch_fields import cone_lattice, seed_lattice

    side, big = mod.SIDE, mod.BIG
    rng = np.random.default_rng(0)
    dots = rng.integers(0, 254, (side, side)).astype(np.uint8)
    dots[rng.random((side, side)) < 0.1] = 255
    img_np = np.random.default_rng(0).integers(0, 254, (side, side)).astype(np.uint8)
    dots16 = np.random.default_rng(0).integers(0, 254, (big, big)).astype(np.uint8)
    dots16[np.random.default_rng(1).random((big, big)) < 0.1] = 255

    def median_ms(fn, reps):
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    out = mod.y0_phase(types.SimpleNamespace(
        gpu=mod.gpu_line(), to_dev=lambda a: torch.from_numpy(np.ascontiguousarray(a)), median_ms=median_ms,
        planes=pack.pack_kernel(torch.from_numpy(img_np))[:3], planes16=pack.pack_kernel(torch.from_numpy(dots16))[:3],
        fields={"uniform": img_np, "10% dots": dots, "seed lattice": seed_lattice((side, side)),
                "cone lattice": cone_lattice((side, side))},
    ))
    print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
