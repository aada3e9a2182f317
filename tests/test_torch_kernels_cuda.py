"""The CUDA kernels against their plain PyTorch twins, on the card.

Marked ``cuda``: each test skips on a host without a CUDA device.  On the GPU
host (which has no JAX) run them without the JAX test configuration:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

Integer planes and flags, tolerance 0.
"""

import numpy as np
import pytest
import torch

from rustronomy_watershed_tpu_torch import _ext
from rustronomy_watershed_tpu_torch.ops import flood_block, pack, priority, relax
from rustronomy_watershed_tpu_torch.ops import scan_merge as sm
from rustronomy_watershed_tpu_torch.ops.pipeline import watershed_e2e
from rustronomy_watershed_tpu_torch.ops.seeds import local_extrema_mask, paint_seeds, seed_labels_from_mask
from rustronomy_watershed_tpu_torch.prelude import TransformBuilder
from torch_fields import corridor, plateau, seed_lattice, serpentine

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run this file on the GPU host)")
    return torch.device("cuda")


def _field(shape, hi, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, hi, size=shape).astype(np.uint8)
    img[rng.random(shape) < 0.1] = 255
    return img


def _assert_same(got, want):
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize(
    "shape,hi,route",
    [
        ((1, 1), 256, "bytes"), ((2, 5), 256, "bytes"), ((63, 97), 256, "bytes"), ((300, 1000), 4, "bytes"),
        ((41, 17), 256, "bytes"), ((1024, 1024), 255, "vec"), ((37, 4096), 255, "vec"), ((4099, 4112), 255, "vec"),
        ((3, 16384), 255, "vec"), ((130, 16400), 255, "rows"), ((5, 70000), 255, "rows"),
    ],
)
def test_pack_kernel_matches_twin(cuda, shape, hi, route):
    """Widths that are multiples of 16 (16-byte route) and not (byte
    route), heights that end mid-band, many bands, and rows past the band
    kernel (the three-launch route); the route counted."""
    img = torch.from_numpy(_field(shape, hi)).to(cuda)
    assert pack.pack_plan(*shape)["route"] == route
    _ext.reset_launches()
    got = pack.pack_domain_fused(img, cuda)
    assert _ext.launches["pack"] == _ext.launches[f"pack_{route}"] == 1 and _ext.launches["pack_plain"] == 0
    _assert_same(got, pack.pack_plain(img))


@pytest.mark.parametrize(
    "shape,route", [((64, 96), "vec"), ((63, 97), "bytes"), ((4096, 4096), "vec"), ((517, 16384), "vec"), ("unaligned", "bytes")]
)
def test_pack_kernel_dense_fields(cuda, shape, route):
    """The seed lattice (a seed at every interior (odd, odd) pixel: about
    h*w/4 seeds, two rows' counts near their packed limit) and a 0..3
    plateau field; an image one byte past a 16-byte line takes the byte
    route."""
    for make in (seed_lattice, plateau):
        if shape == "unaligned":
            a = make((40, 64))
            buf = torch.empty(a.size + 1, dtype=torch.uint8, device=cuda)
            img = buf[1:].view(a.shape)
            img.copy_(torch.from_numpy(a))
        else:
            img = torch.from_numpy(make(shape)).to(cuda)
        _ext.reset_launches()
        got = pack.pack_kernel(img)
        assert _ext.launches[f"pack_{route}"] == 1
        want = pack.pack_plain(img)
        _assert_same(got, want)
        if make is seed_lattice:
            h, w = img.shape
            assert int(got[3]) == ((h - 1) // 2) * ((w - 1) // 2)


@pytest.mark.parametrize("steps", [1, 8, 16, 27])
@pytest.mark.parametrize("shape", [(5, 7), (130, 257)])
def test_relax_kernel_matches_twin(cuda, shape, steps):
    img = torch.from_numpy(_field(shape, 40, seed=steps)).to(cuda)
    v, key, lab, _ = pack.pack_kernel(img)
    for _ in range(2):  # from the fresh pack state, then mid-relaxation
        got = relax.relax_block(v, key, lab, steps)
        _assert_same(got, relax.relax_block_plain(v, key, lab, steps))
        key, lab = got[0], got[1]


def test_relax_kernel_narrow_d_field(cuda):
    """A 7-bit d field saturates on a long corridor; kernel == twin."""
    img = np.full((41, 38), 255, np.uint8)
    img[1:40:2, 1:37] = 5
    img[2:39:4, 36] = 5
    img[4:39:4, 1] = 5
    lab0 = torch.zeros(img.shape, dtype=torch.int32, device=cuda)
    lab0[1, 1] = 1
    v, key, lab = pack.pack_domain(torch.from_numpy(img).to(cuda), lab0, d_bits=7)
    for _ in range(30):
        got = relax.relax_block(v, key, lab, 8, 7)
        _assert_same(got, relax.relax_block_plain(v, key, lab, 8, 7))
        key, lab = got[0], got[1]
    assert got[2][relax.SAT].item() == 1


def test_e2e_matches_exact_engine(cuda):
    img = torch.from_numpy(_field((512, 640), 254, seed=5)).to(cuda)
    want, _ = priority.relax_transform(img, seed_labels_from_mask(local_extrema_mask(img)))
    _ext.reset_launches()
    got = watershed_e2e(img, device=cuda)
    assert _ext.launches["pack"] == 1 and _ext.launches["relax"] >= 1
    assert _ext.launches["pack_plain"] == 0 and _ext.launches["relax_plain"] == 0
    assert torch.equal(got, want)


def test_relax_kernel_refuses_aliased_output(cuda):
    v, key, lab, _ = pack.pack_kernel(torch.from_numpy(_field((16, 16), 9)).to(cuda))
    with pytest.raises(ValueError, match="alias"):
        relax.relax_block(v, key, lab, 4, out=(key, torch.empty_like(lab)))


@pytest.mark.parametrize("shape", [(5, 7), (130, 257), (2, 64)])
@pytest.mark.parametrize("border_seed", [False, True])
def test_relax_stats_match_twin(cuda, shape, border_seed):
    img = torch.from_numpy(_field(shape, 254, seed=shape[0])).to(cuda)
    v, key, lab, _ = pack.pack_kernel(img)
    if border_seed:
        key[0, shape[1] // 2], lab[0, shape[1] // 2] = 0, 10**6
    for _ in range(3):
        got = relax.relax_block(v, key, lab, 8, stats=True)
        _assert_same(got, relax.relax_block_plain(v, key, lab, 8, stats=True))
        assert got[2].shape == (6,)
        key, lab = got[0], got[1]


@pytest.mark.parametrize("steps", [1, 8, 27])
@pytest.mark.parametrize("shape", [(5, 7), (130, 257), (2, 64), (3000, 300), (97, 16384)])
def test_relax_y0_epilogue_matches_twin(cuda, shape, steps):
    """The y0 epilogue (many tile rows: the look-back; odd widths: the
    cell-wise stores) against the twin, call by call from the fresh pack
    state, and the fused fixed point on the card against the CPU's."""
    img = torch.from_numpy(_field(shape, 254, seed=shape[1])).to(cuda)
    v, key, lab, _ = pack.pack_kernel(img)
    k, l = key, lab
    _ext.reset_launches()
    for _ in range(3):
        got = relax.relax_block(v, k, l, steps, fwd_scan=True)
        _assert_same(got, relax.relax_block_plain(v, k, l, steps, fwd_scan=True))
        assert len(got) == 4 and got[2].shape == (6,)
        k, l = got[0], got[1]
    assert _ext.launches["relax_y0"] == _ext.launches["relax"] == 3
    fused = relax.relax_fixed_point(v, key.clone(), lab.clone(), steps=steps, fwd_scan=True)
    want = relax.relax_fixed_point(v.cpu(), key.cpu(), lab.cpu(), steps=steps, fwd_scan=True)
    torch.cuda.synchronize()
    for g, w in zip(fused, want):
        assert torch.equal(g.cpu(), w) if torch.is_tensor(g) else g == w


def test_relax_y0_refused_on_a_call_that_may_skip_tiles(cuda):
    """Only the fixed point's first call (no previous call's tile flags) may
    run the y0 epilogue: a later call with tile state raises."""
    img = torch.from_numpy(_field((300, 300), 254, seed=1)).to(cuda)
    v, key, lab, _ = pack.pack_kernel(img)
    tiles = relax._Tiles(relax.relax_plan(300, 300, 8), 6, cuda)
    assert tiles.plan["skip"]
    k, l, _, y0 = relax.relax_block(v, key, lab, 8, fwd_scan=True, tiles=tiles)
    torch.cuda.synchronize()
    assert torch.equal(y0, sm.fwd_v_plain(l)[0])
    with pytest.raises(ValueError, match="every tile"):
        relax.relax_block(v, k, l, 8, fwd_scan=True, tiles=tiles)
    with pytest.raises(ValueError, match="rectangle"):
        relax.relax_block(v, key, lab, 8, fwd_scan=True, ctr=(8, 292, 8, 292))


def _relaxed_labels(shape, seed, nan=0.1):
    """A fixed point's label plane: the merging tail's input."""
    img = _field(shape, 254, seed=seed)
    img[np.random.default_rng(seed + 1).random(shape) < nan] = 255
    return relax.relax_packed_planes(img, None, device="cuda")[1]


@pytest.mark.parametrize("shape", [(64, 96), (1023, 1031), (33, 3), (1, 5), (256, 256)])
def test_coarse_kernels_match_twins(cuda, shape):
    lab = _relaxed_labels(shape, seed=shape[1])
    c = sm.coarsen_kernel(lab)
    _assert_same([c], [sm.coarsen_plain(lab)])
    scratch = torch.empty_like(c)
    for _ in range(64):
        got = sm.coarse_round_kernel(c, scratch=scratch)
        _assert_same(got, sm.coarse_round_plain(c))
        c = got[0]
        if got[1].item() == 0:
            break
    assert got[1].item() == 0
    fine = sm.coarse_broadcast_kernel(c, lab)
    _assert_same([fine], [sm.coarse_broadcast_plain(c, lab)])
    _assert_same([fine], [sm.component_min_labels_plain(lab)])


def _sparse_labels(shape, seed):
    rng = np.random.default_rng(seed)
    return np.where(rng.random(shape) < 0.3, 0, rng.integers(1, 1 << 24, shape)).astype(np.int32)


@pytest.mark.parametrize(
    "shape,route",
    [
        ((64, 96), "vec"), ((1, 8), "vec"), ((2, 4), "vec"), ((3, 4), "vec"), ((4093, 4096), "vec"),
        ((2050, 16384), "vec"), ((4096, 4096), "vec"), ((1023, 1031), "cells"), ((33, 3), "cells"),
        ((1, 5), "cells"), ("unaligned", "cells"),
    ],
)
def test_coarsen_kernel_routes_match_twin(cuda, shape, route):
    """The coarsen kernel against its twin on sparse random labels and on a
    relax fixed point: odd h and h ending mid-strip (4093 x 4096 and
    2050 x 16384: a last strip of one coarse row), w % 4 != 0, w = 3 and (1, 5)
    (a thread per cell), an unaligned plane; the route counted."""
    planes = []
    if shape == "unaligned":
        for lab in (torch.from_numpy(_sparse_labels((130, 260), 3)).to(cuda), _relaxed_labels((130, 260), seed=4)):
            planes.append(_unaligned(lab))
    else:
        planes.append(torch.from_numpy(_sparse_labels(shape, shape[1])).to(cuda))
        if min(shape) >= 3:
            planes.append(_relaxed_labels(shape, seed=shape[0]))
    for lab in planes:
        plan = sm.coarsen_plan(*lab.shape, sm._vec(lab.shape[1], lab))
        assert plan["route"] == route
        _ext.reset_launches()
        got = sm.coarsen_kernel(lab)
        assert _ext.launches["coarsen"] == _ext.launches[f"coarsen_{route}"] == 1
        _assert_same([got], [sm.coarsen_plain(lab)])


def test_merging_e2e_matches_exact_engine(cuda):
    for nan, route in ((0.0, "merge_shortcut"), (0.1, "merge_tail")):
        img = torch.from_numpy(_field((512, 640), 254, seed=5)).to(cuda)
        img[torch.from_numpy(np.random.default_rng(9).random((512, 640)) < nan).to(cuda)] = 255
        if nan == 0.0:
            img[img == 255] = 254
        seg, _ = priority.relax_transform(img, seed_labels_from_mask(local_extrema_mask(img)))
        _ext.reset_launches()
        got = watershed_e2e(img, merging=True, device=cuda)
        assert _ext.launches[route] == 1
        assert sum(_ext.launches[f"{k}_plain"] for k in _ext.KERNELS) == 0
        assert (_ext.launches["coarse_round"] > 0) == (route == "merge_tail")
        assert torch.equal(got, sm.component_min_labels_plain(seg))


def test_failed_coarse_gate_raises_on_cuda(cuda):
    """The coarse gate fails (w < 3, labels up to 2**24): the coarse engine
    raises, and the dispatcher runs the fine kernels instead, no twin, with a
    result equal to the twins' and the oracle's."""
    narrow = _relaxed_labels((257, 2), seed=4)
    narrow[::7, 0], narrow[3::11, 1] = 5, 9  # claimed border cells that merge across rows
    for lab, n_labels in ((narrow, 1 << 20), (_relaxed_labels((130, 257), seed=6), 1 << 24)):
        with pytest.raises(ValueError):
            sm.component_min_coarse(lab, n_labels)
        _ext.reset_launches()
        got, rounds = sm.component_min_labels(lab, max_label=n_labels)
        assert _ext.launches["bwd_vh"] == rounds >= 1 and _ext.launches["fwd_v"] == rounds
        assert _ext.launches["coarsen"] == 0 and sum(_ext.launches[f"{k}_plain"] for k in _ext.KERNELS) == 0
        want, want_rounds = sm.component_min_fine(lab.cpu())
        assert want_rounds == rounds
        _assert_same([got.cpu()], [want])
        _assert_same([got], [sm.component_min_labels_plain(lab)])


def _held(kernel, plain, window=None):
    """A pass for ``sm._two_pass_rounds`` that runs the kernel and asserts
    its plane and flag equal the twin's on the same input (the twin runs
    first: the kernel may write over its input).  ``window`` (the legacy
    coarse pass 2) maps the round to its h-window."""

    def run(x, k=None, out=None, scratch=None):
        hw = () if window is None else (window(k),)
        want = plain(x, *hw)
        got = kernel(x, *hw, out=out, **({} if scratch is None else {"scratch": scratch}))
        _assert_same(got, want)
        return got

    return run


# (9001, 3) and (4200, 700): more rows than the 4096 grid rows of the
# violation stencil and the windowed h-pass, so their row-stride loops run.
@pytest.mark.parametrize(
    "shape", [(64, 96), (1023, 1031), (63, 97), (4096, 1), (4096, 2), (1, 5), (9001, 3), (4200, 700), "serpentine"]
)
def test_fine_kernels_match_twins(cuda, shape):
    """Every pass of a full fine tail: planes and flags equal the twins'."""
    if shape == "serpentine":
        lab = torch.from_numpy(serpentine()).to(cuda)
    else:
        lab = _relaxed_labels(shape, seed=shape[0] + shape[1])
    got, _ = sm._two_pass_rounds(lab, _held(sm.fwd_v_kernel, sm.fwd_v_plain), _held(sm.bwd_vh_kernel, sm.bwd_vh_plain))
    _assert_same([got], [sm.component_min_labels_plain(lab)])


@pytest.mark.parametrize("h_window", [None, 256, 300])
@pytest.mark.parametrize("shape", [(64, 96), (1023, 1031), (33, 3), (200, 2000), (8400, 700)])
def test_legacy_coarse_kernels_match_twins(cuda, shape, h_window):
    """Every pass of a legacy coarse schedule with one h-window throughout:
    planes and flags equal the twins'; the fixed point broadcasts to the
    oracle's labels.  (8400, 700): 4200 coarse rows, past the windowed
    h-pass's 4096 grid rows."""
    lab = _relaxed_labels(shape, seed=shape[1], nan=0.03)
    got, _ = sm._two_pass_rounds(
        sm.coarsen_kernel(lab), _held(sm.cfwd_v_kernel, sm.cfwd_v_plain),
        _held(sm.cbwd_vh_kernel, sm.cbwd_vh_plain, lambda k: h_window),
    )
    _assert_same([sm.coarse_broadcast_kernel(got, lab)], [sm.component_min_labels_plain(lab)])


def test_legacy_schedule_on_cuda(cuda, monkeypatch):
    lab = _relaxed_labels((512, 640), seed=3)
    default, _ = sm.component_min_coarse(lab, sm._CVAL)
    monkeypatch.setattr(sm, "_COARSE_MULTI", False)
    _ext.reset_launches()
    got, rounds = sm.component_min_coarse(lab, sm._CVAL)
    assert _ext.launches["cbwd_vh"] == rounds >= 1 and _ext.launches["coarse_round"] == 0
    assert sum(_ext.launches[f"{k}_plain"] for k in _ext.KERNELS) == 0
    _assert_same([got], [default])


def test_relax_kernel_matches_twin_at_width_16384(cuda):
    """The width at which the TPU package stripes (>= 5120): one 2-D-tiled
    call equals the twin, statistics included."""
    img = torch.from_numpy(_field((40, 16384), 254, seed=16)).to(cuda)
    v, key, lab, _ = pack.pack_kernel(img)
    for stats in (False, True):
        _assert_same(relax.relax_block_kernel(v, key, lab, 8, stats=stats),
                     relax.relax_block_plain(v, key, lab, 8, stats=stats))


def _flood_state(shape, hi, lvl, seed):
    """A flood image and a label plane partly flooded from its seeds."""
    img = torch.from_numpy(_field(shape, hi, seed=seed)).to("cuda")
    lab = seed_labels_from_mask(local_extrema_mask(img))
    img = flood_block.flood_image(img)
    for _ in range(seed % 3):
        lab = flood_block.flood_block_plain(img, lab, lvl, 5)[0]
    return img, lab


@pytest.mark.parametrize("steps", [1, 8, 13])
@pytest.mark.parametrize("shape,hi", [((5, 7), 256), ((130, 257), 40), ((64, 64), 4), ((1, 9), 256)])
def test_flood_kernel_matches_twin(cuda, shape, hi, steps):
    for lvl in (0, hi // 2, 254):
        img, lab = _flood_state(shape, hi, lvl, seed=steps + lvl)
        _ext.reset_launches()
        got = flood_block.flood_block(img, lab, lvl, steps)
        assert _ext.launches["flood"] == 1 and _ext.launches["flood_plain"] == 0
        _assert_same(got, flood_block.flood_block_plain(img, lab, lvl, steps))


def test_flood_fixed_point_and_level_sweep_on_card(cuda):
    from rustronomy_watershed_tpu_torch.ops.level_driver import run_levels_impl

    img = torch.from_numpy(_field((200, 300), 254, seed=3)).to(cuda)
    lab0 = seed_labels_from_mask(local_extrema_mask(img))
    n = int(lab0.max())
    for merging in (False, True):
        want = run_levels_impl(img, lab0, n_labels=n, max_water_level=254, merging=merging, backend="relax", device=cuda)
        _ext.reset_launches()
        got = run_levels_impl(img, lab0, n_labels=n, max_water_level=254, merging=merging, backend="flood", device=cuda)
        assert _ext.launches["flood"] > 0 and _ext.launches["flood_plain"] == 0
        assert torch.equal(got, want)


def _held_level_sweep(img, merging, n, log):
    """The flood-kernel level sweep of ops/level_driver.py written out, with
    every call held against the twin's call on the same input (plane and
    flags) and its skipped tiles logged; returns the final labels."""
    from rustronomy_watershed_tpu_torch.ops.histogram import value_histogram
    from rustronomy_watershed_tpu_torch.ops.merge import merge_touching

    fimg = flood_block.flood_image(img)
    lab = seed_labels_from_mask(local_extrema_mask(img))
    scratch, tiles = lab.clone(), flood_block.flood_tiles(fimg)

    def on_call(src, dst, flags, skipped):
        _assert_same((dst, flags), flood_block.flood_block_plain(fimg, src, lvl, flood_block.DEFAULT_STEPS))
        log.append(skipped)

    vhist = value_histogram(img).tolist()
    for lvl in range(255):
        if lvl and not vhist[lvl]:
            continue
        lab, scratch, painted = flood_block.flood_fixed_point_block(fimg, lab, lvl, scratch=scratch, tiles=tiles,
                                                                    on_call=on_call)
        if merging and (painted or lvl == 0):
            lab = merge_touching(lab, n)
            scratch.copy_(lab)
    return lab


@pytest.mark.parametrize("merging", [False, True])
@pytest.mark.parametrize("kind", ["uniform", "poisson"])
def test_flood_level_sweep_skipping_matches_twin(cuda, kind, merging):
    """The skipping flood calls of a whole level sweep (the first call of a
    level on the presence bits, later calls on the change bytes, the
    post-merge copy) each equal the twin's call, tiles are skipped, and
    the labels equal the level driver's and the exact engine's."""
    from rustronomy_watershed_tpu_torch.ops.level_driver import run_levels_impl
    from torch_fields import poisson_u8

    shape = (600, 700)
    a = poisson_u8(shape, seed=2) if kind == "poisson" else _field(shape, 254, seed=9)
    img = torch.from_numpy(a).to(cuda)
    lab0 = seed_labels_from_mask(local_extrema_mask(img))
    n = int(lab0.max())
    log = []
    got = _held_level_sweep(img, merging, n, log)
    assert sum(log) > 0 and len(log) > 1, log
    _ext.reset_launches()
    drv = run_levels_impl(img, lab0, n_labels=n, max_water_level=254, merging=merging, backend="flood", device=cuda)
    assert _ext.launches["flood_tiles"] == _ext.launches["flood"] and _ext.launches["flood_tiles_skipped"] > 0
    want = run_levels_impl(img, lab0, n_labels=n, max_water_level=254, merging=merging, backend="relax", device=cuda)
    assert torch.equal(got, drv) and torch.equal(drv, want)


def test_flood_call_with_every_tile_skipped(cuda):
    """With no tile changed and not a level's first call every block
    returns at once: the output buffer is untouched, the flags are zero
    and the skipped count is the number of tiles."""
    img, lab = _flood_state((500, 700), 40, 20, seed=4)
    tiles = flood_block.FloodTiles(flood_block.flood_plan(500, 700, 8), cuda)
    out = torch.full_like(lab, -3)
    _, flags = flood_block.flood_block_kernel(img, lab, 20, 8, out=out, tiles=tiles)
    torch.cuda.synchronize()
    assert flags.tolist() == [0, 0] and tiles.flags[2].item() == tiles.plan["n_tiles"]
    assert (out == -3).all()


def test_flood_kernel_refuses_aliased_output(cuda):
    img, lab = _flood_state((16, 16), 9, 3, seed=0)
    with pytest.raises(ValueError, match="alias"):
        flood_block.flood_block(img, lab, 3, 4, out=lab)


def _fine_labels(shape, kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "zero":
        return np.zeros(shape, np.int32)
    lab = rng.integers(1, 1 << 26, shape).astype(np.int32)
    if kind == "claimed":  # every cell claimed: one run per line, one component
        return lab
    return np.where(rng.random(shape) < 0.3, 0, lab).astype(np.int32)


def _row_route(shape):
    return "chunked" if shape[1] > sm._ROW_CAP else "ring"


# h = 1, odd h, h not a multiple of the 128-row tile or the band; w = 1, 2,
# 3, odd, 16384, one row per ring step with lines that shift from row to row
# (10001), and past the ring's cap (the chunked row route).
FINE_SHAPES = [
    (1, 5), (1, 16384), (37, 1), (37, 2), (301, 3), (301, 130), (77, 1031), (130, 16384), (40, 10001), (6, 18440)
]


@pytest.mark.parametrize("kind", ["sparse", "zero", "claimed"])
@pytest.mark.parametrize("shape", FINE_SHAPES, ids=[f"{h}x{w}" for h, w in FINE_SHAPES])
def test_fine_passes_in_and_out_of_place(cuda, shape, kind):
    """Each fine pass, out of place and in place, on a plane and on pass 1's
    output, then a whole tail in place: planes and flags equal the twins';
    the row route is the one the plan names."""
    lab = torch.from_numpy(_fine_labels(shape, kind, seed=shape[0] + shape[1])).to(cuda)
    for x in (lab, sm.fwd_v_plain(lab)[0]):
        want = sm.fwd_v_plain(x)
        _assert_same(sm.fwd_v_kernel(x), want)
        xi = x.clone()
        _assert_same(sm.fwd_v_kernel(xi, out=xi), want)
        want = sm.bwd_vh_plain(x)
        _ext.reset_launches()
        _assert_same(sm.bwd_vh_kernel(x), want)
        assert _ext.launches["bwd_vh"] == _ext.launches[f"bwd_vh_{_row_route(shape)}"] == 1
        xi = x.clone()
        _assert_same(sm.bwd_vh_kernel(xi, out=xi, scratch=torch.empty_like(xi)), want)
    got, _ = sm._two_pass_rounds(lab, _held(sm.fwd_v_kernel, sm.fwd_v_plain), _held(sm.bwd_vh_kernel, sm.bwd_vh_plain))
    _assert_same([got], [sm.component_min_labels_plain(lab)])


@pytest.mark.parametrize("shape", [(4096, 4096), (300, 16384), (9001, 3), (5000, 700)])
def test_bwd_vh_violation_across_band_and_step_boundaries(cuda, shape):
    """A plane whose only violation is one vertical pair straddling a band
    start (checked through the band's shadow row), or a step start inside a
    band (checked against the previous ring buffer): flag 1, as the twin."""
    h, w = shape
    plan = sm.row_plan(h, w, _ext.sm_count(cuda))
    assert plan["route"] == "ring"
    starts = {"band": min(plan["band_rows"] * (plan["n_bands"] // 2), h - 1)}
    if plan["band_rows"] > plan["rows_per_step"] + 1:
        starts["step"] = plan["band_rows"] * (plan["n_bands"] // 2) + plan["rows_per_step"] - 1
    for where, r in starts.items():
        y = torch.zeros(shape, dtype=torch.int32, device=cuda)
        y[r - 1, w // 2], y[r, w // 2] = 5, 9  # the backward scan keeps 5 over 9: one violated pair
        want = sm.bwd_vh_plain(y)
        assert want[1].item() == 1, where
        _assert_same(sm.bwd_vh_kernel(y), want)
        y[r, w // 2] = 3  # the backward scan joins them: no violation
        want = sm.bwd_vh_plain(y)
        assert want[1].item() == 0, where
        _assert_same(sm.bwd_vh_kernel(y), want)


@pytest.mark.parametrize("shape", [(300, 4096), (300, 1031), (257, 3)])
def test_fine_scans_across_lookback_tiles(cuda, shape):
    """A column whose only change crosses a 128-row tile boundary, forward
    (fwd_v, rows 127 | 128 and 255 | 256) and backward (bwd_vh's column
    scan, counted from the bottom): planes and flags equal the twins'."""
    h, w = shape
    c = w // 2
    for r in (sm._VSCAN_TILE_ROWS, 2 * sm._VSCAN_TILE_ROWS):
        y = torch.zeros(shape, dtype=torch.int32, device=cuda)
        y[r - 1, c], y[r, c] = 5, 9  # forward: 9 becomes 5 across the tile boundary
        want = sm.fwd_v_plain(y)
        assert want[1].item() == 1
        _assert_same(sm.fwd_v_kernel(y), want)
        yi = y.clone()
        _assert_same(sm.fwd_v_kernel(yi, out=yi), want)
        y = torch.zeros(shape, dtype=torch.int32, device=cuda)
        y[h - r, c], y[h - r - 1, c] = 5, 9  # backward: 9 becomes 5 across the tile boundary
        _assert_same(sm.bwd_vh_kernel(y), sm.bwd_vh_plain(y))
        assert sm.bwd_vh_kernel(y)[0][h - r - 1, c].item() == 5


def _hold_calls(v, steps, stats, log):
    """An ``on_call`` for relax_fixed_point: each call's output planes and
    flags equal the twin's call on the same input planes."""

    def on_call(src, dst, flags, skipped):
        _assert_same((*dst, flags), relax.relax_block_plain(v, *src, steps, stats=stats))
        log.append(skipped)

    return on_call


@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("shape", [(5, 7), (130, 257), (1023, 1031), (300, 2048)])
def test_relax_fixed_point_skipping_matches_twin(cuda, shape, stats):
    """The skipping fixed point on the card: every call equals the twin's
    call from the same input (planes, flags, statistics), and the result
    equals the twin's fixed point; with steps past the tile (45) nothing is
    skipped."""
    img = torch.from_numpy(_field(shape, 254, seed=shape[1])).to(cuda)
    v, key, lab, _ = pack.pack_kernel(img)
    want = relax.relax_fixed_point(v.cpu(), key.cpu(), lab.cpu(), stats=stats)
    for steps in (relax.DEFAULT_STEPS, 45):
        log = []
        _ext.reset_launches()
        got = relax.relax_fixed_point(v, key.clone(), lab.clone(), steps=steps, stats=stats,
                                      on_call=_hold_calls(v, steps, stats, log))
        assert _ext.launches["relax"] == _ext.launches["relax_plain"] == len(log)  # the twin's calls: the check's
        assert log[0] == 0 and (relax.relax_plan(*shape, steps)["skip"] or not any(log))
        _assert_same(got[:2], [t.to(cuda) for t in want[:2]])
        assert got[2:] == want[2:]


def test_relax_fixed_point_skips_quiet_tiles(cuda):
    """A fixed point with a 40 x 40 hole cut in one corner tile (cells back
    to unclaimed, more than one call to refill): the second call skips every
    tile away from it, and each call still equals the twin's."""
    img = torch.from_numpy(_field((1024, 1024), 254, seed=7)).to(cuda)
    v, key, lab, _ = pack.pack_kernel(img)
    key, lab, _ = relax.relax_fixed_point(v, key, lab)
    key, lab = key.clone(), lab.clone()
    key[5:45, 5:45], lab[5:45, 5:45] = relax._key_consts(None)[2], 0
    log = []
    got = relax.relax_fixed_point(v, key.clone(), lab.clone(), stats=True,
                                  on_call=_hold_calls(v, relax.DEFAULT_STEPS, True, log))
    plan = relax.relax_plan(1024, 1024, relax.DEFAULT_STEPS)
    assert len(log) >= 3 and log[0] == 0 and log[1] >= plan["n_tiles"] - 4, (log, plan)
    want = relax.relax_fixed_point(v.cpu(), key.cpu(), lab.cpu(), stats=True)
    _assert_same(got[:2], [t.to(cuda) for t in want[:2]])
    assert got[2:] == want[2:]


def test_relax_tile_and_host_read_counters(cuda):
    """``relax_tiles`` adds each launch's plan tiles and
    ``relax_tiles_skipped`` the skips that ``on_call`` sees: 0 on the first
    call, at most ``n_tiles`` after; a launch without tile state skips
    nothing.  One host read a relax call, and in the merging e2e one more a
    block of coarse tail rounds."""
    img = torch.from_numpy(_field((1024, 1024), 254, seed=7)).to(cuda)
    v, key, lab, _ = pack.pack_kernel(img)
    plan = relax.relax_plan(1024, 1024, relax.DEFAULT_STEPS)
    skipped = []
    _ext.reset_launches()
    relax.relax_fixed_point(v, key.clone(), lab.clone(), on_call=lambda src, dst, flags, s: skipped.append(s))
    n = _ext.launches
    assert n["relax"] == len(skipped) >= 2 and n["relax_tiles"] == plan["n_tiles"] * len(skipped)
    assert skipped[0] == 0 and all(0 <= s <= plan["n_tiles"] for s in skipped)
    assert n["relax_tiles_skipped"] == sum(skipped) and n["host_reads"] == len(skipped)
    relax.relax_block(v, key, lab, relax.DEFAULT_STEPS)
    assert n["relax_tiles"] == plan["n_tiles"] * (len(skipped) + 1) and n["relax_tiles_skipped"] == sum(skipped)
    _ext.reset_launches()
    watershed_e2e(img, merging=True, device=cuda)
    blocks = -(-n["coarse_round"] // sm._TAIL_BLOCK)
    assert n["merge_tail"] == 1 and n["host_reads"] == n["relax"] + blocks > n["relax"]


def test_relax_px_run_when_no_tile_is_skipped(cuda):
    """A fixed point whose plan cannot skip (steps past the tile size) runs
    every pixel in every launch, as does a launch without tile state:
    ``relax_px_run`` = launches x h x w.  The field: a corridor that snakes
    through the plane's odd rows from one painted seed, several launches
    of 48 sweeps long, on a grid of 32 x 32 tiles with clipped edges."""
    h, w = 97, 130
    lab0 = torch.zeros((h, w), dtype=torch.int32, device=cuda)
    lab0[1, 1] = 1
    v, key, lab = pack.pack_domain(torch.from_numpy(corridor(h, w)).to(cuda), lab0)
    assert not relax.relax_plan(h, w, 48)["skip"] and relax.relax_plan(h, w, 48)["grid"] == (4, 5)
    _ext.reset_launches()
    relax.relax_fixed_point(v, key.clone(), lab.clone(), steps=48)
    n = _ext.launches
    assert n["relax"] >= 2 and n["relax_tiles_skipped"] == 0 and n["relax_px_run"] == n["relax"] * h * w
    relax.relax_block(v, key, lab, 8)
    assert n["relax_px_run"] == n["relax"] * h * w


def test_relax_px_run_counts_the_tiles_that_ran(cuda):
    """Call by call, ``relax_px_run`` adds the pixels of the tiles that
    ``quiet_tiles`` of the previous call's tile flags leaves running, the
    edge tiles of a 4096 x 4100 plane clipped to it (64 rows, 68 columns),
    and ``relax_tiles_skipped`` the others."""
    h, w, steps = 4096, 4100, relax.DEFAULT_STEPS
    img = torch.from_numpy(_field((h, w), 254, seed=11)).to(cuda)
    v, key, lab, _ = pack.pack_kernel(img)
    plan = relax.relax_plan(h, w, steps)
    gy, gx = plan["grid"]
    rows = torch.clamp(h - torch.arange(gy) * plan["tile_y"], max=plan["tile_y"])
    cols = torch.clamp(w - torch.arange(gx) * plan["tile_x"], max=plan["tile_x"])
    assert (int(rows[-1]), int(cols[-1])) == (64, 68)
    px = (rows[:, None] * cols[None, :]).to(cuda)
    assert int(px.sum()) == h * w
    tiles = relax._Tiles(plan, 3, cuda)
    src, dst = (key, lab), (torch.empty_like(key), torch.empty_like(lab))
    _ext.reset_launches()
    n, skips = _ext.launches, []
    while True:
        run = torch.ones((gy, gx), dtype=torch.bool, device=cuda)
        if tiles.calls:
            run = ~relax.quiet_tiles(tiles.chg[(tiles.calls + 1) % 2].view(gy, gx))
        before = n["relax_px_run"]
        k2, l2, _ = relax.relax_block(v, *src, steps, out=dst, tiles=tiles)
        f, skipped = tiles.count(tiles.buf.tolist())
        assert n["relax_px_run"] - before == int(px[run].sum()) and skipped == int((~run).sum())
        skips.append(skipped)
        src, dst = (k2, l2), src
        if not f[relax.LAST]:
            break
    assert len(skips) >= 3 and skips[0] == 0 and max(skips) > 0 and n["relax_tiles_skipped"] == sum(skips)
    assert h * w < n["relax_px_run"] < n["relax"] * h * w


def test_relax_sweeps_count_each_launch_steps(cuda):
    """``relax_sweeps`` adds each launch's ``steps``: a fixed point of 8 and
    one of 12, a lone launch of 5, and the segmenting e2e."""
    img = torch.from_numpy(_field((512, 640), 254, seed=5)).to(cuda)
    v, key, lab, _ = pack.pack_kernel(img)
    _ext.reset_launches()
    n = _ext.launches
    relax.relax_fixed_point(v, key.clone(), lab.clone())
    eights = n["relax"]
    relax.relax_fixed_point(v, key.clone(), lab.clone(), steps=12)
    relax.relax_block(v, key, lab, 5)
    assert n["relax_sweeps"] == 8 * eights + 12 * (n["relax"] - eights - 1) + 5
    _ext.reset_launches()
    watershed_e2e(img, device=cuda)
    assert n["relax"] >= 2 and n["relax_sweeps"] == n["relax"] * relax.DEFAULT_STEPS


def test_relax_calls_sparse_equals_a_recount_from_the_tile_flags(cuda):
    """On a beam-smoothed map quantised on the card (the long fixed point of
    plateaus), ``relax_calls_sparse`` counts the calls whose running
    tiles, recounted from the previous call's tile flags by
    ``quiet_tiles``, are fewer than an eighth of the plan's; the whole
    fixed point and the segmenting e2e count the same on the same map."""
    from rustronomy_watershed_tpu_torch.ops.preprocess import pre_process_jnp
    from rustronomy_watershed_tpu_torch.utils.fields import gaussian_random_field, smooth

    h = w = 1024
    u8 = pre_process_jnp(smooth(gaussian_random_field((h, w), power=-3.0, seed=3), 3.3).astype(np.float32), 254,
                         device=cuda)
    v, key, lab, _ = pack.pack_kernel(u8)
    plan = relax.relax_plan(h, w, relax.DEFAULT_STEPS)
    gy, gx = plan["grid"]
    tiles = relax._Tiles(plan, 3, cuda)
    src, dst = (key.clone(), lab.clone()), (torch.empty_like(key), torch.empty_like(lab))
    _ext.reset_launches()
    n, sparse = _ext.launches, 0
    while True:
        run = plan["n_tiles"]
        if tiles.calls:
            run = int((~relax.quiet_tiles(tiles.chg[(tiles.calls + 1) % 2].view(gy, gx))).sum())
        k2, l2, _ = relax.relax_block(v, *src, relax.DEFAULT_STEPS, out=dst, tiles=tiles)
        f, skipped = tiles.count(tiles.buf.tolist())
        assert skipped == plan["n_tiles"] - run
        sparse += 8 * run < plan["n_tiles"]
        assert n["relax_calls_sparse"] == sparse
        src, dst = (k2, l2), src
        if not f[relax.LAST]:
            break
    assert n["relax"] >= 40 and 0 < sparse < n["relax"]
    _ext.reset_launches()
    relax.relax_fixed_point(v, key.clone(), lab.clone())
    assert (n["relax"], n["relax_calls_sparse"]) == (tiles.calls, sparse)
    _ext.reset_launches()
    watershed_e2e(u8, device=cuda)
    assert (n["relax"], n["relax_calls_sparse"], n["pre_process_px"]) == (tiles.calls, sparse, 0)


def _rects(h, w):
    """The whole plane, the mesh's inner rectangle, one that cuts the
    kernel's tiles off-centre, a one-row and a one-cell rectangle."""
    return [(0, h, 0, w), (8, h - 8, 8, w - 8), (37, h - 50, 13, w - 101), (h // 2, h // 2 + 1, 0, w),
            (h - 1, h, w - 1, w)]


@pytest.mark.parametrize("shape", [(130, 257), (1023, 1031), (300, 2048)])
def test_relax_kernel_rectangle_matches_twin(cuda, shape):
    """csrc/relax.cu's centre rectangle: planes and flags equal the twin's
    with the same rectangle, from a fresh, a mid and a fixed-point state."""
    img = torch.from_numpy(_field(shape, 254, seed=3)).to(cuda)
    v, key, lab, _ = pack.pack_kernel(img)
    mid = relax.relax_block_kernel(v, key, lab, 5)[:2]
    fixed = relax.relax_fixed_point(v, key.clone(), lab.clone())[:2]
    for state in ((key, lab), mid, fixed):
        for rect in _rects(*shape):
            _assert_same(relax.relax_block_kernel(v, *state, 8, ctr=rect), relax.relax_block_plain(v, *state, 8, ctr=rect))


def test_relax_kernel_rectangle_saturation(cuda):
    """The saturation bit of a 7-bit d field counts the rectangle only."""
    img = np.full((41, 38), 255, np.uint8)
    img[1:40:2, 1:37] = 5
    img[2:39:4, 36] = 5
    img[4:39:4, 1] = 5
    lab0 = torch.zeros(img.shape, dtype=torch.int32, device=cuda)
    lab0[1, 1] = 1
    v, key, lab = pack.pack_domain(torch.from_numpy(img).to(cuda), lab0, d_bits=7)
    key, lab, _ = relax.relax_fixed_point(v, key, lab, d_bits=7)
    fired = set()
    for rect in _rects(41, 38)[:2] + [(0, 2, 0, 38), (39, 41, 0, 38)]:
        got = relax.relax_block_kernel(v, key, lab, 8, 7, ctr=rect)
        _assert_same(got, relax.relax_block_plain(v, key, lab, 8, 7, ctr=rect))
        fired.add(got[2][relax.SAT].item())
    assert fired == {0, 1}


@pytest.mark.parametrize("shape", [(130, 257), (1023, 1031)])
def test_relax_fixed_point_rectangle_skipping_matches_twin(cuda, shape):
    """The skipping fixed point with a rectangle (a 1 x 1 mesh's plane):
    every call equals the twin's call with the rectangle, both ping-pong
    directions included, and the result the twin's fixed point."""
    img = torch.from_numpy(_field(shape, 254, seed=shape[1])).to(cuda)
    v, key, lab, _ = pack.pack_kernel(img)
    h, w = shape
    for rect in _rects(h, w)[1:3]:
        log = []

        def on_call(src, dst, flags, skipped, rect=rect):
            _assert_same((*dst, flags), relax.relax_block_plain(v, *src, relax.DEFAULT_STEPS, ctr=rect))
            log.append(skipped)

        got = relax.relax_fixed_point(v, key.clone(), lab.clone(), ctr=rect, on_call=on_call)
        want = relax.relax_fixed_point(v.cpu(), key.cpu(), lab.cpu(), ctr=rect)
        assert len(log) >= 2 and log[0] == 0
        _assert_same(got[:2], [t.to(cuda) for t in want[:2]])
        assert got[2:] == want[2:]


@pytest.mark.parametrize("backend", ["nccl", "gloo"])
@pytest.mark.parametrize("variant", ["segmenting", "merging"])
def test_one_by_one_mesh_on_card(cuda, tmp_path, backend, variant):
    """``set_mesh`` on a one-rank group in this process, the tile on the
    card: NCCL takes the CUDA tensors, gloo stages them through the host;
    the labels equal the single-device transform's."""
    from datetime import timedelta

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    img = _field((300, 420), 254, seed=8)
    tb = TransformBuilder().set_device(cuda)
    seeds = tb.build_segmenting().find_local_minima(img)
    want = getattr(tb, f"build_{variant}")().transform(img, seeds)
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group(backend, store=store, rank=0, world_size=1, timeout=timedelta(seconds=60))
    try:
        mesh = DeviceMesh("cuda" if backend == "nccl" else "cpu", [[0]], mesh_dim_names=("y", "x"))
        _ext.reset_launches()
        got = getattr(TransformBuilder().set_device(cuda).set_mesh(mesh), f"build_{variant}")().transform(img, seeds)
        assert _ext.launches["relax"] > 0 and _ext.launches["relax_plain"] == 0
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(got, want)


def _card_ranks(rank, img, seeds):
    """One gloo rank of a 2 x 2 mesh computing its tile on the card."""
    import torch_mesh

    mesh = torch_mesh.mesh_of((2, 2))
    tb = TransformBuilder().set_device("cuda").set_mesh(mesh)
    return [getattr(tb, f"build_{v}")().transform(img, seeds) for v in ("segmenting", "merging")]


def _nccl_ranks(rank, img, seeds):
    """One NCCL rank of a 2 x 2 mesh, its tile on card ``rank``."""
    import torch_mesh

    mesh = torch_mesh.mesh_of((2, 2), "cuda")
    tb = TransformBuilder().set_device(f"cuda:{rank}").set_mesh(mesh)
    _ext.reset_launches()
    out = [getattr(tb, f"build_{v}")().transform(img, seeds) for v in ("segmenting", "merging")]
    return out, dict(_ext.launches)


def test_two_by_two_nccl_mesh_on_four_cards(cuda, tmp_path):
    """Four NCCL ranks, a card each: the halo strips go point to point on
    the card, the reductions and the gather by NCCL; every rank's labels
    equal the single-device labels, both variants, and every rank launched
    the relax kernel with its centre rectangle."""
    from torch_mesh import run_ranks

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    img = _field((1031, 1209), 254, seed=10)
    tb = TransformBuilder().set_device(cuda)
    seeds = tb.build_segmenting().find_local_minima(img)
    want = [getattr(tb, f"build_{v}")().transform(img, seeds) for v in ("segmenting", "merging")]
    _ext.lib()
    for got, counts in run_ranks(_nccl_ranks, 4, tmp_path, img, seeds, deadline=300, backend="nccl"):
        assert counts["relax"] > 0 and counts["relax_ctr"] == counts["relax"] and counts["relax_plain"] == 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_two_by_two_gloo_mesh_on_one_card(cuda, tmp_path):
    """Four gloo ranks, each a process computing its tile on the one card,
    the strips through host memory: every rank's labels equal the
    single-device labels, both variants."""
    from torch_mesh import run_ranks

    img = _field((517, 611), 254, seed=9)
    tb = TransformBuilder().set_device(cuda)
    seeds = tb.build_segmenting().find_local_minima(img)
    want = [getattr(tb, f"build_{v}")().transform(img, seeds) for v in ("segmenting", "merging")]
    _ext.lib()  # built once here, before the ranks load it
    for got in run_ranks(_card_ranks, 4, tmp_path, img, seeds, deadline=300):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize(
    "shape,route",
    [((64, 96), "vec"), ((1025, 1028), "vec"), ((1, 4), "vec"), ((5, 4), "vec"), ((4096, 4096), "vec"),
     ((1023, 1031), "cells"), ((33, 3), "cells"), ((70001, 5), "cells"), ("unaligned", "cells")],
)
def test_coarse_broadcast_routes_match_twin(cuda, shape, route):
    """The broadcast on both routes against its twin, on sparse labels and
    a random coarse plane: odd h (a last coarse row of one fine row), w = 4
    (both border columns in one int4), w % 4 != 0, w = 3, more fine rows
    than the cell route's grid, an unaligned plane; the route counted."""
    h, w = (130, 260) if shape == "unaligned" else shape
    lab = torch.from_numpy(_sparse_labels((h, w), h + w)).to(cuda)
    vals = torch.from_numpy(np.random.default_rng(w).integers(1, 1 << 24, ((h + 1) // 2, w)).astype(np.int32)).to(cuda)
    c = (sm.coarsen_kernel(lab) & ~sm._CVAL) | vals
    if shape == "unaligned":
        lab = _unaligned(lab)
    assert sm.broadcast_plan(h, w, sm._vec(w, c, lab))["route"] == route
    _ext.reset_launches()
    got = sm.coarse_broadcast_kernel(c, lab)
    assert _ext.launches["coarse_broadcast"] == _ext.launches[f"coarse_broadcast_{route}"] == 1
    _assert_same([got], [sm.coarse_broadcast_plain(c, lab)])


def _unaligned(x):
    """A contiguous copy of ``x`` one int32 past a 16-byte line."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = buf[1:].view(x.shape)
    y.copy_(x)
    return y


@pytest.mark.parametrize("shape", [(64, 96), (1023, 1031), (33, 3), (8400, 700), (300, 18440), "unaligned"])
def test_coarse_round_routes_match_twin(cuda, shape):
    """The coarse round, round by round to the fixed point: plane and change
    count equal the twin's, on the row route the plan names (300 x 18440:
    rows past the ring, the chunked route; an unaligned plane: the scalar
    column scan)."""
    lab = _relaxed_labels((130, 260) if shape == "unaligned" else shape, seed=11)
    c = sm.coarsen_kernel(lab)
    if shape == "unaligned":
        c = _unaligned(c)
        assert not sm._vec(c.shape[1], c)
    route = "chunked" if c.shape[1] > sm._ROW_CAP else "ring"
    scratch, rounds = torch.empty_like(c), 0
    _ext.reset_launches()
    while True:
        want = sm.coarse_round_plain(c)
        got = sm.coarse_round_kernel(c, out=c, scratch=scratch)
        _assert_same(got, want)
        rounds += 1
        if got[1].item() == 0:
            break
        assert rounds < 10000
    n = _ext.launches
    assert n["coarse_round"] == n["coarse_round_launched"] == n[f"coarse_round_{route}"] == rounds
    _assert_same([sm.coarse_broadcast_kernel(c.contiguous(), lab)], [sm.component_min_labels_plain(lab)])


@pytest.mark.parametrize("shape", [(64, 96), (1023, 1031), (33, 3), (300, 18440), "unaligned"])
def test_coarse_round_go_on_the_card(cuda, shape):
    """Through the tail's launcher: a round whose ``go`` holds 0 leaves the
    plane and writes 0 to its ``changed``; one whose ``go`` is nonzero is
    the round ``go=None`` runs, on both row routes and the scalar column
    scan.  Each launch is counted as it is queued, the rounds that ran only
    when settled.  The blocked tail on the card against the twins' blocked
    tail: labels, rounds, rounds skipped and host reads."""
    lab = _relaxed_labels((130, 260) if shape == "unaligned" else shape, seed=11)
    c = sm.coarsen_kernel(lab)
    if shape == "unaligned":
        c = _unaligned(c)
    before, scratch = c.clone(), torch.empty_like(c)
    route = "chunked" if c.shape[1] > sm._ROW_CAP else "ring"
    words = torch.tensor([0, 7], dtype=torch.int32, device=cuda)  # [go, changed]
    _ext.reset_launches()
    launch = sm._round_launcher(c, c, scratch, words)
    launch(1, 0)
    _assert_same([c, words], [before, torch.zeros_like(words)])
    want = sm.coarse_round_plain(before)
    words[0] = 3
    launch(1, 0)
    _assert_same([c, words[1:]], want)
    n = _ext.launches
    assert n["coarse_round_launched"] == n[f"coarse_round_{route}"] == 2
    assert n["coarse_round"] == n["coarse_round_skipped"] == 0  # the caller settles them once read
    launch.settle(1, 1)
    assert n["coarse_round"] == n["coarse_round_skipped"] == 1
    if shape == "unaligned":
        return
    _ext.reset_launches()
    got, rounds = sm.component_min_coarse(lab, sm._CVAL)
    torch.cuda.synchronize()
    n = dict(_ext.launches)
    _ext.reset_launches()
    want, want_rounds = sm.component_min_coarse(lab.cpu(), sm._CVAL)
    p = _ext.launches
    assert torch.equal(got.cpu(), want) and rounds == want_rounds
    assert n["coarse_round"] == p["coarse_round_plain"] == rounds
    assert n["coarse_round_skipped"] == p["coarse_round_skipped"] and n["host_reads"] == p["host_reads"]
    assert n["coarse_round_launched"] == n["coarse_round"] + n["coarse_round_skipped"]


def test_blocked_coarse_tail_on_the_smoke_field(cuda):
    """``chip_smoke.py``'s 4096^2 10% NaN-dot field: the blocked tail gives
    the plane, bit for bit, and the rounds of ``go``-less rounds read one at
    a time; it reads once a block and stops ``k`` to ``2k - 1`` rounds on
    the device."""
    rng = np.random.default_rng(0)  # the draws of chip_smoke.py's main()
    img = rng.integers(0, 254, (4096, 4096)).astype(np.uint8)
    img[rng.random(img.shape) < 0.1] = 255
    lab = relax.relax_packed_planes(img, None, device="cuda")[1]
    c, want_rounds = sm.coarsen_kernel(lab), 0
    scratch = torch.empty_like(c)
    while True:
        c, changed = sm.coarse_round_kernel(c, out=c, scratch=scratch)
        want_rounds += 1
        if changed.item() == 0:
            break
    want = sm.coarse_broadcast_kernel(c, lab)
    k = sm._TAIL_BLOCK
    _ext.reset_launches()
    got, rounds = sm.component_min_coarse(lab, sm._CVAL)
    torch.cuda.synchronize()
    n = _ext.launches
    assert torch.equal(got, want) and rounds == want_rounds > k
    assert n["coarse_round"] == rounds
    assert n["coarse_round_ring"] == n["coarse_round_launched"] == rounds + n["coarse_round_skipped"]
    assert n["host_reads"] == -(-rounds // k) and k <= n["coarse_round_skipped"] <= 2 * k - 1


# Fine label shapes whose coarse planes the legacy pass 2 runs on: the
# 4096^2 NaN-dot field's 2048 x 4096, odd h and w, w = 3, w % 4 != 0 (rows
# at every phase of their 16-byte lines), many bands of few columns, rows
# past the ring, and an unaligned plane.
LEGACY_SHAPES = [(4096, 4096), (1023, 1031), (33, 3), (130, 262), (9001, 700), (300, 18440), "unaligned"]
LEGACY_WINDOWS = [None, 2, 256, 300, 8192]


@pytest.mark.parametrize("h_window", LEGACY_WINDOWS, ids=[f"win{w}" for w in LEGACY_WINDOWS])
@pytest.mark.parametrize("shape", LEGACY_SHAPES, ids=[s if isinstance(s, str) else f"{s[0]}x{s[1]}" for s in LEGACY_SHAPES])
def test_cbwd_vh_in_and_out_of_place(cuda, shape, h_window):
    """The legacy pass 2 on a coarse plane, on pass 1's output of it and on
    a plane three legacy rounds into the tail, out of place and in place
    (``out`` is the input, as the round loop passes it): plane and flag
    equal the twin's, on the row route ``legacy_row_plan`` names."""
    lab = _relaxed_labels((130, 262) if shape == "unaligned" else shape, seed=7, nan=0.05)
    c = sm.coarsen_kernel(lab)
    if shape == "unaligned":
        c = _unaligned(c)
    y = sm.cfwd_v_kernel(c)[0]
    late = y.clone()
    for k in range(3):
        late = sm.cfwd_v_kernel(sm.cbwd_vh_kernel(late, sm._legacy_window(k))[0])[0]
    hc, w = c.shape
    route = sm.legacy_row_plan(hc, w, _ext.sm_count(cuda), sm._reach(w, h_window))["route"]
    assert route == ("chunked" if w > sm._ROW_CAP else "ring")
    for x in (c, y, late):
        want = sm.cbwd_vh_plain(x, h_window)
        _ext.reset_launches()
        _assert_same(sm.cbwd_vh_kernel(x, h_window), want)
        xi = x.clone()
        _assert_same(sm.cbwd_vh_kernel(xi, h_window, out=xi, scratch=torch.empty_like(xi)), want)
        assert _ext.launches["cbwd_vh"] == _ext.launches[f"cbwd_vh_{route}"] == 2


@pytest.mark.parametrize("shape", [(2048, 4096), (4501, 700), (6000, 5), (64, 1031)])
def test_cbwd_vh_violation_across_band_and_step_boundaries(cuda, shape):
    """A coarse plane whose only violated pair straddles a band start
    (vertical, checked through the band's shadow row) or a step start
    inside a band (vertical, against the previous ring buffer), or lies in
    a band's first row or the row above it (horizontal, left unequal by a
    window of 2): flag 1, as the twin; joined, flag 0."""
    hc, w = shape
    plan = sm.legacy_row_plan(hc, w, _ext.sm_count(cuda), sm._reach(w, None))
    assert plan["route"] == "ring" and plan["n_bands"] > 2
    r0, g = plan["band_rows"] * (plan["n_bands"] // 2), plan["rows_per_step"]
    # The band's steps start at its shadow row r0 - 1: the second at r0 - 1 + g.
    rows = {"band": r0, "step": r0 - 1 + g if g > 1 else r0 + 1, "above a band": r0 - 1}
    every = 0xF << 24  # an empty cell: every reset bit, no edge
    for where, r in rows.items():
        for kind in ("v", "h"):
            if kind == "v" and where == "above a band":
                continue
            c = torch.full(shape, every, dtype=torch.int32, device=cuda)
            if kind == "v":
                x = w // 2
                c[r - 1, x] = 5 | every
                c[r, x] = 9 | (every & ~(1 << 24))  # an edge to the cell above
                joined = c.clone()
                joined[r, x] = 5 | (every & ~(1 << 24))
                cases = ((c, None, 1), (joined, None, 0))
            else:  # 3, 5, 9 along a row's last three cells, joined by edges
                c[r, w - 3] = 3 | (every & ~(1 << 27))
                c[r, w - 2] = 5 | (every & ~(1 << 26) & ~(1 << 27))
                c[r, w - 1] = 9 | (every & ~(1 << 26))
                cases = ((c, 2, 1), (c, None, 0))
            for plane, h_window, violated in cases:
                want = sm.cbwd_vh_plain(plane, h_window)
                assert want[1].item() == violated, (where, kind, h_window)
                _assert_same(sm.cbwd_vh_kernel(plane, h_window), want)


# -- the single-device options: checkpoints, the random tie-break, native ----


def _api_field(shape=(300, 420), seed=21):
    img = _field(shape, 254, seed)
    seeds = TransformBuilder.default().set_device("cpu").build_segmenting().find_local_minima(img) + [(0, 5)]
    return img, seeds


@pytest.mark.parametrize("variant", ["segmenting", "merging"])
def test_fast_path_checkpoint_on_card(cuda, tmp_path, variant):
    """Relax-plane snapshots on the card: an interrupted run resumed, and a
    stale snapshot of another field of the same shape ignored, both equal
    to the transform without checkpoints; every relax call on the kernel."""
    from rustronomy_watershed_tpu_torch.ops.ckpt_relax import ckpt_transform
    from rustronomy_watershed_tpu_torch.utils.checkpoint import TransformCheckpointer

    img, seeds = _api_field()
    merging = variant == "merging"
    plain = getattr(TransformBuilder.default().set_device("cuda"), f"build_{variant}")()
    want = plain.transform(img, seeds, device_output=True)
    lab0 = torch.from_numpy(paint_seeds(img.shape, seeds)).to(cuda)
    kw = dict(merging=merging, n_labels=len(seeds), device=cuda, steps=2)
    _ext.reset_launches()
    with pytest.raises(RuntimeError, match="forced interrupt after 2 calls"):
        ckpt_transform(torch.from_numpy(img).to(cuda), lab0, checkpointer=TransformCheckpointer(tmp_path, every=1),
                       _interrupt_after_calls=2, **kw)
    got, starved = ckpt_transform(torch.from_numpy(img).to(cuda), lab0,
                                  checkpointer=TransformCheckpointer(tmp_path, every=1), **kw)
    assert not starved and got.is_cuda and torch.equal(got, want)
    assert _ext.launches["relax"] > 2 and _ext.launches["relax_plain"] == 0
    other = img[::-1].copy()
    ws = getattr(TransformBuilder.default().set_device("cuda").set_checkpoint(tmp_path, every=1), f"build_{variant}")()
    np.testing.assert_array_equal(ws.transform(other, seeds), plain.transform(other, seeds))
    np.testing.assert_array_equal(ws.transform(img, seeds), want.cpu().numpy())


@pytest.mark.parametrize("variant", ["segmenting", "merging"])
def test_random_tie_break_card_equals_cpu(cuda, variant):
    img, seeds = _api_field((200, 240))

    def run(device, seed):
        tb = TransformBuilder.default().set_device(device).set_tie_break("random", seed)
        return getattr(tb, f"build_{variant}")().transform(img, seeds, device_output=True)

    _ext.reset_launches()
    on_card = run("cuda", 4)
    assert on_card.is_cuda
    cpu = run("cpu", 4)
    assert torch.equal(on_card.cpu(), cpu)
    assert variant == "merging" or not torch.equal(run("cuda", 5), on_card)


@pytest.mark.parametrize("variant", ["segmenting", "merging"])
def test_native_equals_auto_on_card(cuda, variant):
    img, seeds = _api_field()
    auto = getattr(TransformBuilder.default().set_device("cuda"), f"build_{variant}")()
    native = getattr(TransformBuilder.default().set_device("cuda").set_backend("native"), f"build_{variant}")()
    np.testing.assert_array_equal(native.transform(img, seeds), auto.transform(img, seeds))
    a = auto.transform_to_list(img, seeds, counts_length=len(seeds) + 1)
    n = native.transform_to_list(img, seeds, counts_length=len(seeds) + 1)
    assert all(x[0] == y[0] and np.array_equal(x[1], y[1]) for x, y in zip(a, n))
