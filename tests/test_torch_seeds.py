"""Port parity: seed mask, row-major numbering, paint_seeds, stencils and the
pre-processor of rustronomy_watershed_tpu_torch against the JAX package.
All outputs are integer (or u8) and must be bit-equal: tolerance 0."""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustronomy_watershed_tpu.ops import preprocess as jpre
from rustronomy_watershed_tpu.ops import seeds as jseeds
from rustronomy_watershed_tpu.ops import stencil as jstencil
from rustronomy_watershed_tpu_torch.ops import preprocess as tpre
from rustronomy_watershed_tpu_torch.ops import seeds as tseeds
from rustronomy_watershed_tpu_torch.ops import stencil as tstencil

torch.set_num_threads(1)

SHAPES = [(1, 1), (2, 5), (3, 3), (41, 17), (64, 64)]


def _field(shape, seed=0, hi=256):
    """u8 field with ~10% 255-dots (a 255 pixel can be a seed, quirk Q1)."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, hi, size=shape).astype(np.uint8)
    img[rng.random(shape) < 0.1] = 255
    return img


@pytest.mark.parametrize("mode", ["reference", "minima"])
@pytest.mark.parametrize("shape", SHAPES)
def test_local_extrema_mask_matches_jax(shape, mode):
    img = _field(shape, seed=shape[0] * 100 + shape[1])
    want = np.asarray(jseeds.local_extrema_mask(jnp.asarray(img), mode=mode))
    got = tseeds.local_extrema_mask(torch.from_numpy(img), mode).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_seed_numbering_matches_jax(shape):
    img = _field(shape, seed=7, hi=4 if shape[0] > 3 else 256)  # plateau-heavy
    mask = np.asarray(jseeds.local_extrema_mask(jnp.asarray(img)))
    want = np.asarray(jseeds.seed_labels_from_mask(jnp.asarray(mask)))
    got = tseeds.seed_labels_from_mask(torch.from_numpy(np.array(mask)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", SHAPES)
def test_paint_seeds_matches_jax(shape):
    rng = np.random.default_rng(3)
    n = shape[0] * shape[1]
    flat = rng.integers(0, n, size=max(1, n // 3))
    # Duplicates on purpose: the later seed wins at a shared coordinate.
    seeds = [(int(i) // shape[1], int(i) % shape[1]) for i in np.concatenate([flat, flat[:2]])]
    want = np.asarray(jseeds.paint_seeds(shape, seeds))
    got = tseeds.paint_seeds(shape, seeds)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tseeds.paint_seeds(shape, []), np.zeros(shape, np.int32))


@pytest.mark.parametrize("shape", [(1, 1), (3, 4), (9, 7)])
def test_shifts_match_jax(shape):
    a = np.random.default_rng(5).integers(-50, 50, size=shape).astype(np.int32)
    for jfn, tfn in ((jstencil.shift4, tstencil.shift4), (jstencil.shift8, tstencil.shift8)):
        for w, g in zip(jfn(jnp.asarray(a), -7), tfn(torch.from_numpy(a), -7)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        tstencil.interior_mask(shape, "cpu").numpy(), np.asarray(jstencil.interior_mask(shape))
    )


@pytest.mark.parametrize("max_val", [254, 100])
def test_pre_process_matches_jax(max_val):
    x = np.random.default_rng(9).normal(size=(13, 11)) * 50
    x[0, 0], x[1, 1], x[2, 2], x[3, 3] = np.nan, np.inf, -np.inf, 0.0
    x[4, 4] = 1e-310  # subnormal -> NEVER_FILL (quirk Q4)
    np.testing.assert_array_equal(tpre.pre_process(x, max_val), jpre.pre_process(x, max_val))
    with pytest.raises(ValueError):
        tpre.pre_process(x, 255)


def test_import_leaves_jax_out():
    code = (
        "import sys, rustronomy_watershed_tpu_torch, rustronomy_watershed_tpu_torch.prelude, "
        "rustronomy_watershed_tpu_torch.convert, rustronomy_watershed_tpu_torch.ops.pipeline, "
        "rustronomy_watershed_tpu_torch.parallel; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'rustronomy_watershed_tpu.'))]; "
        "sys.exit(1 if bad or 'rustronomy_watershed_tpu' in sys.modules else 0)"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the refusal is for hosts without it")
    from rustronomy_watershed_tpu_torch.ops.pack import pack_domain_fused
    from rustronomy_watershed_tpu_torch.ops.pipeline import watershed_e2e
    from rustronomy_watershed_tpu_torch.prelude import TransformBuilder

    img = _field((8, 8))
    ws = TransformBuilder.default().build_segmenting()  # default device: cuda
    for call in (
        lambda: ws.find_local_minima(img),
        lambda: ws.transform(img, [(3, 3)]),
        lambda: watershed_e2e(img),
        lambda: pack_domain_fused(img, "cuda"),
    ):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
