"""Port parity: the pack stage (plain twin of csrc/pack.cu, and pack_domain
for painted seeds) against the JAX fused pack kernel in interpret mode and
the JAX pack_domain, compared on the image region through
convert.planes_from_jax.  Integer planes, tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustronomy_watershed_tpu.ops.pallas_pack import pack_domain_fused as j_pack_fused
from rustronomy_watershed_tpu.ops.pallas_relax import pack_domain as j_pack_domain
from rustronomy_watershed_tpu_torch import _ext
from rustronomy_watershed_tpu_torch.constants import _UNCLAIMED, NEVER_FILL
from rustronomy_watershed_tpu_torch.convert import planes_from_jax
from rustronomy_watershed_tpu_torch.ops import pack
from rustronomy_watershed_tpu_torch.ops.seeds import paint_seeds

torch.set_num_threads(1)


def _field(shape, seed, hi=255):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, hi, size=shape).astype(np.uint8)
    img[rng.random(shape) < 0.1] = 255
    return img


def _assert_planes_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize(
    "shape,tile,steps,hi",
    [((64, 64), 64, 16, 255), ((41, 17), 8, 8, 255), ((30, 52), 8, 8, 4)],
)
def test_pack_plain_matches_jax_fused_kernel(shape, tile, steps, hi):
    img = _field(shape, seed=shape[0], hi=hi)
    v_pad, k_pad, l_pad, n = j_pack_fused(jnp.asarray(img), tile, steps, interpret=True)
    want = planes_from_jax(v_pad, k_pad, l_pad, steps, steps, *shape)
    got = pack.pack_domain_fused(img, "cpu")
    _assert_planes_equal(got[:3], want)
    assert got[3].dtype == torch.int32 and int(got[3]) == int(n)


@pytest.mark.parametrize("shape", [(1, 1), (2, 5), (7, 2)])
def test_pack_plain_images_under_3_px_have_no_seeds(shape):
    img = _field(shape, seed=1)
    v, key, lab, n = pack.pack_plain(torch.from_numpy(img))
    want_v = np.full(shape, NEVER_FILL, np.uint8)
    np.testing.assert_array_equal(v.numpy(), want_v)
    assert int(n) == 0
    assert (key == _UNCLAIMED).all() and (lab == 0).all()


def test_pack_domain_matches_jax_with_border_seeds():
    shape = (20, 26)
    img = _field(shape, seed=4)
    seeds = [(0, 5), (3, 3), (19, 25), (10, 0), (12, 13)]  # border seeds: edge correction (Q7)
    lab0 = paint_seeds(shape, seeds)
    want = planes_from_jax(*j_pack_domain(jnp.asarray(img), jnp.asarray(lab0), 8, 8), 8, 8, *shape)
    got = pack.pack_domain(torch.from_numpy(img), torch.from_numpy(lab0))
    _assert_planes_equal(got, want)


def test_pack_domain_copies_its_labels():
    lab0 = torch.from_numpy(paint_seeds((6, 6), [(2, 2)]))
    _, _, lab = pack.pack_domain(torch.zeros((6, 6), dtype=torch.uint8), lab0)
    assert lab.data_ptr() != lab0.data_ptr()


def test_pack_dispatch_runs_twin_on_cpu_only():
    _ext.reset_launches()
    pack.pack_domain_fused(_field((9, 9), seed=2), torch.device("cpu"))
    assert _ext.launches["pack_plain"] == 1 and _ext.launches["pack"] == 0
    with pytest.raises(ValueError):
        pack.pack_kernel(torch.zeros((4, 4), dtype=torch.int32))
