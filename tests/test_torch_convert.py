"""State carried between the JAX package and the port (convert.py): the port's
relax started from a JAX-produced pack state, and from a JAX mid-relaxation
state, reaches the JAX fixed point.  Integer planes, tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustronomy_watershed_tpu.ops import pallas_relax as jrelax
from rustronomy_watershed_tpu.ops.pallas_pack import pack_domain_fused as j_pack_fused
from rustronomy_watershed_tpu.prelude import TransformBuilder as JaxBuilder
from rustronomy_watershed_tpu_torch.convert import (
    builder_from_jax,
    planes_from_jax,
    planes_to_jax_layout,
)
from rustronomy_watershed_tpu_torch.ops import relax
from rustronomy_watershed_tpu_torch.ops.pack import pack_plain

torch.set_num_threads(1)

TILE = STEPS = 8


def _jax_state(img):
    return j_pack_fused(jnp.asarray(img), TILE, STEPS, interpret=True)[:3]


@pytest.mark.parametrize("shape", [(1, 1), (13, 29), (40, 17)])
def test_planes_round_trip(shape):
    img = np.random.default_rng(shape[1]).integers(0, 256, size=shape).astype(np.uint8)
    v, key, lab, _ = pack_plain(torch.from_numpy(img))
    padded = planes_to_jax_layout(v, key, lab, TILE, STEPS)
    back = planes_from_jax(*padded, STEPS, STEPS, *shape, device="cpu")
    for a, b in zip(back, (v, key, lab)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    if min(shape) >= 3:  # the JAX pack kernel needs a real interior
        for a, b in zip(_jax_state(img), padded):
            np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("jax_calls", [0, 1])
def test_port_relax_from_jax_state_reaches_jax_fixed_point(jax_calls):
    img = np.random.default_rng(21).integers(0, 40, size=(35, 30)).astype(np.uint8)
    v_pad, k_pad, l_pad = _jax_state(img)
    want_k, want_l, _ = jrelax.relax_fixed_point(v_pad, k_pad, l_pad, tile=TILE, steps=STEPS, interpret=True)
    for _ in range(jax_calls):  # a mid-relaxation state (one dense call)
        gy = (k_pad.shape[0] - 2 * STEPS) // TILE
        k_pad, l_pad = jrelax.relax_block(
            v_pad, k_pad, l_pad, jnp.ones((gy,), jnp.int32), tile=TILE, steps=STEPS, interpret=True
        )[:2]
    v, key, lab = planes_from_jax(v_pad, k_pad, l_pad, STEPS, STEPS, *img.shape, device="cpu")
    got_k, got_l, starved = relax.relax_fixed_point(v, key, lab, steps=5)
    want = planes_from_jax(v_pad, want_k, want_l, STEPS, STEPS, *img.shape, device="cpu")
    np.testing.assert_array_equal(got_k.numpy(), want[1].numpy())
    np.testing.assert_array_equal(got_l.numpy(), want[2].numpy())
    assert starved is False


def test_builder_from_jax():
    jb = JaxBuilder.default().set_max_water_lvl(77).enable_edge_correction()
    tb = builder_from_jax(jb, device="cpu")
    assert (tb.max_water_level, tb.edge_correction, tb.device) == (77, True, "cpu")
    img = np.random.default_rng(2).integers(0, 90, size=(20, 22)).astype(np.uint8)
    seeds = [(3, 3), (15, 17), (0, 4)]
    np.testing.assert_array_equal(
        tb.build_segmenting().transform(img, seeds), np.asarray(jb.build_segmenting().transform(img, seeds))
    )
    with pytest.raises(ValueError, match="a JAX Mesh"):  # a JAX mesh translates (test_torch_mesh_batch.py)
        builder_from_jax(JaxBuilder.default().set_mesh(object()), device="cpu")
    # Progress is served: the same labels and progress bar as the JAX builder.
    jb = JaxBuilder.default().set_max_water_lvl(40).enable_progress()
    tb = builder_from_jax(jb, device="cpu")
    assert tb.progress and tb.max_water_level == 40
    np.testing.assert_array_equal(
        tb.build_merging().transform(img, seeds), np.asarray(jb.build_merging().transform(img, seeds))
    )
    with pytest.raises(NotImplementedError, match="JAX sweep function"):
        builder_from_jax(JaxBuilder.default().set_sweep_impl(lambda *a: None), device="cpu")
    # The random tie-break is served: the option and its seed carry over,
    # and the merging labels (which no draw changes) equal the JAX builder's.
    jb = JaxBuilder.default().set_tie_break("random", 1)
    tb = builder_from_jax(jb, device="cpu")
    assert (tb.tie_break, tb.tie_break_seed) == ("random", 1)
    np.testing.assert_array_equal(
        tb.build_merging().transform(img, seeds), np.asarray(jb.build_merging().transform(img, seeds))
    )
