"""Port parity for the wide-image relax path: csrc/relax.cu computes the
column-striped TPU kernel's function.  ``relax_block_plain`` (the kernel's
twin; the port tiles every width in 2-D and has no stripe geometry) against
single ``relax_block2d`` calls in Pallas interpret mode, with and without the
statistics epilogue, call by call from the packed state; and the port's fixed
point against ``relax_packed_planes(stripes=(nx, cw))``
(tests/test_stripes.py:38-65).  Integer outputs, tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustronomy_watershed_tpu.ops import pallas_relax as jrelax
from rustronomy_watershed_tpu_torch.ops import relax

torch.set_num_threads(1)
HALO = jrelax._STRIPE_HALO
GEOMETRIES = [(96, 320, 2, 256), (64, 500, 2, 256), (72, 700, 3, 256)]


def _seeded(seed, h, w, n):
    """tests/test_stripes.py::_seeded: a 0..39 field and up to ``n`` seeds."""
    gen = np.random.default_rng(seed)
    img = gen.integers(0, 40, (h, w)).astype(np.uint8)
    lab0 = np.zeros((h, w), np.int32)
    k = 1
    for _ in range(n):
        r, c = gen.integers(1, h - 1), gen.integers(1, w - 1)
        if lab0[r, c] == 0:
            lab0[r, c] = k
            k += 1
    return img, lab0


@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("h,w,nx,cw", GEOMETRIES)
def test_relax_block_plain_matches_relax_block2d(h, w, nx, cw, stats):
    """Three successive calls of 8 sweeps from the packed planes: keys,
    labels, the per-program flags reduced (any change, not converged, any
    saturation) and, with the stats-only epilogue, the statistics reduced
    (sum, max, min) equal the twin's."""
    steps, tile = 8, 32
    img, lab0 = _seeded(h * w, h, w, 12)
    v_pad, key_pad, lab_pad = jrelax.pack_domain(img, lab0, tile, steps, wp=nx * cw + 2 * HALO, col_off=HALO)
    crop = (slice(steps, steps + h), slice(HALO, HALO + w))
    v = torch.from_numpy((np.asarray(v_pad, np.int32)[crop] + 128).astype(np.uint8))
    key = torch.from_numpy(np.array(key_pad[crop]))
    lab = torch.from_numpy(np.array(lab_pad[crop]))
    dst = (jnp.full_like(key_pad, jrelax._UNCLAIMED), jnp.zeros_like(lab_pad))
    kw = dict(fused_scan=(HALO, HALO + w - 1, h), scan_stats_only=True) if stats else {}
    for call in range(3):
        outs = jrelax.relax_block2d(v_pad, key_pad, lab_pad, *dst, nx=nx, cw=cw, tile=tile, steps=steps,
                                    interpret=True, **kw)
        key2, lab2, flags, not_conv, sat = outs[:5]
        want = [int(np.any(np.asarray(flags))), int(bool(not_conv)), int(np.any(np.asarray(sat)))]
        if stats:
            ms = np.asarray(outs[5])
            want += [int(ms[:, 0].sum()), int(ms[:, 1].max() > 0), int(ms[:, 2].min())]
        key, lab, got_flags = relax.relax_block_plain(v, key, lab, steps, stats=stats)
        np.testing.assert_array_equal(key.numpy(), np.asarray(key2)[crop], err_msg=f"keys, call {call}")
        np.testing.assert_array_equal(lab.numpy(), np.asarray(lab2)[crop], err_msg=f"labels, call {call}")
        assert got_flags.tolist() == want, f"flags, call {call}"
        dst, key_pad, lab_pad = (key_pad, lab_pad), key2, lab2
    assert want[0] == 1  # the calls did relax something


@pytest.mark.parametrize("h,w,nx,cw", GEOMETRIES)
def test_fixed_point_matches_striped_engine(h, w, nx, cw):
    img, lab0 = _seeded(h + w, h, w, 12)
    k2, l2, p2, c2, _, s2 = jrelax.relax_packed_planes(img, lab0, steps=8, interpret=True, stripes=(nx, cw))
    assert c2 == HALO
    key, lab, starved = relax.relax_packed_planes(img, torch.from_numpy(lab0), device="cpu")
    np.testing.assert_array_equal(key.numpy(), np.asarray(k2)[p2 : p2 + h, c2 : c2 + w])
    np.testing.assert_array_equal(lab.numpy(), np.asarray(l2)[p2 : p2 + h, c2 : c2 + w])
    assert not starved and not bool(s2)
