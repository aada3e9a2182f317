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
from rustronomy_watershed_tpu_torch.ops import pack, priority, relax
from rustronomy_watershed_tpu_torch.ops.pipeline import watershed_e2e
from rustronomy_watershed_tpu_torch.ops.seeds import local_extrema_mask, seed_labels_from_mask

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
    "shape,hi", [((1, 1), 256), ((2, 5), 256), ((63, 97), 256), ((300, 1000), 4), ((1024, 1024), 255)]
)
def test_pack_kernel_matches_twin(cuda, shape, hi):
    img = torch.from_numpy(_field(shape, hi)).to(cuda)
    _ext.reset_launches()
    got = pack.pack_domain_fused(img, cuda)
    assert _ext.launches["pack"] == 1 and _ext.launches["pack_plain"] == 0
    _assert_same(got, pack.pack_plain(img))


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
