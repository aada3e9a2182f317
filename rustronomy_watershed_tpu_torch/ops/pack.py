"""Image -> packed relax planes ``(v, key, lab)`` plus the seed count.

Counterpart of ``rustronomy_watershed_tpu.ops.pallas_pack`` (fused pack
kernel) and of ``pallas_relax.pack_domain`` (planes from painted seeds).

The planes are ``(h, w)`` with no aprons: the relax kernel reads every cell
outside the image as unclaimed with label 0, which is exactly what the TPU
layout's aprons hold.

* ``v``   uint8 — the image with its 1-px border forced to NEVER_FILL;
* ``key`` int32 — 0 at seeds, ``NEVER_FILL << d_bits`` (unclaimed) elsewhere;
* ``lab`` int32 — seed colours, 0 elsewhere.
"""

from __future__ import annotations

import torch

from .. import _ext
from ..constants import _D_BITS, NEVER_FILL, UNCOLOURED
from .seeds import local_extrema_mask, seed_labels_from_mask


def pack_domain(img: torch.Tensor, labels0: torch.Tensor, *, d_bits: int = _D_BITS):
    """Planes from an explicit label image (painted seeds; plain PyTorch —
    the JAX package computes this in jnp outside Pallas too)."""
    v = img.to(torch.uint8).clone()
    v[0, :] = NEVER_FILL
    v[-1, :] = NEVER_FILL
    v[:, 0] = NEVER_FILL
    v[:, -1] = NEVER_FILL
    # A copy: relax_fixed_point overwrites the planes it is given.
    lab = labels0.to(torch.int32, memory_format=torch.contiguous_format, copy=True)
    key = torch.where(lab != UNCOLOURED, 0, NEVER_FILL << d_bits).to(torch.int32)
    return v, key, lab


def pack_plain(img: torch.Tensor, *, d_bits: int = _D_BITS):
    """Plain twin of the pack kernel: ``(v, key, lab, n_seeds)`` with seeds
    from the image (strict local maxima, numbered row-major)."""
    _ext.launches["pack_plain"] += 1
    mask = local_extrema_mask(img)
    v, key, lab = pack_domain(img, seed_labels_from_mask(mask), d_bits=d_bits)
    return v, key, lab, mask.sum(dtype=torch.int32)


def pack_kernel(img: torch.Tensor, *, d_bits: int = _D_BITS):
    """Launch csrc/pack.cu on a CUDA uint8 image; same outputs as pack_plain."""
    if img.dtype != torch.uint8 or img.dim() != 2 or not img.is_contiguous() or not img.is_cuda:
        raise ValueError("pack kernel takes a contiguous 2-D uint8 CUDA image")
    h, w = img.shape
    v = torch.empty_like(img)
    key = torch.empty((h, w), dtype=torch.int32, device=img.device)
    lab = torch.empty_like(key)
    row_cnt = torch.empty((h,), dtype=torch.int32, device=img.device)
    n_seeds = torch.empty((), dtype=torch.int32, device=img.device)
    err = _ext.lib().rwt_pack(
        img.data_ptr(), v.data_ptr(), key.data_ptr(), lab.data_ptr(),
        row_cnt.data_ptr(), n_seeds.data_ptr(), h, w, NEVER_FILL << d_bits,
        _ext.stream_ptr(img),
    )
    _ext.check(err, "rwt_pack")
    _ext.launches["pack"] += 1
    return v, key, lab, n_seeds


def pack_domain_fused(img, device, *, d_bits: int = _D_BITS):
    """``(v, key, lab, n_seeds)`` for an image whose seeds come from the
    image itself — the counterpart of ``pallas_pack.pack_domain_fused``.

    ``img`` (numpy or tensor, any integer dtype holding 0..255) is moved to
    ``device`` as uint8.  A CUDA image runs the pack kernel, a CPU image its
    plain twin; nothing falls back from one to the other.
    """
    dev = _ext.resolve_device(device)
    img = torch.as_tensor(img).to(device=dev, dtype=torch.uint8).contiguous()
    if dev.type == "cuda":
        return pack_kernel(img, d_bits=d_bits)
    return pack_plain(img, d_bits=d_bits)
