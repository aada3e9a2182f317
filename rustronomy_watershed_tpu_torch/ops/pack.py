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

import functools
import types

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


# The pack kernel's launch plan, computed here so that the CPU tests can
# check it; csrc/pack.cu launches it as given and refuses a plan that does
# not cover the image.
_GROUP = 16  # columns a band-kernel thread owns (one 16-byte load)
_BAND_THREADS = 1024  # kMaxBandThreads: rows of up to 16384 pixels take the band kernel
_BAND_ROWS = 8  # kBandRows: rows a band
_ROWS_THREADS = 256  # threads a block of the wide route


@functools.lru_cache(maxsize=256)
def pack_plan(h: int, w: int, aligned: bool = True) -> dict:
    """The pack launch.  ``route`` ``"vec"`` (the band kernel with 16-byte
    access: w % 16 == 0 and the planes 16-byte aligned) or ``"bytes"`` (the
    same kernel with byte access), for rows of at most ``_BAND_THREADS *
    _GROUP`` pixels: ``threads`` (a thread per 16 columns, whole warps),
    ``band_rows`` rows a band, ``n_bands`` blocks, and ``status_words``
    uint64 of look-back status (a ticket, one word per band).  Wider rows
    take ``"rows"``: the three-launch route, ``n_bands`` = h blocks of
    ``threads``, one per row, ``status_words`` holding h int32 row counts.
    Cached, so read-only."""
    groups = -(-w // _GROUP)
    threads = 32 * -(-groups // 32)
    if threads > _BAND_THREADS:
        return types.MappingProxyType({"route": "rows", "threads": _ROWS_THREADS, "band_rows": 1, "n_bands": h,
                                       "status_words": -(-h // 2)})
    n_bands = -(-h // _BAND_ROWS)
    return types.MappingProxyType({
        "route": "vec" if w % _GROUP == 0 and aligned else "bytes", "threads": threads, "band_rows": _BAND_ROWS,
        "n_bands": n_bands, "status_words": 1 + n_bands,
    })


_ROUTE_CODE = {"vec": 0, "bytes": 1, "rows": 2}


def pack_kernel(img: torch.Tensor, *, d_bits: int = _D_BITS):
    """Launch csrc/pack.cu on a CUDA uint8 image; same outputs as
    pack_plain.  The route ``pack_plan`` picks is counted as ``pack_vec``,
    ``pack_bytes`` or ``pack_rows``."""
    if img.dtype != torch.uint8 or img.dim() != 2 or not img.is_contiguous() or not img.is_cuda:
        raise ValueError("pack kernel takes a contiguous 2-D uint8 CUDA image")
    h, w = img.shape
    v = torch.empty_like(img)
    key = torch.empty((h, w), dtype=torch.int32, device=img.device)
    lab = torch.empty_like(key)
    n_seeds = torch.empty((), dtype=torch.int32, device=img.device)
    aligned = all(t.data_ptr() % 16 == 0 for t in (img, v, key, lab))
    plan = pack_plan(h, w, aligned)
    status = torch.empty((plan["status_words"],), dtype=torch.int64, device=img.device)
    err = _ext.lib().rwt_pack(
        img.data_ptr(), v.data_ptr(), key.data_ptr(), lab.data_ptr(),
        status.data_ptr(), n_seeds.data_ptr(), h, w, NEVER_FILL << d_bits,
        _ROUTE_CODE[plan["route"]], plan["band_rows"], plan["threads"], plan["n_bands"], _ext.stream_ptr(img),
    )
    _ext.check(err, "rwt_pack")
    _ext.launches["pack"] += 1
    _ext.launches[f"pack_{plan['route']}"] += 1
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
