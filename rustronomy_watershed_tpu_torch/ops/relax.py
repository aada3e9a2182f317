"""Packed-key priority relaxation: the segmenting transform on the card.

Counterpart of ``rustronomy_watershed_tpu.ops.pallas_relax`` (1-D band path,
segmenting branch).  The lexicographic claim key ``(L, d)`` of ops/priority.py
packs into one int32, ``key = L << d_bits | d`` (constants.py), which makes
one Jacobi sweep branch-free:

    best  = min(key, max(ext(min4 kq), vcand))
    ext(a) = min(a + 1, a | d_mask)            # saturating ring increment
    vcand = min((v << d_bits) + 1, unclaimed)  # restart at this pixel's level
    label = min label of 4-neighbours with kq < best, kept when none exists
            or when best is still unclaimed (the claimed-ness gate)

Seeds (key 0) never change, unclaimed neighbours never donate, and no
arithmetic exceeds ``unclaimed + 1 < 2**31`` (pallas_relax.py:352-368).  The
fixed point is unique, so the schedule here may differ from the TPU's while
the labels may not.

Layers: ``relax_block`` (one call = exactly ``steps`` global Jacobi sweeps,
csrc/relax.cu on CUDA tensors, ``relax_block_plain`` on CPU tensors) ->
``relax_fixed_point`` (host loop until a call's last sweep changed nothing)
-> ``relax_packed_planes`` / ``relax_transform_packed`` (pack + fixed point
+ the ``max_water_level`` mask).

A call's flags are one int32 tensor ``[changed_any, changed_last, sat]``:
any centre cell changed in any sweep / in the last sweep (the fixed-point
witness) / a claimed cell holds label 0 (the d-field saturation signature at
the fixed point, pallas_relax.py:474-498).
"""

from __future__ import annotations

import torch

from .. import _ext
from ..constants import _D_BITS, NEVER_FILL, UNCOLOURED
from .pack import pack_domain, pack_domain_fused
from .stencil import shift4

DEFAULT_STEPS = 8
ANY, LAST, SAT = 0, 1, 2  # indices into a call's flags tensor

_BIG_LAB = 2**30
# Shared memory one block may take (H100: 227 KB) and what a window cell
# costs there: key + label, double-buffered, int32, plus the u8 value.
_SMEM_BYTES = 232448
_CELL_BYTES = 17
_TILES = (64, 32, 16, 8)


def kernel_tile(steps: int) -> int:
    """Centre tile edge for the CUDA kernel: the largest of _TILES whose
    (tile + 2*steps)^2 window fits one block's shared memory."""
    for t in _TILES:
        if (t + 2 * steps) ** 2 * _CELL_BYTES <= _SMEM_BYTES:
            return t
    raise ValueError(f"steps={steps} too large for a shared-memory window")


def _key_consts(d_bits):
    """(d_bits, d_mask, unclaimed) — ``_D_BITS`` is read at call time so a
    test can narrow the d field with monkeypatch."""
    d_bits = _D_BITS if d_bits is None else int(d_bits)
    if not 1 <= d_bits <= 23:
        raise ValueError(f"d_bits must be in 1..23, got {d_bits}")
    return d_bits, (1 << d_bits) - 1, NEVER_FILL << d_bits


def relax_block_plain(v, key, lab, steps: int, d_bits=None, *, out=None):
    """Plain PyTorch twin of the relax kernel: ``steps`` Jacobi sweeps.
    Returns ``(key', lab', flags)``."""
    _ext.launches["relax_plain"] += 1
    d_bits, d_mask, unclaimed = _key_consts(d_bits)
    vcand = torch.clamp_max((v.to(torch.int32) << d_bits) + 1, unclaimed)
    any_c = last_c = torch.zeros((), dtype=torch.bool, device=key.device)
    for _ in range(steps):
        kq = shift4(key, unclaimed)
        lq = shift4(lab, 0)
        kmin = torch.minimum(torch.minimum(kq[0], kq[1]), torch.minimum(kq[2], kq[3]))
        ext = torch.minimum(kmin + 1, kmin | d_mask)
        best = torch.minimum(key, torch.maximum(ext, vcand))
        labmin = torch.full_like(lab, _BIG_LAB)
        for k, l in zip(kq, lq):
            labmin = torch.minimum(labmin, torch.where(k < best, l, _BIG_LAB))
        new_lab = torch.where((labmin == _BIG_LAB) | (best == unclaimed), lab, labmin)
        last_c = ((best != key) | (new_lab != lab)).any()
        any_c = any_c | last_c
        key, lab = best, new_lab
    sat = ((key < unclaimed) & (lab == 0)).any()
    flags = torch.stack([any_c, last_c, sat]).to(torch.int32)
    if out is not None:
        out[0].copy_(key)
        out[1].copy_(lab)
        key, lab = out
    return key, lab, flags


def relax_block_kernel(v, key, lab, steps: int, d_bits=None, *, out=None):
    """Launch csrc/relax.cu: ``steps`` Jacobi sweeps of CUDA planes into
    ``out`` (fresh planes when None; never the input planes)."""
    d_bits, _, _ = _key_consts(d_bits)
    h, w = key.shape
    if v.dtype != torch.uint8 or key.dtype != torch.int32 or lab.dtype != torch.int32:
        raise ValueError("relax kernel takes uint8 v and int32 key/lab planes")
    if v.shape != key.shape or lab.shape != key.shape or key.dim() != 2:
        raise ValueError("relax kernel planes must share one 2-D shape")
    key_out, lab_out = out if out is not None else (torch.empty_like(key), torch.empty_like(lab))
    planes = (v, key, lab, key_out, lab_out)
    if not key.is_cuda or not all(t.is_contiguous() and t.device == key.device for t in planes):
        raise ValueError("relax kernel planes must be contiguous on one CUDA device")
    if any(t.shape != key.shape or t.dtype != key.dtype for t in (key_out, lab_out)):
        raise ValueError("relax kernel output planes must match the int32 input planes")
    if {key_out.data_ptr(), lab_out.data_ptr()} & {key.data_ptr(), lab.data_ptr()}:
        raise ValueError("relax kernel output planes must not alias its inputs")
    if steps < 1:
        raise ValueError("steps must be >= 1")
    flags = torch.empty((3,), dtype=torch.int32, device=key.device)
    err = _ext.lib().rwt_relax(
        v.data_ptr(), key.data_ptr(), lab.data_ptr(), key_out.data_ptr(),
        lab_out.data_ptr(), flags.data_ptr(), h, w, steps, d_bits,
        kernel_tile(steps), _ext.stream_ptr(key),
    )
    _ext.check(err, "rwt_relax")
    _ext.launches["relax"] += 1
    return key_out, lab_out, flags


def relax_block(v, key, lab, steps: int, d_bits=None, *, out=None):
    """One call = exactly ``steps`` global Jacobi sweeps of the packed update.

    CUDA planes launch the kernel, CPU planes run the plain twin.  Returns
    ``(key', lab', flags)`` with flags ``[changed_any, changed_last, sat]``.
    """
    if key.device.type == "cuda":
        return relax_block_kernel(v, key, lab, steps, d_bits, out=out)
    if key.device.type == "cpu":
        return relax_block_plain(v, key, lab, steps, d_bits, out=out)
    raise ValueError(f"unsupported device {key.device}")


def relax_fixed_point(v, key, lab, *, steps: int = DEFAULT_STEPS, d_bits=None):
    """Iterate relax_block until a call's last sweep changed nothing.

    ``key``/``lab`` serve as one of the two ping-pong buffers and are
    overwritten.  Returns ``(key, lab, starved)``; ``starved`` is the
    certifying call's saturation flag.  The host reads one small flag tensor
    per call.
    """
    src = (key, lab)
    dst = (torch.empty_like(key), torch.empty_like(lab))
    while True:
        k2, l2, flags = relax_block(v, *src, steps, d_bits, out=dst)
        f = flags.tolist()
        src, dst = (k2, l2), src
        if not f[LAST]:
            return k2, l2, bool(f[SAT])


def relax_packed_planes(img, labels0, *, steps=None, d_bits=None, device="cuda"):
    """Pack (seeds from ``labels0``, or from the image when it is None) and
    relax to the fixed point.  Returns ``(key, lab, starved)`` as
    ``(h, w)`` planes on ``device``."""
    steps = DEFAULT_STEPS if steps is None else int(steps)
    d_bits, _, _ = _key_consts(d_bits)
    dev = _ext.resolve_device(device)
    if labels0 is None:
        v, key, lab, _ = pack_domain_fused(img, dev, d_bits=d_bits)
    else:
        img = torch.as_tensor(img).to(dev)
        v, key, lab = pack_domain(img, torch.as_tensor(labels0).to(dev), d_bits=d_bits)
    return relax_fixed_point(v, key, lab, steps=steps, d_bits=d_bits)


def relax_transform_packed(
    img, labels0, *, max_water_level: int = 254, steps=None, device="cuda"
):
    """Full segmenting transform on the packed engine — the counterpart of
    ``pallas_relax.relax_transform_pallas``.  Bit-identical labels to
    ops/priority.relax_transform unless ``starved``.

    Returns ``(labels, key, starved)``; ``key`` is the packed claim key plane
    (claim level ``key >> d_bits``; ``NEVER_FILL << d_bits`` where never
    claimed).
    ``labels0=None`` takes the seeds from the image through the pack kernel.
    """
    d_bits, _, _ = _key_consts(None)
    key, lab, starved = relax_packed_planes(
        img, labels0, steps=steps, d_bits=d_bits, device=device
    )
    if max_water_level >= 254:
        # The claimed-ness gate keeps unclaimed cells at label 0, so the
        # label plane already is the final label image.
        labels = lab
    else:
        # claim level <= max_water_level  <=>  key < (max_water_level + 1) << d_bits;
        # unclaimed keys (NEVER_FILL << d_bits) lie above every such bound.
        labels = torch.where(key < (max_water_level + 1) << d_bits, lab, UNCOLOURED)
    return labels, key, starved
