"""The level-sweep engine's flood kernel: ``steps`` fused Jacobi flood
sweeps per call, and the per-level fixed point.

Counterpart of ``rustronomy_watershed_tpu.ops.pallas_flood`` (backend
``'pallas'`` of the JAX package, ``'flood'`` inside the port).  Layers:
``flood_block`` (one call = exactly ``steps`` global sweeps of
ops/flood.py's update, csrc/flood.cu on CUDA planes, ``flood_block_plain``
on CPU planes) -> ``flood_fixed_point_block`` (host loop until a call's last
sweep changed nothing) -> ops/level_driver.py.

The planes carry no aprons: the kernel reads cells outside the image as
uncoloured and never floodable, and takes the image with its border ring
forced to NEVER_FILL (``flood_image``, the ring ``pad_domain`` writes at
pallas_flood.py:77-80), so border pixels are never painted but still donate.

A call's flags are one int32 tensor ``[painted, not_converged]``: some cell
of the output differs from the input (it gates the merge phase), and the
last sweep changed some cell (when 0, the level's fixed point is certified:
pallas_flood.py:34-40).
"""

from __future__ import annotations

import torch

from .. import _ext
from ..constants import NEVER_FILL
from .flood import flood_sweep

DEFAULT_STEPS = 8
PAINTED, NOT_CONVERGED = 0, 1  # indices into a call's flags tensor

# Shared memory one block may take (H100: 227 KB) and what a window cell
# costs there: two int32 labels (Jacobi ping-pong) and the floodable byte.
_SMEM_BYTES = 232448
_CELL_BYTES = 9
_TILES = (64, 32, 16, 8)


def kernel_tile(steps: int) -> int:
    """Centre tile edge for the CUDA kernel: the largest of _TILES whose
    (tile + 2*steps)^2 window fits one block's shared memory."""
    for t in _TILES:
        if (t + 2 * steps) ** 2 * _CELL_BYTES <= _SMEM_BYTES:
            return t
    raise ValueError(f"steps={steps} too large for a shared-memory window")


def flood_image(img):
    """The u8 image with its 1-px border ring at NEVER_FILL: the kernel's
    image plane (the reference never paints border pixels, src/lib.rs:
    220-233)."""
    v = img.to(torch.uint8).clone()
    v[0, :] = NEVER_FILL
    v[-1, :] = NEVER_FILL
    v[:, 0] = NEVER_FILL
    v[:, -1] = NEVER_FILL
    return v.contiguous()


def flood_block_plain(img, lab, lvl: int, steps: int, *, out=None):
    """Plain PyTorch twin of the flood kernel: ``steps`` flood sweeps with
    no interior mask (the image's border ring does its work) plus the two
    flags.  Returns ``(lab', flags)``."""
    _ext.launches["flood_plain"] += 1
    new, last = lab, torch.zeros((), dtype=torch.bool, device=lab.device)
    for _ in range(steps):
        nxt = flood_sweep(img, new, lvl, mask=True)
        last = (nxt != new).any()
        new = nxt
    flags = torch.stack([(new != lab).any(), last]).to(torch.int32)
    if out is not None:
        out.copy_(new)
        new = out
    return new, flags


def flood_block_kernel(img, lab, lvl: int, steps: int, *, out=None):
    """Launch csrc/flood.cu: ``steps`` flood sweeps of a CUDA label plane
    into ``out`` (a fresh plane when None; never the input plane)."""
    if img.dtype != torch.uint8 or lab.dtype != torch.int32:
        raise ValueError("flood kernel takes a uint8 image and an int32 label plane")
    if img.shape != lab.shape or lab.dim() != 2:
        raise ValueError("flood kernel planes must share one 2-D shape")
    out = torch.empty_like(lab) if out is None else out
    planes = (img, lab, out)
    if not lab.is_cuda or not all(t.is_contiguous() and t.device == lab.device for t in planes):
        raise ValueError("flood kernel planes must be contiguous on one CUDA device")
    if out.shape != lab.shape or out.dtype != lab.dtype:
        raise ValueError("flood kernel output plane must match the int32 label plane")
    if out.data_ptr() == lab.data_ptr():
        raise ValueError("flood kernel output plane must not alias its input")
    if steps < 1 or not 0 <= lvl <= 255:
        raise ValueError("flood kernel needs steps >= 1 and a level in 0..255")
    h, w = lab.shape
    flags = torch.empty((2,), dtype=torch.int32, device=lab.device)
    err = _ext.lib().rwt_flood(
        img.data_ptr(), lab.data_ptr(), out.data_ptr(), flags.data_ptr(), h, w,
        int(lvl), steps, kernel_tile(steps), _ext.stream_ptr(lab),
    )
    _ext.check(err, "rwt_flood")
    _ext.launches["flood"] += 1
    return out, flags


def flood_block(img, lab, lvl: int, steps: int = DEFAULT_STEPS, *, out=None):
    """One call = exactly ``steps`` global flood sweeps at level ``lvl`` of
    ``lab`` over ``img`` (a ``flood_image``).  CUDA planes launch the
    kernel, CPU planes run the plain twin.  Returns ``(lab', flags)`` with
    flags ``[painted, not_converged]``."""
    if lab.device.type == "cuda":
        return flood_block_kernel(img, lab, lvl, steps, out=out)
    if lab.device.type == "cpu":
        return flood_block_plain(img, lab, lvl, steps, out=out)
    raise ValueError(f"unsupported device {lab.device}")


def flood_fixed_point_block(img, lab, lvl: int, *, steps: int = DEFAULT_STEPS, scratch=None):
    """Iterate flood_block at level ``lvl`` until a call's last sweep
    changed nothing (at least one call, like the reference's do-while).

    ``lab`` and ``scratch`` (a plane like ``lab``; allocated when None) are
    the two ping-pong buffers and are overwritten.  Returns ``(lab,
    scratch, painted)``: the fixed point, the other buffer, and whether the
    level painted a pixel.  The host reads one flag pair per call."""
    src, dst = lab, torch.empty_like(lab) if scratch is None else scratch
    painted = False
    while True:
        new, flags = flood_block(img, src, lvl, steps, out=dst)
        f = flags.tolist()
        src, dst = new, src
        painted |= bool(f[PAINTED])
        if not f[NOT_CONVERGED]:
            return src, dst, painted


def make_sweep_fn(steps: int = DEFAULT_STEPS):
    """A ``sweep_fn(img, labels, lvl)`` for ``set_sweep_impl`` and the
    unpadded drivers: ``steps`` sweeps in one flood_block call, which
    equals ``flood_sweep`` iterated ``steps`` times."""

    def sweep(img, labels, lvl):
        lab = labels.to(torch.int32).contiguous()
        return flood_block(flood_image(img), lab, int(lvl), steps)[0]

    return sweep
