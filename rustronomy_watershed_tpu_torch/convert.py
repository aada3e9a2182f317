"""Carry relax state between the JAX package and the port.

The system has no weights: its carried state is the packed relax planes and
the builder configuration.  The JAX relax kernels hold the planes padded
(``(h2 + 2p, wp)``, real data at rows ``[p, p + h)`` and columns
``[col_off, col_off + w)``, v biased to int8 as ``value - 128``, aprons
NEVER_FILL / unclaimed / 0); the port holds them as ``(h, w)`` tensors with
v as uint8.  Arrays cross as numpy; nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .constants import _UNCLAIMED, NEVER_FILL


def planes_from_jax(v_pad, key_pad, lab_pad, p: int, col_off: int, h: int, w: int, *, device):
    """Port ``(v, key, lab)`` tensors on ``device`` from the padded JAX
    planes.  The merging path's state is the JAX fixed point's ``lab_pad``
    (``relax_packed_planes(fwd_scan="stats")``), read at ``(p, col_off)``
    like any plane here."""
    rows, cols = slice(p, p + h), slice(col_off, col_off + w)
    v = (np.asarray(v_pad)[rows, cols].astype(np.int32) + 128).astype(np.uint8)
    key = np.asarray(key_pad)[rows, cols].astype(np.int32)
    lab = np.asarray(lab_pad)[rows, cols].astype(np.int32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (v, key, lab))


def planes_to_jax_layout(v, key, lab, tile: int, steps: int, *, unclaimed: int = _UNCLAIMED):
    """Inverse of planes_from_jax for the JAX 1-D band layout at
    ``(tile, steps)``: numpy ``(v_pad int8, key_pad, lab_pad)`` with real data
    at ``(steps, steps)``."""
    v, key, lab = (np.asarray(t.cpu()) for t in (v, key, lab))
    h, w = key.shape
    p = steps
    shape = (-(-h // tile) * tile + 2 * p, -(-(w + 2 * p) // 128) * 128)
    v_pad = np.full(shape, NEVER_FILL - 128, np.int8)
    key_pad = np.full(shape, unclaimed, np.int32)
    lab_pad = np.zeros(shape, np.int32)
    v_pad[p : p + h, p : p + w] = (v.astype(np.int32) - 128).astype(np.int8)
    key_pad[p : p + h, p : p + w] = key
    lab_pad[p : p + h, p : p + w] = lab
    return v_pad, key_pad, lab_pad


def builder_from_jax(tb, device="cuda"):
    """Port TransformBuilder with the JAX builder's options (the tie-break
    and its seed, the checkpoint settings and every backend included);
    raises NotImplementedError for a mesh, whose translation from a JAX
    ``Mesh`` into a torch.distributed DeviceMesh is not ported yet, and for
    a sweep function, which the JAX builder holds as a JAX function."""
    from .builder import TransformBuilder
    from .models.base import _not_yet

    if tb.mesh is not None:
        raise _not_yet("translating a JAX Mesh into a DeviceMesh (builder_from_jax)", "13 (b)")
    if tb.sweep_fn is not None:
        raise NotImplementedError(
            "the JAX builder's set_sweep_impl holds a JAX sweep function, which "
            "cannot run on torch tensors; give the port builder a torch sweep "
            "(set_sweep_impl, e.g. ops.flood_block.make_sweep_fn())"
        )
    out = TransformBuilder().set_max_water_lvl(tb.max_water_level).set_device(device)
    if tb.edge_correction:
        out.enable_edge_correction()
    # Copy the remaining options verbatim so build_* reports any that the
    # port does not serve.
    for name in (
        "wlvl_hook", "plot_path", "plot_colour_map", "progress", "debug",
        "backend", "checkpoint_dir", "checkpoint_every",
        "tie_break", "tie_break_seed",
    ):
        setattr(out, name, getattr(tb, name))
    out._validate()
    return out
