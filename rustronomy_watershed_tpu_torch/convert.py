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
    and its seed, the checkpoint settings, every backend and the mesh
    (``mesh_from_jax``) included); raises NotImplementedError for a sweep
    function, which the JAX builder holds as a JAX function."""
    from .builder import TransformBuilder

    if tb.sweep_fn is not None:
        raise NotImplementedError(
            "the JAX builder's set_sweep_impl holds a JAX sweep function, which "
            "cannot run on torch tensors; give the port builder a torch sweep "
            "(set_sweep_impl, e.g. ops.flood_block.make_sweep_fn())"
        )
    out = TransformBuilder().set_max_water_lvl(tb.max_water_level).set_device(device)
    if tb.mesh is not None:
        out.set_mesh(mesh_from_jax(tb.mesh, device))
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


def mesh_from_jax(jax_mesh, device="cuda"):
    """A torch.distributed DeviceMesh of a JAX ``Mesh``'s shape and axis
    names over the initialised world, read from its ``axis_names`` and
    ``devices.shape`` alone (no JAX import): ``init_device_mesh`` with the
    device type of ``device`` (``"cuda"``: NCCL; ``"cpu"``: gloo).  Raises
    ValueError when no process group is initialised or when the world's
    size differs from the mesh's, or for an object that is no mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not hasattr(jax_mesh, "axis_names") or not hasattr(getattr(jax_mesh, "devices", None), "shape"):
        raise ValueError(f"a JAX Mesh (axis_names, devices) is needed, got {type(jax_mesh).__name__}")
    names = tuple(str(n) for n in jax_mesh.axis_names)
    shape = tuple(int(n) for n in jax_mesh.devices.shape)
    size = int(np.prod(shape))
    world = dist.get_world_size() if dist.is_initialized() else None
    if world != size:
        have = "no process group is initialised" if world is None else f"the world has {world} ranks"
        raise ValueError(f"the JAX mesh {dict(zip(names, shape))} has {size} devices, but {have}")
    return init_device_mesh(torch.device(device).type, shape, mesh_dim_names=names)
