"""Halo exchange over a ``torch.distributed`` device mesh.

Counterpart of ``rustronomy_watershed_tpu.parallel.halo``.  The JAX package
tiles the image over a 2-D ``jax.sharding.Mesh`` and shifts k-px strips
between neighbour devices with ``lax.ppermute``; here the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with dims ``"y"`` and ``"x"``,
one process per rank, and the strips move by point-to-point
``batch_isend_irecv`` on the mesh's ``"y"`` and ``"x"`` process groups.
A leading ``"batch"`` dim makes each batch index a ``(y, x)`` sub-mesh of
its own: the strips and reductions stay inside it.

One Jacobi sweep moves information one 4-connected pixel, so a k-px halo
lets a rank run k local sweeps per exchange (parallel/tiled.py).  Corners
ride along by exchanging rows first, then columns of the row-extended tile.

Gloo sends no CUDA tensors.  Where a group's backend is gloo and a strip
lies on the card, it is staged through host memory: copied to a host tensor
before the send, received into a host tensor and copied back.  The choice is
made from ``dist.get_backend(group)`` before any call, never by catching a
failed one.  NCCL takes the CUDA tensors as they are.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# Tags of the two directions of a shift (gloo matches a receive by source
# and tag; NCCL ignores tags).
_TO_NEXT, _TO_PREV = 1, 2


MESH_DIMS = (("y", "x"), ("batch", "y", "x"))


def mesh_layout(mesh) -> tuple[int, int, int, int]:
    """``(ny, nx, iy, ix)``: the mesh's extent along ``"y"`` and ``"x"`` and
    this rank's coordinates.  Takes the dims ``("y", "x")`` or ``("batch",
    "y", "x")`` (each batch index a ``(y, x)`` sub-mesh of its own); refuses
    other dims and a rank outside the mesh."""
    names = tuple(mesh.mesh_dim_names or ())
    if names not in MESH_DIMS:
        raise ValueError(f"the mesh needs the dims ('y', 'x') or ('batch', 'y', 'x'), got {names}")
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    ny, nx = mesh.mesh.shape[-2:]
    return int(ny), int(nx), int(coord[-2]), int(coord[-1])


def mesh_line(mesh, dim: str) -> tuple[list[int], int]:
    """``(ranks, i)``: the global ranks of the mesh line through this rank
    along ``dim``, in coordinate order, and this rank's index on it."""
    coord = list(mesh.get_coordinate())
    d = list(mesh.mesh_dim_names).index(dim)
    index = tuple(slice(None) if j == d else c for j, c in enumerate(coord))
    return [int(r) for r in mesh.mesh[index].reshape(-1)], int(coord[d])


def staged(group, t: torch.Tensor) -> bool:
    """Whether ``t`` goes through host memory on ``group``: gloo sends no
    CUDA tensors."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _neighbours(mesh, dim: str) -> tuple:
    """Global ranks of the predecessor and successor along ``dim`` (None
    off the grid)."""
    line, i = mesh_line(mesh, dim)
    prev = line[i - 1] if i > 0 else None
    nxt = line[i + 1] if i + 1 < len(line) else None
    return prev, nxt


def _swap(mesh, dim: str, to_prev: torch.Tensor, to_next: torch.Tensor, fill):
    """Send ``to_prev`` to the predecessor along ``dim`` and ``to_next`` to
    the successor; return ``(from_prev, from_next)``: the predecessor's
    ``to_next`` and the successor's ``to_prev``, or ``fill`` where there is
    no neighbour.  The two strips have one shape on every rank."""
    group = mesh.get_group(dim)
    prev, nxt = _neighbours(mesh, dim)
    host = staged(group, to_prev)
    wire = torch.device("cpu") if host else to_prev.device

    def out(t):
        return t.to(wire).contiguous() if host else t.contiguous()

    from_prev = torch.full_like(to_next, fill)
    from_next = torch.full_like(to_prev, fill)
    ops, recvs = [], []
    if prev is not None:
        buf = torch.empty(to_next.shape, dtype=to_next.dtype, device=wire)
        ops += [dist.P2POp(dist.isend, out(to_prev), prev, group, _TO_PREV),
                dist.P2POp(dist.irecv, buf, prev, group, _TO_NEXT)]
        recvs.append((from_prev, buf))
    if nxt is not None:
        buf = torch.empty(to_prev.shape, dtype=to_prev.dtype, device=wire)
        ops += [dist.P2POp(dist.isend, out(to_next), nxt, group, _TO_NEXT),
                dist.P2POp(dist.irecv, buf, nxt, group, _TO_PREV)]
        recvs.append((from_next, buf))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for dst, buf in recvs:
        dst.copy_(buf)
    return from_prev, from_next


def exchange_halo(tile: torch.Tensor, k: int, mesh, off_grid_fill=0) -> torch.Tensor:
    """Pad a local ``(..., h, w)`` tile to ``(..., h + 2k, w + 2k)`` with the
    neighbours' data; halo cells beyond the mesh's edge get
    ``off_grid_fill`` (0 for labels, NEVER_FILL for values).  Rows first,
    then columns of the row-extended tile, so the corners come along.
    Needs ``k <= min(h, w)``."""
    up, down = _swap(mesh, "y", tile[..., :k, :], tile[..., -k:, :], off_grid_fill)
    ext = torch.cat([up, tile, down], dim=-2)
    left, right = _swap(mesh, "x", ext[..., :, :k], ext[..., :, -k:], off_grid_fill)
    return torch.cat([left, ext, right], dim=-1)


def refresh_halo_padded(plane: torch.Tensor, k: int, h: int, w: int, mesh, off_grid_fill=0,
                        return_strips: bool = False):
    """Rewrite, in place, the k-px halo band of a ``(..., h + 2k, wp >= w +
    2k)`` plane whose tile sits at rows ``[k, k + h)`` and columns ``[k, k +
    w)``; returns the plane, and with ``return_strips=True`` also the four
    incoming strips ``(up, down, left, right)``.

    The strips come from the neighbours' centre data only, never from their
    halo, which the sweeps corrupt between refreshes.  Rows first (centre
    columns), then columns over the full height, so the freshly received
    row halos carry the diagonal neighbours' corners.  Off-grid halos get
    ``off_grid_fill`` on every call, which also clears what the sweeps left
    there.  A round loop compares the strips with the previous round's to
    tell whether its halo changed (parallel/tiled.py)."""
    up, down = _swap(mesh, "y", plane[..., k : 2 * k, k : k + w], plane[..., h : h + k, k : k + w], off_grid_fill)
    plane[..., :k, k : k + w] = up
    plane[..., k + h : 2 * k + h, k : k + w] = down
    left, right = _swap(mesh, "x", plane[..., :, k : 2 * k], plane[..., :, w : w + k], off_grid_fill)
    plane[..., :, :k] = left
    plane[..., :, k + w : 2 * k + w] = right
    if return_strips:
        return plane, (up, down, left, right)
    return plane


def global_interior_mask(local_shape, global_shape, halo: int, mesh, device=None) -> torch.Tensor:
    """The interior (the global 1-px border excluded) in halo-padded local
    coordinates: padded cell ``(ly, lx)`` is global ``(iy * h + ly - halo,
    ix * w + lx - halo)``.  Bool ``(h + 2 halo, w + 2 halo)`` on
    ``device``."""
    h, w = local_shape
    gh, gw = global_shape
    _, _, iy, ix = mesh_layout(mesh)
    gy = torch.arange(h + 2 * halo, device=device) + iy * h - halo
    gx = torch.arange(w + 2 * halo, device=device) + ix * w - halo
    return ((gy >= 1) & (gy <= gh - 2))[:, None] & ((gx >= 1) & (gx <= gw - 2))[None, :]
