"""The public builder API: configure, then build a transform.

Counterpart of ``rustronomy_watershed_tpu.builder`` (the reference's
``TransformBuilder``, src/lib.rs:864-1065): the same
chainable setters and ``BuildErr`` validation, plus ``set_device``.
"""

from __future__ import annotations

from .constants import ALWAYS_FILL, NORMAL_MAX
from .models.merging import MergingWatershed
from .models.segmenting import SegmentingWatershed
from .parallel.halo import MESH_DIMS



class BuildErr(Exception):
    """Configuration error raised by build_* (src/lib.rs:1049-1065)."""

    MAX_TOO_HIGH = "MaxToHigh"
    MAX_TOO_LOW = "MaxToLow"

    def __init__(self, kind: str, max_water_level: int):
        self.kind = kind
        self.max_water_level = max_water_level
        if kind == self.MAX_TOO_HIGH:
            msg = (
                f"Maximum water level set to {max_water_level}, which is higher "
                f"than the maximum allowed value {NORMAL_MAX}"
            )
        else:
            msg = (
                f"Maximum water level set to {max_water_level}, which is lower "
                f"than the minimum allowed value {ALWAYS_FILL + 1}"
            )
        super().__init__(msg)


class TransformBuilder:
    """Chainable configuration for a watershed transform."""

    def __init__(self):
        self.max_water_level = NORMAL_MAX
        self.edge_correction = False
        self.wlvl_hook = None
        self.plot_path = None
        self.plot_colour_map = None
        self.progress = False
        self.debug = False
        self.sweep_fn = None
        self.backend = "auto"
        self.mesh = None
        self.checkpoint_dir = None
        self.checkpoint_every = 16
        self.tie_break = "min"
        self.tie_break_seed = 0
        self.device = "cuda"

    @classmethod
    def new(cls) -> "TransformBuilder":
        return cls()

    @classmethod
    def default(cls) -> "TransformBuilder":
        return cls()

    def set_max_water_lvl(self, max_water_lvl: int) -> "TransformBuilder":
        self.max_water_level = int(max_water_lvl)
        return self

    def enable_edge_correction(self) -> "TransformBuilder":
        self.edge_correction = True
        return self

    def set_device(self, device) -> "TransformBuilder":
        """Where the transform runs: ``"cuda"`` (default; the CUDA kernels)
        or ``"cpu"`` (their plain PyTorch twins).  Nothing picks the CPU by
        itself: a CUDA device on a host without CUDA raises."""
        self.device = device
        return self

    def set_wlvl_hook(self, hook) -> "TransformBuilder":
        self.wlvl_hook = hook
        return self

    def set_plot_colour_map(self, colour_map) -> "TransformBuilder":
        self.plot_colour_map = colour_map
        return self

    def set_plot_folder(self, path) -> "TransformBuilder":
        self.plot_path = path
        return self

    def enable_progress(self) -> "TransformBuilder":
        self.progress = True
        return self

    def enable_debug(self) -> "TransformBuilder":
        self.debug = True
        return self

    def set_sweep_impl(self, sweep_fn) -> "TransformBuilder":
        """Advanced: replace the flood sweep of the level sweep and the
        host-stepped loop with ``sweep_fn(img, labels, lvl)`` on torch
        tensors; it must equal >= 1 ``ops.flood.flood_sweep``s (e.g.
        ``ops.flood_block.make_sweep_fn()``)."""
        self.sweep_fn = sweep_fn
        return self

    def set_backend(self, backend: str) -> "TransformBuilder":
        """'auto' (the packed relaxation engine: CUDA kernels on the card),
        'relax' (the exact plain engine), 'pallas' (the level sweep on the
        flood kernel), 'jnp' (the level sweep on plain flood sweeps) or
        'native' (the C++ engine on the host for transform and
        transform_to_list, the plain level sweep elsewhere); all give the
        same labels.  'relax_pallas' is accepted here and refused at build
        time."""
        if backend not in ("auto", "relax", "relax_pallas", "pallas", "jnp", "native"):
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        return self

    def set_tie_break(self, mode: str, seed: int = 0) -> "TransformBuilder":
        """Plateau tie-break when a floodable pixel has differently coloured
        4-neighbours: ``'min'`` (default; the least label wins, every
        engine) or ``'random'``: a uniformly random coloured 4-neighbour
        position wins, the reference's rule (src/lib.rs:249-253), drawn
        from ``seed`` so that a seed gives the same labels on every device.
        Runs on the plain level sweep; excludes ``set_sweep_impl`` and every
        backend but 'auto' and 'jnp'."""
        if mode not in ("min", "random"):
            raise ValueError(f"unknown tie-break mode {mode!r}")
        self.tie_break = mode
        self.tie_break_seed = int(seed)
        return self

    def set_checkpoint(self, directory, every: int = 16) -> "TransformBuilder":
        """Snapshot the transform into ``directory`` and resume from the
        newest snapshot of the same image, seeds and settings: alone on
        the packed engine, its relax planes every ``every`` relax calls;
        otherwise the host loop's labels every ``every`` water levels
        (utils/checkpoint.py)."""
        self.checkpoint_dir = directory
        self.checkpoint_every = every
        return self

    def set_mesh(self, mesh) -> "TransformBuilder":
        """Tile every method over a ``torch.distributed`` DeviceMesh with the
        dims ``("y", "x")`` or ``("batch", "y", "x")`` (parallel/tiled.py).

        SPMD: JAX runs one controller over every device, torch.distributed
        one process per rank.  So every rank builds the same builder and
        calls the same method with the full image; each rank pads and
        slices its own tile (row-major rank order over the mesh) and
        computes it on ``set_device``'s device, exchanging halos with its
        neighbour ranks; every rank gets the full result back.  The results
        equal the single-device results on every rank, and no rank is a
        driver.  The mesh supplies the ranks and the process groups (gloo or
        NCCL; gloo strips of tiles on the card go through host memory); the
        builder's device says where the tiles compute.

        What a mesh serves, as in the JAX package:

        - ``transform``: the tiled packed relax engine (and the mesh merge);
        - ``transform_to_list``, ``transform_history`` and pure observers
          (hooks, plots): one tiled relax pass's claim planes, rebuilt on
          the host as on one device;
        - hooks, plots, progress, debug and ``set_checkpoint``: the
          host-stepped level loop on ``MeshLevelStepper`` (the flood kernel
          and the mesh merge a level); a progress tick and a debug loop per
          halo-exchange round, debug timing whole levels; per-level
          snapshots of the cropped domain;
        - ``transform_batch`` over a ``"batch"`` dim: the images split over
          its batch groups (B divisible by its size), each a ``(y, x)``
          sub-mesh; without one, ``transform_batch`` ignores the mesh.

        The SPMD rules of the host loop: hooks run on every rank with the
        same views, and every rank returns their results; plots, snapshot
        files, the progress bar and debug prints come from mesh rank 0
        (every coordinate 0) alone; every rank reads a resume, and after
        each save every rank waits until it is on disk.

        The mesh runs its own engines whatever the backend and sweep
        function; ``backend('native')`` ignores the mesh for ``transform``
        and ``transform_to_list``.  The random tie-break is single-device
        (ValueError)."""
        self.mesh = mesh
        return self

    def _validate(self):
        if self.max_water_level > NORMAL_MAX:
            raise BuildErr(BuildErr.MAX_TOO_HIGH, self.max_water_level)
        if self.max_water_level <= ALWAYS_FILL:
            raise BuildErr(BuildErr.MAX_TOO_LOW, self.max_water_level)
        if self.tie_break == "random":
            if self.sweep_fn is not None:
                raise ValueError(
                    "set_tie_break('random') replaces the flood sweep and is "
                    "mutually exclusive with set_sweep_impl"
                )
            if self.backend not in ("auto", "jnp"):
                raise ValueError(
                    "set_tie_break('random') runs on the plain level sweep; "
                    f"backend {self.backend!r} is min-label only"
                )
            if self.mesh is not None:
                raise ValueError("set_tie_break('random') is single-device")
        if self.mesh is not None:
            names = tuple(getattr(self.mesh, "mesh_dim_names", None) or ())
            if names not in MESH_DIMS:
                raise ValueError(f"set_mesh takes a torch.distributed DeviceMesh with the dims {MESH_DIMS}, got {names}")
        if self.backend == "relax_pallas":
            raise NotImplementedError(
                "backend 'relax_pallas' is the packed engine, which the port "
                "serves as backend 'auto'"
            )

    def _kwargs(self):
        return dict(
            max_water_level=self.max_water_level,
            edge_correction=self.edge_correction,
            wlvl_hook=self.wlvl_hook,
            plot_path=self.plot_path,
            plot_colour_map=self.plot_colour_map,
            progress=self.progress,
            debug=self.debug,
            sweep_fn=self.sweep_fn,
            backend=self.backend,
            device=self.device,
            checkpoint_dir=self.checkpoint_dir,
            checkpoint_every=self.checkpoint_every,
            tie_break=self.tie_break,
            tie_break_seed=self.tie_break_seed,
            mesh=self.mesh,
        )

    def build_merging(self) -> MergingWatershed:
        self._validate()
        return MergingWatershed(**self._kwargs())

    def build_segmenting(self) -> SegmentingWatershed:
        self._validate()
        return SegmentingWatershed(**self._kwargs())
