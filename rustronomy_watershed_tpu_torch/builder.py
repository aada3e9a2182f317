"""The public builder API: configure, then build a transform.

Counterpart of ``rustronomy_watershed_tpu.builder`` (the reference's
``TransformBuilder``, src/lib.rs:864-1065): the same
chainable setters and ``BuildErr`` validation, plus ``set_device``.  Options
this slice does not serve are accepted by their setters and refused by
``build_*`` with NotImplementedError naming the ROADMAP item that brings
them.
"""

from __future__ import annotations

from .constants import ALWAYS_FILL, NORMAL_MAX
from .models.base import _BACKENDS, _not_yet
from .models.merging import MergingWatershed
from .models.segmenting import SegmentingWatershed

# Backend -> ROADMAP queue 1 item that ports its engine.
_BACKEND_ITEMS = {"pallas": 11, "jnp": 11, "native": 8}


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
        self.sweep_fn = sweep_fn
        return self

    def set_backend(self, backend: str) -> "TransformBuilder":
        """'auto' (the packed engine: CUDA kernels on the card) or 'relax'
        (the exact plain engine).  The JAX package's other names are
        accepted here and refused at build time."""
        if backend not in ("auto", "relax", "relax_pallas", "pallas", "jnp", "native"):
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        return self

    def set_tie_break(self, mode: str, seed: int = 0) -> "TransformBuilder":
        if mode not in ("min", "random"):
            raise ValueError(f"unknown tie-break mode {mode!r}")
        self.tie_break = mode
        self.tie_break_seed = int(seed)
        return self

    def set_checkpoint(self, directory, every: int = 16) -> "TransformBuilder":
        self.checkpoint_dir = directory
        self.checkpoint_every = every
        return self

    def set_mesh(self, mesh) -> "TransformBuilder":
        self.mesh = mesh
        return self

    def _validate(self):
        if self.max_water_level > NORMAL_MAX:
            raise BuildErr(BuildErr.MAX_TOO_HIGH, self.max_water_level)
        if self.max_water_level <= ALWAYS_FILL:
            raise BuildErr(BuildErr.MAX_TOO_LOW, self.max_water_level)
        if self.wlvl_hook is not None:
            raise _not_yet("set_wlvl_hook", 11)
        if self.plot_path is not None:
            raise _not_yet("set_plot_folder", 11)
        if self.progress:
            raise _not_yet("enable_progress", 11)
        if self.debug:
            raise _not_yet("enable_debug", 11)
        if self.sweep_fn is not None:
            raise _not_yet("set_sweep_impl", 11)
        if self.tie_break != "min":
            raise _not_yet("set_tie_break('random')", 11)
        if self.checkpoint_dir is not None:
            raise _not_yet("set_checkpoint", 12)
        if self.mesh is not None:
            raise _not_yet("set_mesh", 13)
        if self.backend == "relax_pallas":
            raise NotImplementedError(
                "backend 'relax_pallas' is the packed engine, which the port "
                "serves as backend 'auto'"
            )
        if self.backend not in _BACKENDS:
            raise _not_yet(f"backend {self.backend!r}", _BACKEND_ITEMS[self.backend])

    def _kwargs(self):
        return dict(
            max_water_level=self.max_water_level,
            edge_correction=self.edge_correction,
            backend=self.backend,
            device=self.device,
        )

    def build_merging(self) -> MergingWatershed:
        self._validate()
        return MergingWatershed(**self._kwargs())

    def build_segmenting(self) -> SegmentingWatershed:
        self._validate()
        return SegmentingWatershed(**self._kwargs())
