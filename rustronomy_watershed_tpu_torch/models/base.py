"""Shared driver logic for the segmenting / merging transforms.

Counterpart of ``rustronomy_watershed_tpu.models.base``: the reference's
``Watershed`` trait surface (reference src/lib.rs:1206-1238) and the
``WatershedUtils`` mixin (src/lib.rs:1069-1201).

Four engines (``ops/level_driver.py``), chosen by the builder's backend:
``'auto'`` the packed relaxation engine (the CUDA kernels on the card),
``'relax'`` the exact relaxation engine, ``'pallas'`` the level sweep on the
flood kernel and ``'jnp'`` the level sweep on plain ``flood_sweep``; and
``'native'``, the C++ engine (parity/native.py) for ``transform`` and
``transform_to_list``, the plain level sweep elsewhere.  Per level, the
relaxation engines serve ``transform_to_list``, ``transform_history`` and
pure observers (hook, plots) from their compact planes (ops/merge_curve.py);
progress, debug, a custom sweep, the random tie-break and per-level
checkpoints step the levels from the host, as the reference does.  The
random tie-break (``set_tie_break('random', seed)``) runs the plain level
sweep with ``flood_sweep_random`` on a uniform plane drawn from the seed.
Checkpointing alone on the packed engine snapshots its relax planes
(ops/ckpt_relax.py).  Under ``set_mesh`` every method runs tiled over the
mesh (parallel/tiled.py, SPMD: every rank calls it with the full image and
gets the full result): ``transform`` on the tiled packed engine; the
per-level API and pure observers from one tiled pass's claim planes and
the host tails; the host-stepped loop on ``MeshLevelStepper``; and
``transform_batch`` over a ``"batch"`` dim.  Two methods own the engine
for every entry: ``_final_labels`` (one device, the checkpointed packed
route or the mesh) and ``_compact_planes`` (one relaxation pass's host
planes); both apply the saturation rule through ``_exact_rerun``.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import time
import warnings
from functools import partial
from typing import Any, Callable, Optional

import numpy as np
import torch

from .. import _ext
from ..constants import ALWAYS_FILL, NEVER_FILL, NORMAL_MAX
from ..ops.flood import flood_candidates, flood_candidates_random, flood_sweep_random, paint
from ..ops.level_driver import _flood_step, level_step, level_step_counted, run_levels_impl
from ..ops.ckpt_relax import ckpt_transform
from ..ops.merge import merge_touching
from ..ops.merge_curve import _device_curves, _fetch_planes, device_planes, iter_history_from_planes, merged_curve_host
from ..ops.preprocess import pre_process
from ..ops.seeds import local_extrema_mask, paint_seeds, seed_array
from ..parity.native import native_transform
from ..utils.checkpoint import TransformCheckpointer, fingerprint
from ..utils.perf import PerfReport
from ..utils.progress import ProgressBar
from ..utils.tracing import span, spanned

# Public backend name -> the port's engine (ops/level_driver.py).  'native'
# runs the C++ engine where it serves the call, else the plain level sweep.
_BACKENDS = {"auto": "packed", "relax": "relax", "pallas": "flood", "jnp": "sweep", "native": "sweep"}


@dataclasses.dataclass(frozen=True)
class HookCtx:
    """Per-water-level context handed to hooks (src/lib.rs:843-862).

    ``colours`` is the int32 label image after this level's fixed point (and
    merge phase, for merging); ``image`` the u8 input; ``seeds`` the
    ``(colour, (y, x))`` list with the original colours.  Under edge
    correction the views keep the padded shape and the seeds are not
    shifted, as in the reference (SURVEY.md Q7)."""

    water_level: int
    max_water_level: int
    image: np.ndarray
    colours: np.ndarray
    seeds: tuple[tuple[int, tuple[int, int]], ...]


def _warn_saturation():
    warnings.warn(
        "packed-key relax kernel d-field saturation detected: a "
        ">= 2^23-pixel equal-level plateau starved label propagation "
        "(ops/relax.py); re-running on the exact relaxation engine "
        "(ops/priority.py, 32-bit ring index)",
        RuntimeWarning,
        stacklevel=5,  # the caller of transform or transform_batch
    )


def _surviving_min(coords, w: int) -> int:
    """The least label that survives painting ``(n, 2)`` coordinates (a
    later seed at the same coordinate overwrites an earlier one), 0 for no
    seeds."""
    if coords.shape[0] == 0:
        return 0
    flat = coords[:, 0] * w + coords[:, 1]
    keep = flat.shape[0] - 1 - np.unique(flat[::-1], return_index=True)[1]
    return int(keep.min()) + 1


@spanned("rwt.api.expand_rows")
def _expand_rows(sizes, counts_length: int, max_water_level: int, copy: bool = False):
    """``[(level, counts row)]`` with rows of ``counts_length`` int64
    (the reference's ``n_pixels + 1`` by default, src/lib.rs:630).

    One ``(levels, counts_length)`` block: results under 64 MB come back as
    independent per-row copies, larger ones as views of the block (copying
    would double a reference-length result, 2 GB at 1024²) unless
    ``copy=True``."""
    levels = max_water_level + 1
    sizes = np.asarray(sizes)
    if sizes.shape == (levels, counts_length) and sizes.dtype == np.int64:
        # Already at result width (a fresh table): no block copy needed.
        if copy:
            return [(lvl, sizes[lvl].copy()) for lvl in range(levels)]
        return list(enumerate(sizes))
    out = np.zeros((levels, counts_length), dtype=np.int64)
    k = min(sizes.shape[1], counts_length)
    out[:, :k] = sizes[:levels, :k]
    if copy or out.nbytes < 64 * 1024 * 1024:
        return [(lvl, out[lvl].copy()) for lvl in range(levels)]
    return list(enumerate(out))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class WatershedUtils:
    """Image-preparation helpers (src/lib.rs:1069-1201).  ``device`` selects
    where find_local_minima computes its mask."""

    device = "cuda"

    def pre_processor(self, img) -> np.ndarray:
        """Normalise any numeric array to u8 [0, NORMAL_MAX] with the
        reference's special-value mapping (SURVEY.md Q4)."""
        return pre_process(img, NORMAL_MAX)

    def pre_processor_with_max(self, img, max_val: int) -> np.ndarray:
        return pre_process(img, max_val)

    def find_local_minima(self, img, mode: str = "reference") -> list[tuple[int, int]]:
        """Seed coordinates in row-major order: strict local *maxima* by
        value despite the name (src/lib.rs:1190, SURVEY.md Q1); pass
        ``mode='minima'`` for the documented intent."""
        with span("rwt.api.find_local_minima"):
            dev = _ext.resolve_device(self.device)
            mask = local_extrema_mask(torch.as_tensor(img).to(dev), mode)
            with span("rwt.api.seed_list"):
                # One read of the (2, n) columns.  A coordinate's int is made
                # once and shared by every seed on its row or column (a gather
                # from an object array), so only the tuples are made one by one.
                ys, xs = _ext.host_read(torch.nonzero(mask).t(), to="numpy")
                ints = np.array(range(max(mask.shape)), dtype=object)
                return list(zip(ints.take(ys).tolist(), ints.take(xs).tolist()))


class _WatershedBase(WatershedUtils):
    """Common implementation; subclasses set ``_merging``."""

    _merging: bool = False

    def __init__(
        self,
        max_water_level: int = NORMAL_MAX,
        edge_correction: bool = False,
        wlvl_hook: Optional[Callable[[HookCtx], Any]] = None,
        plot_path=None,
        plot_colour_map=None,
        progress: bool = False,
        debug: bool = False,
        sweep_fn=None,
        backend: str = "auto",
        device="cuda",
        checkpoint_dir=None,
        checkpoint_every: int = 16,
        tie_break: str = "min",
        tie_break_seed: int = 0,
        mesh=None,
    ):
        if backend not in _BACKENDS:
            raise ValueError(f"backend {backend!r} not served ({', '.join(_BACKENDS)})")
        self.max_water_level = int(max_water_level)
        self.edge_correction = bool(edge_correction)
        self.wlvl_hook = wlvl_hook
        self.plot_path = plot_path
        self.plot_colour_map = plot_colour_map
        self.progress = progress
        self.debug = debug
        self.sweep_fn = sweep_fn
        self.backend = backend
        self.device = device
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.tie_break = tie_break
        self.tie_break_seed = tie_break_seed
        self.mesh = mesh

    def _resolved_backend(self) -> str:
        """The engine behind the backend.  ``'auto'`` is the packed engine
        for every collect (merging curves and histories rebuild on the host
        from its compact planes, ops/merge_curve.py), and the plain level
        sweep under the random tie-break, which the relaxation engines and
        the flood kernel cannot run (they are min-label by construction).
        ``'native'`` resolves to the plain level sweep: the C++ engine
        serves transform and transform_to_list before any engine is
        chosen."""
        if self.backend == "auto" and self.tie_break == "random":
            return "sweep"
        return _BACKENDS[self.backend]

    def _uniform_plane(self, shape, index=None):
        """The random tie-break's float32 uniform [0, 1) plane, drawn on the
        CPU (the same plane on every device) from the seed, or for image
        ``index`` of a batch from ``SeedSequence([seed, index])``."""
        seed = self.tie_break_seed
        if index is not None:
            seed = int(np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0])
        gen = torch.Generator().manual_seed(seed)
        u = torch.rand(tuple(shape), generator=gen, dtype=torch.float32)
        return u.to(_ext.resolve_device(self.device))

    def _effective_sweep_fn(self, shape, index=None):
        """The level sweep's flood sweep: the caller's ``sweep_fn``, or
        under the random tie-break ``flood_sweep_random`` on the uniform
        plane (reference src/lib.rs:249-253)."""
        if self.tie_break != "random":
            return self.sweep_fn
        return partial(flood_sweep_random, u=self._uniform_plane(shape, index))

    def _clone_with_hook(self, hook):
        clone = copy.copy(self)
        clone.wlvl_hook = hook
        return clone

    @spanned("rwt.api.prepare")
    def _prepare(self, input_img, seeds):
        """Edge correction + painted seeds (src/lib.rs:1329-1369), on the
        device."""
        img = np.array(input_img, dtype=np.uint8)  # writable, for torch
        if self.edge_correction:
            # 1-px zero border (ALWAYS_FILL); seed coordinates are painted
            # WITHOUT the +1 shift, replicating the reference quirk
            # (src/lib.rs:1365-1367, SURVEY.md Q7).
            img = np.pad(img, 1, constant_values=ALWAYS_FILL)
        labels0 = paint_seeds(img.shape, seeds)
        dev = _ext.resolve_device(self.device)
        return torch.from_numpy(img).to(dev), torch.from_numpy(labels0).to(dev)

    def _prepare_batch(self, imgs, seeds_list):
        """``_prepare`` of a ``(b, h, w)`` stack, on the host: ``(imgs,
        painted labels, seed coordinate arrays, n_labels)``."""
        if self.edge_correction:
            imgs = np.pad(imgs, ((0, 0), (1, 1), (1, 1)), constant_values=ALWAYS_FILL)
        coords = [seed_array(s) for s in seeds_list]
        labels0 = np.stack([paint_seeds(imgs.shape[1:], c) for c in coords])
        return imgs, labels0, coords, max((len(c) for c in coords), default=0)

    def _needs_host_loop(self) -> bool:
        return (
            self.wlvl_hook is not None
            or self.plot_path is not None
            or self.progress
            or self.debug
            or self.checkpoint_dir is not None
        )

    def _ckpt_fast_path(self) -> bool:
        """Checkpointing alone on the packed engine (so under the min rule):
        relax-plane snapshots (ops/ckpt_relax.py) instead of the host loop.
        The JAX package takes this path only on its Pallas engine, so on
        the CPU its ``'auto'`` ('relax' there) steps the levels instead;
        the labels are equal either way.  A mesh checkpoints on the host
        loop."""
        return (
            self.checkpoint_dir is not None
            and self.wlvl_hook is None
            and self.plot_path is None
            and not self.progress
            and not self.debug
            and self.sweep_fn is None
            and self.mesh is None
            and self._resolved_backend() == "packed"
        )

    def _planes_serve(self) -> bool:
        """Whether one relaxation pass's compact planes serve the per-level
        entries (``transform_to_list``, ``transform_history``): on the
        relaxation engines, and on a mesh whatever the backend (one tiled
        pass's claim planes, models/base.py:689-736 of the JAX package).
        Elsewhere the level sweep collects them."""
        return self.mesh is not None or self._resolved_backend() in ("packed", "relax")

    # -- the engine: final labels or compact planes ---------------------------

    def _final_labels(self, img, labels0, *, n_labels: int, tiled: bool = True, sweep_fn=None,
                      checkpointer=None, **kw):
        """The final labels of the configured engine: tiled over the mesh
        (the packed engine, whatever the backend; ``tiled=False`` stays on
        this device), ``ckpt_transform`` with a ``checkpointer``, else
        ``run_levels_impl`` (``sweep_fn`` defaults to the effective sweep of
        the image's shape; ``kw`` may declare a stacked batch).  A saturated
        packed pass re-runs on the exact engine (``_exact_rerun``)."""
        kw.update(n_labels=n_labels, max_water_level=self.max_water_level, merging=self._merging)
        if tiled and self.mesh is not None:
            from ..parallel.tiled import _tiled_run

            labels, _, starved = _tiled_run(img, labels0, self.mesh, **kw)
        elif checkpointer is not None:
            labels, starved = ckpt_transform(img, labels0, checkpointer=checkpointer, device=img.device, **kw)
        else:
            if sweep_fn is None:
                sweep_fn = self._effective_sweep_fn(img.shape)
            labels, starved = run_levels_impl(
                img, labels0, backend=self._resolved_backend(), with_flags=True, sweep_fn=sweep_fn,
                device=img.device, **kw,
            )
        return self._exact_rerun(img, labels0, **kw) if starved else labels

    def _compact_planes(self, img, labels0, *, n_labels: int):
        """The host compact planes ``(labels, claim levels as u8, lo, hi,
        act)`` of one relaxation pass, on the packed or exact engine
        (ops/merge_curve.py) or tiled over the mesh (``collect='claims'``,
        segmenting labels): the merge edges for the merging variant, none
        for segmenting.  A saturated packed pass re-runs on the exact
        engine (``_exact_rerun``)."""
        mwl = self.max_water_level
        if self.mesh is not None:
            from ..parallel.tiled import _tiled_run

            (labels, claim), _, starved = _tiled_run(
                img, labels0, self.mesh, n_labels=n_labels, max_water_level=mwl, merging=False, collect="claims"
            )
            planes = device_planes(labels, claim, max_water_level=mwl, with_edges=self._merging)
        else:
            planes, starved = self._relax_pass(img, labels0, n_labels, self._resolved_backend())
        if starved:
            planes = self._exact_rerun(img, labels0, n_labels=n_labels, planes=True)
        return _fetch_planes(*planes)

    def _relax_pass(self, img, labels0, n_labels: int, backend: str):
        """``(device planes, starved)`` of one relaxation pass on this
        device."""
        _, planes, starved = _device_curves(
            img, labels0, n_labels=n_labels, max_water_level=self.max_water_level, backend=backend,
            with_final=False, with_edges=self._merging, device=img.device,
        )
        return planes, starved

    def _exact_rerun(self, img, labels0, *, n_labels: int, planes: bool = False, **kw):
        """The saturation rule, for every route: the packed key's d field
        saturated (on this device, or anywhere on the mesh), so warn and
        re-run on the exact engine on this rank's device; every rank holds
        the full image, so no collective is needed.  The JAX mesh drops the
        flag: a deliberate divergence (ROADMAP queue 3).  Returns the device
        planes with ``planes=True``, else the final labels (``kw`` as for
        ``run_levels_impl``); ``img`` and ``labels0`` may be ``(b, h, w)``
        stacks of the images to re-run, warned about once."""
        _warn_saturation()
        if planes:
            return self._relax_pass(img, labels0, n_labels, "relax")[0]
        run = partial(run_levels_impl, n_labels=n_labels, backend="relax", device=img.device, **kw)
        if img.dim() == 3:
            return torch.stack([run(a, b) for a, b in zip(img, labels0)])
        return run(img, labels0)

    def _snapshots(self, img, labels0, n_labels: int):
        """``(level, snapshot)`` pairs rebuilt from the compact planes, one
        at a time."""
        labels_np, lv8_np, lo, hi, act = self._compact_planes(img, labels0, n_labels=n_labels)
        return iter_history_from_planes(labels_np, lv8_np, self.max_water_level, lo, hi, act, n_labels=n_labels)

    def _native(self, input_img, seeds, **kw):
        return native_transform(
            np.asarray(input_img, dtype=np.uint8), seeds, self.max_water_level,
            merging=self._merging, edge_correction=self.edge_correction, **kw,
        )

    @spanned("rwt.api.transform")
    def transform(self, input_img, seeds, device_output: bool = False):
        """Final label image (host numpy int32, or the device tensor with
        ``device_output=True``).  With a hook, plots, progress, debug or
        per-level checkpoints the levels are observed on the way and the
        last level's view is the result."""
        ckpt_fast = self._ckpt_fast_path()
        if self.backend == "native" and not self._needs_host_loop():
            out = self._native(input_img, seeds).astype(np.int32)
        elif self._needs_host_loop() and not ckpt_fast:
            clone = self._clone_with_hook(
                lambda ctx: ctx.colours.copy() if ctx.water_level == ctx.max_water_level else None
            )
            out = clone._host_stepped(input_img, seeds)[-1]
        else:
            img, labels0 = self._prepare(input_img, seeds)
            ckpt = TransformCheckpointer(self.checkpoint_dir, self.checkpoint_every) if ckpt_fast else None
            labels = self._final_labels(img, labels0, n_labels=len(seeds), checkpointer=ckpt)
            return labels if device_output else _ext.host_read(labels, "numpy")
        return torch.from_numpy(out).to(_ext.resolve_device(self.device)) if device_output else out

    def transform_with_hook(self, input_img, seeds) -> list:
        """Run the transform, calling the hook at each water level; returns
        the hook's results (empty without a hook), like the reference
        (src/lib.rs:1509-1521)."""
        if not self._needs_host_loop():
            img, labels0 = self._prepare(input_img, seeds)
            self._final_labels(img, labels0, n_labels=len(seeds))
            return []
        return self._host_stepped(input_img, seeds)

    @spanned("rwt.api.transform_to_list")
    def transform_to_list(
        self, input_img, seeds, counts_length: Optional[int] = None, copy: bool = False
    ) -> list[tuple[int, np.ndarray]]:
        """Per-level lake sizes: ``[(water_level, counts)]`` with
        ``counts[label]`` the pixel count of a label and ``counts[0]`` the
        uncoloured count, int64.  ``counts_length=None`` gives the
        reference's ``n_pixels + 1`` rows (src/lib.rs:630, SURVEY.md Q10);
        pass e.g. ``len(seeds) + 1`` for compact rows.  Rows of a result
        over 64 MB are views of one block unless ``copy=True``."""
        if self.backend == "native" and not self._needs_host_loop():
            _, sizes = self._native(input_img, seeds, with_sizes=True)
            if counts_length is None:
                h, w = np.shape(input_img)
                pad = 2 if self.edge_correction else 0
                counts_length = (h + pad) * (w + pad) + 1
            return _expand_rows(sizes, counts_length, self.max_water_level, copy)
        if self._needs_host_loop():
            # The reference's transform_to_list is clone_with_hook(
            # find_lake_sizes) (src/lib.rs:1551-1561).
            length = counts_length

            def find_lake_sizes(ctx):
                n = length if length is not None else ctx.colours.size + 1
                counts = np.bincount(ctx.colours.reshape(-1).astype(np.int64), minlength=n)[:n]
                row = np.zeros(n, dtype=np.int64)
                row[: len(counts)] = counts
                return (ctx.water_level, row)

            return self._clone_with_hook(find_lake_sizes)._host_stepped(input_img, seeds)
        img, labels0 = self._prepare(input_img, seeds)
        if counts_length is None:
            counts_length = img.numel() + 1
        n_labels, mwl = len(seeds), self.max_water_level
        if self._planes_serve():
            # One relaxation pass, the compact planes to the host, and the
            # host tail (ops/merge_curve.py).
            labels_np, lv8_np, lo, hi, act = self._compact_planes(img, labels0, n_labels=n_labels)
            sizes = merged_curve_host(labels_np, lv8_np, n_labels, mwl, lo, hi, act, out_width=counts_length)
        else:
            _, sizes = run_levels_impl(
                img, labels0, collect="sizes", backend=self._resolved_backend(), n_labels=n_labels,
                max_water_level=mwl, merging=self._merging, sweep_fn=self._effective_sweep_fn(img.shape),
                device=img.device,
            )
            sizes = _ext.host_read(sizes, "numpy")
        return _expand_rows(sizes, counts_length, mwl, copy)

    def _history_stack_fits(self, shape) -> bool:
        """Whether the level sweep's ``(levels, h, w)`` int32 snapshot stack
        fits a quarter of the card's memory (on the CPU it is host memory
        either way)."""
        dev = _ext.resolve_device(self.device)
        if dev.type != "cuda":
            return True
        stack = 4 * (self.max_water_level + 1) * int(np.prod(shape))
        return stack <= torch.cuda.get_device_properties(dev).total_memory // 4

    def transform_history(self, input_img, seeds) -> list[tuple[int, np.ndarray]]:
        """Per-level int32 label snapshots ``[(water_level, labels)]``
        (src/lib.rs:1233-1237); memory-heavy: ``levels`` planes in host
        memory, as in the reference (src/lib.rs:1229-1232).  The level sweep
        stacks them on the card first, unless the stack would not fit; then
        the host loop collects one plane per level."""
        compact = self._planes_serve()
        if self._needs_host_loop() or not (compact or self._history_stack_fits(np.shape(input_img))):
            return self._clone_with_hook(
                lambda ctx: (ctx.water_level, ctx.colours.copy())
            )._host_stepped(input_img, seeds)
        img, labels0 = self._prepare(input_img, seeds)
        if compact:
            return list(self._snapshots(img, labels0, len(seeds)))
        _, hist = run_levels_impl(
            img, labels0, collect="history", backend=self._resolved_backend(), n_labels=len(seeds),
            max_water_level=self.max_water_level, merging=self._merging,
            sweep_fn=self._effective_sweep_fn(img.shape), device=img.device,
        )
        hist = hist.cpu().numpy()
        return [(lvl, hist[lvl]) for lvl in range(self.max_water_level + 1)]

    def transform_batch(self, input_imgs, seeds_list, device_output: bool = False):
        """Transform a ``(b, h, w)`` stack of same-shaped cutouts (BASELINE
        config 5: 64 x 1024² cutouts), one seed list per image; returns
        ``(b, h, w)`` labels like ``transform``.  Hooks, plots, progress,
        debug and checkpoints do not apply.  Under the random tie-break each
        image draws its own uniform plane (``SeedSequence([seed, i])``), so
        image i's labels do not depend on the other images or the batch
        size.

        On the relaxation engines the images run as ONE vertically stacked
        plane with their borders forced to NEVER_FILL: border cells are never
        claimed, so claims and labels cannot cross images and one relax pass
        equals b transforms.  Merging adds one NEVER_FILL separator row per
        image, so the component-min scans stay per image too, and at full
        depth on the packed engine, when no seed sits on an image border
        (checked here on the host), declares the stack to the driver for the
        per-image broadcast shortcut (models/base.py:491-582 of the JAX
        package).  The level sweeps run image by image.

        Under a mesh with a ``"batch"`` dim the images split over its batch
        groups (B divisible by its size), each group's ``(y, x)`` sub-mesh
        transforms its images one after another, and every rank gets the
        whole stack (models/base.py:477-489 of the JAX package); a mesh
        without one is ignored.
        """
        imgs = np.asarray(input_imgs, dtype=np.uint8)
        if imgs.ndim != 3:
            raise ValueError("transform_batch expects (B, H, W)")
        if len(seeds_list) != imgs.shape[0]:
            raise ValueError("one seed list per image required")
        if self.mesh is not None and "batch" in tuple(self.mesh.mesh_dim_names or ()):
            out = self._mesh_batch(imgs, seeds_list)
            return out if device_output else out.cpu().numpy()
        backend = self._resolved_backend()
        if backend in ("flood", "sweep"):
            runs = []
            for i, (a, s) in enumerate(zip(imgs, seeds_list)):
                img, labels0 = self._prepare(a, s)
                sweep_fn = self._effective_sweep_fn(img.shape, index=i)
                runs.append(self._final_labels(img, labels0, n_labels=len(s), tiled=False, sweep_fn=sweep_fn))
            out = torch.stack(runs)
            return out if device_output else out.cpu().numpy()
        imgs, labels0, coords, n_labels = self._prepare_batch(imgs, seeds_list)
        b, h, w = imgs.shape
        imgs = imgs.copy()
        imgs[:, [0, -1], :] = NEVER_FILL
        imgs[:, :, [0, -1]] = NEVER_FILL
        hs = h + 1 if self._merging else h
        kw = {}
        if self._merging:
            imgs = np.concatenate([imgs, np.full((b, 1, w), NEVER_FILL, np.uint8)], axis=1)
            labels0 = np.pad(labels0, ((0, 0), (0, 1), (0, 0)))
            border_seed = any(
                ((c[:, 0] == 0) | (c[:, 0] == h - 1) | (c[:, 1] == 0) | (c[:, 1] == w - 1)).any()
                for c in coords
            )
            if backend == "packed" and self.max_water_level >= 254 and not border_seed:
                kw.update(batch=(b, hs, h), batch_mins=[_surviving_min(c, w) for c in coords])
        dev = _ext.resolve_device(self.device)
        img = torch.from_numpy(np.ascontiguousarray(imgs.reshape(b * hs, w))).to(dev)
        lab = torch.from_numpy(np.ascontiguousarray(labels0.reshape(b * hs, w))).to(dev)
        out = self._final_labels(img, lab, n_labels=n_labels, tiled=False, **kw).reshape(b, hs, w)[:, :h]
        return out if device_output else out.cpu().numpy()

    def _mesh_batch(self, imgs, seeds_list):
        """``transform_batch`` over the mesh's ``"batch"`` dim
        (``parallel.tiled._tiled_batch``); the images whose pass saturated
        the packed key's d field re-run on the exact engine, on every
        rank."""
        from ..parallel.tiled import _tiled_batch

        imgs, labels0, _, n_labels = self._prepare_batch(imgs, seeds_list)
        dev = _ext.resolve_device(self.device)
        img_t, lab_t = torch.from_numpy(imgs).to(dev), torch.from_numpy(labels0).to(dev)
        kw = dict(n_labels=n_labels, max_water_level=self.max_water_level, merging=self._merging)
        out, starved = _tiled_batch(img_t, lab_t, self.mesh, backend="packed", **kw)
        if starved.any():
            redo = np.flatnonzero(starved).tolist()
            out[redo] = self._exact_rerun(img_t[redo], lab_t[redo], **kw)
        return out

    # -- per-level observers: replay or the host-stepped loop ------------------

    def _fast_observer_ok(self) -> bool:
        """Pure observers (hook, plots) replay snapshots rebuilt from the
        relaxation engines' compact planes: one device pass instead of 255
        host-stepped levels.  Progress (a tick per flood sweep), debug
        (split-phase timers), per-level checkpoints (the saves are the
        recovery points) and a custom sweep interact with the stepping
        itself and run the real loop, as do the random tie-break and the
        native backend, which resolve to the level sweep.  So a mesh
        replays from one tiled pass's planes whatever the backend but the
        native one, as the JAX package's does (models/base.py:912), while
        its ``transform_history`` takes the planes under ``'native'`` too
        (``_planes_serve``)."""
        return (
            not self.debug
            and not self.progress
            and self.checkpoint_dir is None
            and self.sweep_fn is None
            and self._planes_serve()
            and self.backend != "native"
        )

    def _seed_colours(self, seeds):
        return tuple((col, (int(y), int(x))) for col, (y, x) in enumerate(seeds, start=1))

    def _replayed_observers(self, input_img, seeds) -> list:
        """Hook and plot replay over compact-plane snapshots, one live at a
        time: the same HookCtx views and PNG files as the host-stepped
        loop."""
        img, labels0 = self._prepare(input_img, seeds)
        snaps = self._snapshots(img, labels0, len(seeds))
        seed_colours = self._seed_colours(seeds)
        img_np = img.cpu().numpy()
        results = []
        root = self._root()
        for lvl, labels_np in snaps:
            if self.plot_path is not None and root:
                self._plot_level(labels_np, lvl)
            if self.wlvl_hook is not None:
                results.append(self.wlvl_hook(HookCtx(
                    water_level=lvl, max_water_level=self.max_water_level,
                    image=img_np, colours=labels_np, seeds=seed_colours,
                )))
        return results

    def _root(self) -> bool:
        """Whether this process writes plots and checkpoints and prints:
        always on one device, mesh rank 0 alone under a mesh."""
        if self.mesh is None:
            return True
        from ..parallel.tiled import mesh_root

        return mesh_root(self.mesh)

    def _host_stepped(self, input_img, seeds) -> list:
        """The reference's per-level loop stepped from the host
        (src/lib.rs:1379-1521): per level the flood fixed point on the
        flood kernel (backend ``'pallas'``) or ``level_step`` with the
        effective sweep, ``level_step_counted`` for progress ticks, or the
        split candidate / paint / merge phases with timers for debug.  With
        a checkpoint directory the labels are saved every
        ``checkpoint_every`` levels, and a run resumes from the newest
        snapshot of its fingerprint at the level after it (a snapshot of
        the last level re-runs that level, so its hooks still fire).

        Under a mesh the levels run on ``MeshLevelStepper`` (whatever the
        backend and sweep function): a tick and a debug ``loop`` per
        halo-exchange round, debug timing whole levels; the checkpoints hold
        the cropped domain and a resume re-embeds it.  Hooks run on every
        rank; plots, snapshot files, the bar and debug prints come from
        mesh rank 0, and every rank waits after a save until it is on
        disk."""
        if self._fast_observer_ok():
            return self._replayed_observers(input_img, seeds)
        img, labels = self._prepare(input_img, seeds)
        dev = img.device
        n_labels = len(seeds)
        seed_colours = self._seed_colours(seeds)
        img_np = img.cpu().numpy()
        root = self._root()
        ckpt, start_lvl = None, 0
        if self.checkpoint_dir is not None:
            ckpt = TransformCheckpointer(self.checkpoint_dir, self.checkpoint_every)
            fp = fingerprint(
                img, labels, kind="levels", merging=self._merging, max_water_level=self.max_water_level,
                tie_break=self.tie_break, tie_break_seed=self.tie_break_seed if self.tie_break == "random" else 0,
            )
            latest = ckpt.latest(fp)
            if latest is not None and latest[1].shape == tuple(labels.shape):
                start_lvl = min(latest[0] + 1, self.max_water_level)
                labels = torch.from_numpy(latest[1]).to(dev)
        sweep_fn = self._effective_sweep_fn(img.shape)
        stepper = None
        if self.mesh is not None:
            from ..parallel.tiled import MeshLevelStepper, mesh_barrier

            stepper = MeshLevelStepper(self.mesh, n_labels=n_labels, merging=self._merging)
            img_t, labels = stepper.prepare(img, labels)

            def step(lab, lvl):
                return stepper.step(img_t, lab, lvl)
        elif self.debug:
            cand_fn = flood_candidates if self.tie_break != "random" else partial(
                flood_candidates_random, u=self._uniform_plane(img.shape)
            )
        elif self.progress:
            def step(lab, lvl):
                return level_step_counted(img, lab, lvl, merging=self._merging, n_labels=n_labels, sweep_fn=sweep_fn)
        elif self._resolved_backend() == "flood" and sweep_fn is None:
            step, labels = _flood_step(img, labels, merging=self._merging, n_labels=n_labels, steps=None)
        else:
            def step(lab, lvl):
                return level_step(img, lab, lvl, merging=self._merging, n_labels=n_labels, sweep_fn=sweep_fn)
        bar = ProgressBar(self.max_water_level) if self.progress and root else None
        if self.debug and root:
            # The reference prints the initial lake count (src/lib.rs:1371-1372).
            print(f"starting with {len(seeds) + 1} lakes")

        results = []
        for lvl in range(start_lvl, self.max_water_level + 1):
            perf = PerfReport() if self.debug else None
            t_level = time.perf_counter()
            if stepper is not None:
                # A whole level a step; a tick and a debug loop per
                # halo-exchange round (models/base.py:1108-1121 of the JAX
                # package).
                t0 = time.perf_counter()
                labels, loops = step(labels, lvl)
                _sync(dev)
                if perf is not None:
                    perf.loops = loops
                    perf.big_iter_ms.append(int((time.perf_counter() - t0) * 1e3))
                if bar is not None:
                    for _ in range(loops):
                        bar.tick()
            elif self.debug:
                # Split phases with timers and a progress tick per colouring
                # iteration, like the reference's 'debug' feature
                # (src/lib.rs:1379-1438): one host read per sweep.
                painted_any = False
                while True:
                    if bar is not None:
                        bar.tick()
                    perf.loops += 1
                    t0 = time.perf_counter()
                    cand, nmin, any_p = cand_fn(img, labels, lvl)
                    any_p = bool(any_p)
                    perf.big_iter_ms.append(int((time.perf_counter() - t0) * 1e3))
                    if not any_p:
                        break
                    t0 = time.perf_counter()
                    labels = paint(labels, cand, nmin)
                    _sync(dev)
                    perf.colouring_mus.append(int((time.perf_counter() - t0) * 1e6))
                    painted_any = True
                if self._merging and (painted_any or lvl == 0):
                    t0 = time.perf_counter()
                    labels = merge_touching(labels, n_labels)
                    _sync(dev)
                    perf.merge_ms = int((time.perf_counter() - t0) * 1e3)
            elif self.progress:
                # A tick per colouring iteration (src/lib.rs:1395-1398).
                labels, loops = step(labels, lvl)
                for _ in range(loops):
                    bar.tick()
            else:
                labels = step(labels, lvl)

            labels_np = stepper.crop(labels) if stepper is not None else labels.cpu().numpy()
            if ckpt is not None:
                if root:
                    ckpt.maybe_save(lvl, labels_np, fp)
                if stepper is not None and lvl % ckpt.every == 0:
                    # No rank goes on before the snapshot is on disk.
                    mesh_barrier(self.mesh, dev)
            if self.plot_path is not None and root:
                self._plot_level(labels_np, lvl)
            if bar is not None:
                bar.inc()
            if self.wlvl_hook is not None:
                ctx = HookCtx(
                    water_level=lvl, max_water_level=self.max_water_level,
                    image=img_np, colours=labels_np, seeds=seed_colours,
                )
                t0 = time.perf_counter()
                results.append(self.wlvl_hook(ctx))
                if perf is not None:
                    # The reference declares lake_count_ms but never writes
                    # it (src/lib.rs:649, :682); the hook time fills it here.
                    perf.lake_count_ms = int((time.perf_counter() - t0) * 1e3)
            if perf is not None and root:
                perf.total_ms = int((time.perf_counter() - t_level) * 1e3)
                print(perf)
        if bar is not None:
            bar.finish()
        return results

    def _plot_level(self, labels_np: np.ndarray, lvl: int):
        from ..utils import plotting

        # Plots are cropped to the unpadded image (src/lib.rs:1476-1481).
        view = labels_np[1:-1, 1:-1] if self.edge_correction else labels_np
        cmap = self.plot_colour_map or plotting.viridis
        plotting.plot_slice(view, os.path.join(str(self.plot_path), f"ws_lvl{lvl}.png"), cmap)
