"""Which engine each public entry of the port's model layer runs, per
backend and variant, on the CPU.

The engines are observed from outside the model layer: the plain twins'
counters in ``_ext.launches`` (the pack and relax kernels of the packed
engine, the flood kernel, the merging tail's route) and spies on the
engines' own entry points (the exact engine's ``init_state``, the plain
``flood_sweep``, the C++ engine's calls, the mesh's packed tile driver).
So the test holds whatever shape the dispatch inside ``models/base.py``
takes.  Label parity is held elsewhere; the images here are small."""

import collections
import contextlib
import functools

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch_mesh import one_rank_group

from rustronomy_watershed_tpu_torch import _ext
from rustronomy_watershed_tpu_torch.ops import flood, level_driver, priority
from rustronomy_watershed_tpu_torch.ops.seeds import paint_seeds
from rustronomy_watershed_tpu_torch.parallel import tiled
from rustronomy_watershed_tpu_torch.parity import native
from rustronomy_watershed_tpu_torch.prelude import TransformBuilder

torch.set_num_threads(1)

ENTRIES = ("transform", "transform_to_list", "transform_history", "transform_with_hook", "transform_batch")

# The counters of ``_ext.launches`` that name an engine or a route.
_COUNTERS = {
    "pack_plain": "pack", "relax_plain": "relax", "flood_plain": "flood", "merge_tail": "merge_tail",
    "merge_shortcut": "merge_shortcut", "merge_round": "merge_round",
}

# What each entry runs, segmenting: ``relax`` the packed engine's relax
# twin (the seeds are painted, so the pack twin does not run), ``exact``
# the exact engine, ``flood`` the flood kernel's twin, ``sweep`` the plain
# level sweep, ``native`` the C++ engine, ``curve`` the C++ merged-curve
# tail, ``mesh`` the mesh's packed tile driver.
_SEG = {
    "auto": {**{e: ("relax",) for e in ENTRIES}, "transform_to_list": ("relax", "curve")},
    "relax": {**{e: ("exact",) for e in ENTRIES}, "transform_to_list": ("exact", "curve")},
    "pallas": {e: ("flood",) for e in ENTRIES},
    "jnp": {e: ("sweep",) for e in ENTRIES},
    "native": {**{e: ("sweep",) for e in ENTRIES}, "transform": ("native",), "transform_to_list": ("native",)},
    "mesh": {**{e: ("mesh", "relax") for e in ENTRIES}, "transform_to_list": ("mesh", "relax", "curve"),
             "transform_batch": ("relax",)},
}


def _merging_routes(entry, engines):
    """The merging variant's additions: the level sweeps' merge rounds, and
    the component-min tail of the final labels on one device's packed
    engine (the mesh merges on its own; the curves and snapshots are
    rebuilt on the host)."""
    if engines in (("flood",), ("sweep",)):
        return engines + ("merge_round",)
    if entry in ("transform", "transform_batch") and engines == ("relax",):
        return engines + ("merge_tail",)
    return engines


@functools.cache
def _field():
    """A 24 x 22 field with NEVER_FILL dots (so the merging tail runs, not
    the broadcast shortcut) and its seeds."""
    rng = np.random.default_rng(5)
    img = rng.integers(0, 40, size=(24, 22)).astype(np.uint8)
    img[rng.random(img.shape) < 0.1] = 255
    seeds = TransformBuilder.default().set_device("cpu").build_segmenting().find_local_minima(img)
    return img, seeds


def _spy(monkeypatch, seen, module, name, tag):
    real = getattr(module, name)

    def spied(*a, **k):
        seen[tag] += 1
        return real(*a, **k)

    monkeypatch.setattr(module, name, spied)


def _engines_of(monkeypatch, call) -> tuple:
    """The sorted names of the engines and routes that ``call()`` ran."""
    seen = collections.Counter()
    _spy(monkeypatch, seen, priority, "init_state", "exact")
    _spy(monkeypatch, seen, flood, "flood_sweep", "sweep")
    _spy(monkeypatch, seen, tiled, "_local_relax_packed_driver", "mesh")
    check = native._check

    def native_check(rc, what):
        seen["native" if what == "transform" else "curve"] += 1
        return check(rc, what)

    monkeypatch.setattr(native, "_check", native_check)
    _ext.reset_launches()
    call()
    seen.update({tag: _ext.launches[k] for k, tag in _COUNTERS.items()})
    return tuple(sorted(tag for tag, n in seen.items() if n > 0))


def _call(ws, entry, img, seeds):
    if entry == "transform_batch":
        return ws.transform_batch(img[None], [seeds])
    return getattr(ws, entry)(img, seeds)


@pytest.mark.parametrize("variant", ["segmenting", "merging"])
@pytest.mark.parametrize("backend", ["auto", "relax", "pallas", "jnp", "native", "mesh"])
@pytest.mark.parametrize("entry", ENTRIES)
def test_entry_runs_its_engine(monkeypatch, tmp_path, entry, backend, variant):
    """Each entry's engine on one device for every backend, and ``'auto'``
    on a one-rank gloo mesh (``transform_batch`` without a ``'batch'`` dim
    ignores the mesh); ``transform_with_hook`` with a pure hook replays
    the compact planes on the relaxation engines and the mesh and steps the
    levels elsewhere.  The result equals the single device's ``'auto'``."""
    img, seeds = _field()

    def builder():
        tb = TransformBuilder.default().set_device("cpu")
        if entry == "transform_with_hook":
            tb.set_wlvl_hook(lambda ctx: ctx.colours.copy())
        return tb

    def build(tb):
        return getattr(tb, f"build_{variant}")()

    with one_rank_group(tmp_path) if backend == "mesh" else contextlib.nullcontext() as mesh:
        tb = builder().set_mesh(mesh) if backend == "mesh" else builder().set_backend(backend)
        ws = build(tb)
        got = []
        engines = _engines_of(monkeypatch, lambda: got.append(_call(ws, entry, img, seeds)))
    want = _SEG[backend][entry]
    if variant == "merging":
        want = _merging_routes(entry, want)
    assert engines == tuple(sorted(want))
    ref = _call(build(builder()), entry, img, seeds)
    _assert_same(got[0], ref)


def _assert_same(got, want):
    if isinstance(got, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            if isinstance(g, tuple):
                assert g[0] == w[0]
                g, w = g[1], w[1]
            np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_array_equal(got, want)


class _KeyUses(TorchFunctionMode):
    """Records the torch functions called on the packed engine's key plane
    once ``relax_transform_packed`` has returned it."""

    def __init__(self, keys):
        super().__init__()
        self.keys, self.uses = keys, []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(a is k for k in self.keys for a in (*args, *kwargs.values())):
            self.uses.append(func)
        return func(*args, **kwargs)


@pytest.mark.parametrize("collect", ["none", "sizes"])
def test_packed_collect_none_forms_no_claim_plane(monkeypatch, collect):
    """``run_levels_impl`` on the packed engine reads the key plane for its
    claim levels only when a collect needs them: with ``collect='none'``
    nothing touches the key after the engine returns it."""
    img, seeds = _field()
    keys = []
    engine = level_driver.relax_transform_packed

    def spied(*a, **k):
        out = engine(*a, **k)
        keys.append(out[1])
        return out

    monkeypatch.setattr(level_driver, "relax_transform_packed", spied)
    lab0 = torch.from_numpy(paint_seeds(img.shape, seeds))
    with _KeyUses(keys) as mode:
        level_driver.run_levels_impl(torch.from_numpy(img), lab0, max_water_level=254, n_labels=len(seeds),
                                     collect=collect, backend="packed", device="cpu")
    assert len(keys) == 1
    assert (mode.uses == []) == (collect == "none")
