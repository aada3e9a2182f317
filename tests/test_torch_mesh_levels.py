"""The host-stepped level loop on the port's mesh (``MeshLevelStepper``,
the flood kernel's twin a round, and the builder's hooks, progress, debug,
plots and per-level checkpoints under ``set_mesh``) against the port's
single device and the JAX package's ``MeshLevelStepper`` and mesh builder
on its virtual CPU devices.  Tolerance 0, on every rank.

One spawn of four gloo ranks (tests/torch_mesh.py) computes every case on
the meshes 1 x 1, 1 x 2, 2 x 1 and 2 x 2.  The fields compared with the
JAX mesh's merging hold no border seed; ``_border_field`` is one where the
JAX mesh's one-way merge keeps a border seed's label apart, which the port
merges as every single-device transform does (ROADMAP queue 3).
"""

import contextlib
import functools
import io
import os
import re

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from rustronomy_watershed_tpu.parallel.tiled import MeshLevelStepper as JaxStepper
from rustronomy_watershed_tpu.prelude import TransformBuilder as JaxBuilder
from rustronomy_watershed_tpu_torch.ops.level_driver import run_levels_impl
from rustronomy_watershed_tpu_torch.ops.seeds import paint_seeds
from rustronomy_watershed_tpu_torch.prelude import TransformBuilder
from torch_mesh import mesh_of, one_rank_group, run_ranks

torch.set_num_threads(1)

MESHES = [(1, 1), (1, 2), (2, 1), (2, 2)]
VARIANTS = ["segmenting", "merging"]
MAXLVL = 11
STEPPER_FIELDS = {"37x45": (37, 45), "32x24": (32, 24)}
LOOP = (22, 27)  # the builder's host-loop field
CKPT_STOP = 5  # the level whose hook interrupts the checkpointed run


def _field(shape, seed=0):
    """``(img, seeds)``: random values up to MAXLVL, five interior seeds."""
    h, w = shape
    rng = np.random.default_rng(h * 100 + w + seed)
    img = rng.integers(0, MAXLVL + 1, (h, w)).astype(np.uint8)
    seeds = sorted({(int(y), int(x)) for y, x in rng.integers(1, [h - 1, w - 1], size=(5, 2))})
    return img, seeds


def _border_field():
    """A border seed (0, 12) whose only interior neighbour (1, 12) is the
    seed of label 2: it is 4-adjacent to label 2 from level 0, so every
    single-device merge joins them, while the JAX mesh's merge scatters
    the pair into the interior centre's entry alone, and label 3 > 2 never
    takes a partner."""
    rng = np.random.default_rng(12)
    img = rng.integers(0, MAXLVL + 1, (20, 26)).astype(np.uint8)
    return img, [(9, 4), (1, 12), (0, 12), (15, 20)]


def _hook(ctx):
    return ctx.water_level, ctx.colours.copy(), ctx.seeds


def _builder(variant, mesh=None, jax_=False, **opts):
    tb = JaxBuilder.default() if jax_ else TransformBuilder().set_device("cpu")
    tb.set_max_water_lvl(MAXLVL)
    for setter, args in opts.items():
        getattr(tb, setter)(*args)
    if mesh is not None:
        tb.set_mesh(mesh)
    return getattr(tb, f"build_{variant}")()


def _captured(fn):
    """``(fn(), stdout, stderr)``."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        res = fn()
    return res, out.getvalue(), err.getvalue()


def _stepped(stepper, img, seeds):
    """Every level's cropped labels and rounds of a stepper."""
    dev_img, lab = stepper.prepare(torch.from_numpy(img), torch.from_numpy(paint_seeds(img.shape, seeds)))
    planes, rounds = [], []
    for lvl in range(MAXLVL + 1):
        lab, n = stepper.step(dev_img, lab, lvl)
        planes.append(stepper.crop(lab))
        rounds.append(int(n))
    return np.stack(planes), rounds


def _rank_cases(rank, root):
    from rustronomy_watershed_tpu_torch.parallel import tiled_transform
    from rustronomy_watershed_tpu_torch.parallel.tiled import MeshLevelStepper

    out = {}
    for shape in MESHES:
        mesh = mesh_of(shape)
        if mesh.get_coordinate() is None:
            continue
        tag = f"{shape[0]}x{shape[1]}"
        fields = {name: _field(s) for name, s in STEPPER_FIELDS.items()}
        fields["border"] = _border_field()
        for name, (img, seeds) in fields.items():
            for variant in VARIANTS:
                stepper = MeshLevelStepper(mesh, n_labels=len(seeds), merging=variant == "merging")
                out[("stepper", shape, name, variant)] = _stepped(stepper, img, seeds)
        img, seeds = _field(LOOP)
        for variant in VARIANTS:
            merging = variant == "merging"
            out[("sweep", shape, variant)] = tiled_transform(
                torch.from_numpy(img), torch.from_numpy(paint_seeds(img.shape, seeds)), mesh,
                n_labels=len(seeds), max_water_level=MAXLVL, merging=merging, backend="sweep").numpy()
            ws = _builder(variant, mesh, set_wlvl_hook=(_hook,), enable_progress=())
            out[("progress", shape, variant)] = _captured(lambda: ws.transform_with_hook(img, seeds))
            ws = _builder(variant, mesh, enable_debug=())
            out[("debug", shape, variant)] = _captured(lambda: ws.transform(img, seeds))
            plots = os.path.join(root, f"plots-{tag}-{variant}")
            os.makedirs(plots, exist_ok=True)
            ws = _builder(variant, mesh, set_plot_folder=(plots,), set_wlvl_hook=(_hook,), enable_progress=())
            out[("plots", shape, variant)] = _captured(lambda: ws.transform_with_hook(img, seeds))[0]
            ckpt = os.path.join(root, f"ckpt-{tag}-{variant}")

            def stop(ctx):
                if ctx.water_level == CKPT_STOP:
                    raise RuntimeError("interrupted")
                return _hook(ctx)

            try:
                _builder(variant, mesh, set_checkpoint=(ckpt, 2), set_wlvl_hook=(stop,)).transform_with_hook(img, seeds)
                stopped = False
            except RuntimeError:
                stopped = True
            resumed = _builder(variant, mesh, set_checkpoint=(ckpt, 2), set_wlvl_hook=(_hook,))
            out[("checkpoint", shape, variant)] = (stopped, sorted(os.listdir(ckpt)),
                                                   resumed.transform_with_hook(img, seeds))
            out[("ckpt transform", shape, variant)] = _builder(variant, mesh, set_checkpoint=(ckpt, 2)).transform(
                img, seeds)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_levels")
    return run_ranks(_rank_cases, 4, root, str(root)), root


def _every_rank(ranks, shape, key):
    res, _ = ranks
    got = [res[r][key] for r in range(shape[0] * shape[1])]
    return got


def _jax_mesh(shape=(2, 2)):
    ny, nx = shape
    return Mesh(np.asarray(jax.devices()[: ny * nx]).reshape(ny, nx), ("y", "x"))


def _fields(name):
    return _border_field() if name == "border" else _field(STEPPER_FIELDS[name])


@functools.lru_cache(maxsize=None)
def _jax_stepped(name, variant):
    """JAX's ``MeshLevelStepper`` at its default halo 4 on its 2 x 2 mesh:
    per level the labels and the rounds (a round is 4 global sweeps on
    every mesh, so the rounds do not depend on the mesh's shape)."""
    img, seeds = _fields(name)
    stepper = JaxStepper(_jax_mesh(), n_labels=len(seeds), merging=variant == "merging")
    dev_img, lab = stepper.prepare(img, paint_seeds(img.shape, seeds))
    planes, rounds = [], []
    for lvl in range(MAXLVL + 1):
        lab, n = stepper.step(dev_img, lab, lvl)
        planes.append(stepper.crop(lab))
        rounds.append(int(n))
    return np.stack(planes), rounds


def _single_history(img, seeds, variant):
    return np.stack([c for _, c in _builder(variant).transform_history(img, seeds)])


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", list(STEPPER_FIELDS))
@pytest.mark.parametrize("shape", MESHES)
def test_stepper_levels_and_rounds_match_jax(ranks, shape, name, variant):
    """``MeshLevelStepper``: every level's labels on every rank == the
    port's single-device history == JAX's stepper; the rounds of each level
    == JAX's at halo 4."""
    img, seeds = _fields(name)
    got = _every_rank(ranks, shape, ("stepper", shape, name, variant))
    planes, rounds = got[0]
    for p, r in got[1:]:
        np.testing.assert_array_equal(p, planes)
        assert r == rounds
    np.testing.assert_array_equal(planes, _single_history(img, seeds, variant))
    want_planes, want_rounds = _jax_stepped(name, variant)
    np.testing.assert_array_equal(planes, want_planes)
    assert rounds == want_rounds and min(rounds) >= 1


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("shape", MESHES)
def test_stepper_border_seed_merges_as_on_one_device(ranks, shape, variant):
    """The JAX mesh fault, in the level loop: on ``_border_field`` JAX's
    ``MeshLevelStepper`` keeps the border seed's label 3 apart at every
    level, JAX's single-device host loop merges it with label 2; the
    port's stepper equals the single-device loop on every mesh.
    Segmenting has no merge, so there the three agree."""
    img, seeds = _border_field()
    planes, rounds = _every_rank(ranks, shape, ("stepper", shape, "border", variant))[0]
    jws = getattr(JaxBuilder.default().set_max_water_lvl(MAXLVL).set_wlvl_hook(_hook).enable_progress(),
                  f"build_{variant}")()
    single = np.stack([c for _, c, _ in _captured(lambda: jws.transform_with_hook(img, seeds))[0]])
    np.testing.assert_array_equal(planes, single)
    jax_planes, jax_rounds = _jax_stepped("border", variant)
    assert rounds == jax_rounds
    if variant == "merging":
        assert (single[:, 0, 12] == single[:, 1, 12]).all() and (jax_planes[:, 0, 12] == 3).all()
        bad = np.argwhere((jax_planes != single).any(0))
        assert bad.tolist() == [[0, 12]]
    else:
        np.testing.assert_array_equal(jax_planes, single)


def _progress_text(err: str) -> str:
    return re.sub(r"\[\d\d:\d\d/\d\d:\d\d\]", "[t]", err)


def _debug_lines(out: str) -> list:
    return [line for line in out.splitlines() if line.startswith(("starting with", ">  Looped"))]


@functools.lru_cache(maxsize=None)
def _jax_loop(kind, variant):
    """JAX's mesh builder on its 2 x 2 mesh: ``(result, stdout, stderr)``."""
    img, seeds = _field(LOOP)
    mesh = _jax_mesh()
    if kind == "progress":
        ws = _builder(variant, mesh, jax_=True, set_wlvl_hook=(_hook,), enable_progress=())
        return _captured(lambda: ws.transform_with_hook(img, seeds))
    ws = _builder(variant, mesh, jax_=True, enable_debug=())
    return _captured(lambda: np.asarray(ws.transform(img, seeds)))


def _same_hooks(got, want):
    assert len(got) == len(want) == MAXLVL + 1
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[2] == w[2]
        np.testing.assert_array_equal(g[1], w[1])


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("shape", MESHES)
def test_host_loop_hooks_and_progress(ranks, shape, variant):
    """Hooks with progress on a mesh: every rank's hook results == the
    port's single-device host loop == JAX's mesh builder; rank 0's bar ==
    JAX's mesh bar (a tick a round), and no other rank writes one."""
    img, seeds = _field(LOOP)
    got = _every_rank(ranks, shape, ("progress", shape, variant))
    want = _builder(variant, set_wlvl_hook=(_hook,), enable_progress=())
    single = _captured(lambda: want.transform_with_hook(img, seeds))[0]
    jax_res, _, jax_err = _jax_loop("progress", variant)
    for r, (res, out, err) in enumerate(got):
        _same_hooks(res, single)
        _same_hooks(res, jax_res)
        assert out == ""
        assert _progress_text(err) == (_progress_text(jax_err) if r == 0 else "")
    assert f"water level {MAXLVL}/{MAXLVL}" in got[0][2]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("shape", MESHES)
def test_host_loop_debug(ranks, shape, variant):
    """Debug on a mesh: the labels == the single device's; rank 0 prints
    JAX's mesh lines (a level's loops are its rounds) and a summary a level;
    the other ranks print nothing."""
    img, seeds = _field(LOOP)
    got = _every_rank(ranks, shape, ("debug", shape, variant))
    jax_labels, jax_out, _ = _jax_loop("debug", variant)
    for r, (labels, out, err) in enumerate(got):
        np.testing.assert_array_equal(labels, _builder(variant).transform(img, seeds))
        np.testing.assert_array_equal(labels, jax_labels)
        if r == 0:
            assert _debug_lines(out) == _debug_lines(jax_out)
            assert out.count("[Performance Summary]") == MAXLVL + 1
        else:
            assert out == "" and err == ""


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("shape", MESHES)
def test_host_loop_plots(ranks, shape, variant, tmp_path):
    """Plots on a mesh: one PNG a level, written by rank 0 alone, with the
    bytes of the single device's; every rank's hook results are the single
    device's."""
    img, seeds = _field(LOOP)
    folder = tmp_path / "single"
    folder.mkdir()
    want = _builder(variant, set_plot_folder=(str(folder),), set_wlvl_hook=(_hook,), enable_progress=())
    single = _captured(lambda: want.transform_with_hook(img, seeds))[0]
    for res in _every_rank(ranks, shape, ("plots", shape, variant)):
        _same_hooks(res, single)
    plots = ranks[1] / f"plots-{shape[0]}x{shape[1]}-{variant}"
    names = sorted(os.listdir(plots))
    assert names == sorted(f"ws_lvl{i}.png" for i in range(MAXLVL + 1))
    assert all((plots / n).read_bytes() == (folder / n).read_bytes() for n in names)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("shape", MESHES)
def test_host_loop_checkpoint_resume(ranks, shape, variant):
    """Per-level checkpoints on a mesh: a hook interrupts every rank at
    level 5; rank 0 left one snapshot file; the resumed run starts after
    the level-4 snapshot and its hook views == the uninterrupted
    single-device run's from level 5; the transform after that == the
    single device's."""
    img, seeds = _field(LOOP)
    single = _builder(variant, set_wlvl_hook=(_hook,)).transform_with_hook(img, seeds)
    for stopped, files, resumed in _every_rank(ranks, shape, ("checkpoint", shape, variant)):
        assert stopped and len(files) == 1 and files[0].startswith("levels-")
        assert [r[0] for r in resumed] == list(range(CKPT_STOP, MAXLVL + 1))
        for g, w in zip(resumed, single[CKPT_STOP:]):
            assert g[0] == w[0] and g[2] == w[2]
            np.testing.assert_array_equal(g[1], w[1])
    for labels in _every_rank(ranks, shape, ("ckpt transform", shape, variant)):
        np.testing.assert_array_equal(labels, _builder(variant).transform(img, seeds))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("shape", MESHES)
def test_level_sweep_backend_final_labels(ranks, shape, variant):
    """``tiled_transform(backend='sweep')``: the per-level flood loop's
    final labels on every rank == the single device's."""
    img, seeds = _field(LOOP)
    want = run_levels_impl(img, paint_seeds(img.shape, seeds), max_water_level=MAXLVL, n_labels=len(seeds),
                           merging=variant == "merging", backend="sweep", device="cpu").numpy()
    for got in _every_rank(ranks, shape, ("sweep", shape, variant)):
        np.testing.assert_array_equal(got, want)


def test_jnp_tiled_relax_backend_is_queued(tmp_path):
    """JAX's jnp tiled relax engine (``backend='relax'``, ROADMAP queue 1
    item 13 (c)) serves: on a one-rank mesh it equals the single device, for
    merging with ``collect='none'`` only, as JAX's; an unknown backend and
    collect raise ValueError.  The name is historical: the test once held
    the engine queued, and keeps its name now that the engine serves."""
    from rustronomy_watershed_tpu_torch.parallel import tiled_transform

    img = torch.zeros((8, 8), dtype=torch.uint8)
    lab = torch.zeros((8, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="backend"):
        tiled_transform(img, lab, None, n_labels=1, max_water_level=5, backend="jnp")
    with pytest.raises(ValueError, match="collect"):
        tiled_transform(img, lab, None, n_labels=1, max_water_level=5, collect="counts")
    for backend in ("packed", "relax"):
        with pytest.raises(ValueError, match="merging supports collect='none' only"):
            tiled_transform(img, lab, None, n_labels=1, max_water_level=5, merging=True, collect="sizes",
                            backend=backend)
    with pytest.raises(ValueError, match="collect='claims'"):
        tiled_transform(img, lab, None, n_labels=1, max_water_level=5, collect="claims", backend="sweep")
    field, seeds = _field(LOOP)
    lab0 = torch.from_numpy(paint_seeds(field.shape, seeds))
    with one_rank_group(tmp_path) as mesh:
        for variant in VARIANTS:
            got = tiled_transform(torch.from_numpy(field), lab0, mesh, n_labels=len(seeds), max_water_level=MAXLVL,
                                  merging=variant == "merging", backend="relax")
            np.testing.assert_array_equal(got.numpy(), _builder(variant).transform(field, seeds))
