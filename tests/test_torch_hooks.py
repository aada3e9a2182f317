"""The per-level observers of the port (models/base.py) against the JAX
package's: hook results (HookCtx views), progress and debug output, PNG
bytes, and a custom sweep, on the replay route (compact planes) and on the
host-stepped loop.  Integer views, tolerance 0."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustronomy_watershed_tpu.ops.flood import flood_sweep as j_flood_sweep
from rustronomy_watershed_tpu.prelude import TransformBuilder as JaxBuilder
from rustronomy_watershed_tpu_torch.ops.flood_block import make_sweep_fn
from rustronomy_watershed_tpu_torch.prelude import TransformBuilder, color_maps

torch.set_num_threads(1)

MAXLVL = 90


def _field(seed, shape=(22, 27)):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, MAXLVL, size=shape).astype(np.uint8)
    img[rng.random(shape) < 0.1] = 255
    return img


def _seeds(img):
    ws = TransformBuilder.default().set_device("cpu").build_segmenting()
    return ws.find_local_minima(img) + [(0, 4), (img.shape[0] - 1, 9)]


def _hook(ctx):
    return (ctx.water_level, ctx.max_water_level, ctx.colours.copy(), ctx.image.copy(), ctx.seeds)


def _builders(configure, edge, backend="auto"):
    jb = configure(JaxBuilder.default().set_max_water_lvl(MAXLVL))
    tb = configure(TransformBuilder.default().set_device("cpu").set_max_water_lvl(MAXLVL).set_backend(backend))
    if edge:
        jb.enable_edge_correction()
        tb.enable_edge_correction()
    return jb, tb


def _same_hook_results(got, want):
    assert len(got) == len(want) == MAXLVL + 1
    for g, w in zip(got, want):
        assert g[:2] == w[:2] and g[4] == w[4]
        assert g[2].dtype == np.int32 and g[3].dtype == np.uint8
        np.testing.assert_array_equal(g[2], w[2])
        np.testing.assert_array_equal(g[3], np.asarray(w[3]))


@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("backend", ["auto", "pallas"])
@pytest.mark.parametrize("variant", ["build_segmenting", "build_merging"])
def test_hook_results_match_jax(variant, backend, edge):
    img = _field(1)
    seeds = _seeds(img)
    jb, tb = _builders(lambda b: b.set_wlvl_hook(_hook), edge, backend)
    jws, tws = getattr(jb, variant)(), getattr(tb, variant)()
    _same_hook_results(tws.transform_with_hook(img, seeds), jws.transform_with_hook(img, seeds))
    np.testing.assert_array_equal(tws.transform(img, seeds), np.asarray(jws.transform(img, seeds)))


def _progress_text(err: str) -> str:
    return re.sub(r"\[\d\d:\d\d/\d\d:\d\d\]", "[t]", err)


@pytest.mark.parametrize("variant", ["build_segmenting", "build_merging"])
def test_progress_output_and_results_match_jax(variant, capsys):
    img = _field(2)
    seeds = _seeds(img)
    jb, tb = _builders(lambda b: b.set_wlvl_hook(_hook).enable_progress(), edge=False)
    want = getattr(jb, variant)().transform_with_hook(img, seeds)
    want_err = _progress_text(capsys.readouterr().err)
    got = getattr(tb, variant)().transform_with_hook(img, seeds)
    got_err = _progress_text(capsys.readouterr().err)
    _same_hook_results(got, want)
    assert got_err == want_err and f"water level {MAXLVL}/{MAXLVL}" in got_err
    # The replay route (no progress) gives the same views as the host loop.
    replay = getattr(tb.set_wlvl_hook(_hook), variant)()
    replay.progress = False
    _same_hook_results(replay.transform_with_hook(img, seeds), want)


def _debug_lines(out: str) -> list:
    return [line for line in out.splitlines() if line.startswith(("starting with", ">  Looped"))]


@pytest.mark.parametrize("variant", ["build_segmenting", "build_merging"])
def test_debug_output_matches_jax(variant, capsys):
    img = _field(3)
    seeds = _seeds(img)
    jb, tb = _builders(lambda b: b.enable_debug(), edge=True)
    want = np.asarray(getattr(jb, variant)().transform(img, seeds))
    want_out = capsys.readouterr().out
    got = getattr(tb, variant)().transform(img, seeds)
    got_out = capsys.readouterr().out
    np.testing.assert_array_equal(got, want)
    assert _debug_lines(got_out) == _debug_lines(want_out)
    assert got_out.count("[Performance Summary]") == MAXLVL + 1


@pytest.mark.parametrize("progress", [False, True])
@pytest.mark.parametrize("variant", ["build_segmenting", "build_merging"])
def test_plot_files_match_jax(variant, progress, tmp_path):
    img = _field(4)
    seeds = _seeds(img)
    outs = {}
    for name, builder in (("jax", JaxBuilder.default()), ("torch", TransformBuilder.default().set_device("cpu"))):
        folder = tmp_path / name
        folder.mkdir()
        builder.set_max_water_lvl(MAXLVL).set_plot_folder(str(folder)).enable_edge_correction()
        builder.set_plot_colour_map(color_maps.magma)
        if progress:
            builder.enable_progress()
        getattr(builder, variant)().transform_with_hook(img, seeds)
        outs[name] = {f: (folder / f).read_bytes() for f in sorted(os.listdir(folder))}
    assert sorted(outs["torch"]) == sorted(f"ws_lvl{i}.png" for i in range(MAXLVL + 1))
    assert outs["torch"] == outs["jax"]


def test_sweep_impl_and_lists_match_jax():
    img = _field(5)
    seeds = _seeds(img)
    j_sweep = lambda i, l, v: j_flood_sweep(jnp.asarray(i, jnp.int32), l, v)  # noqa: E731
    jws = JaxBuilder.default().set_max_water_lvl(MAXLVL).set_sweep_impl(j_sweep).set_wlvl_hook(_hook).build_merging()
    tws = (
        TransformBuilder.default().set_device("cpu").set_max_water_lvl(MAXLVL)
        .set_sweep_impl(make_sweep_fn(3)).set_wlvl_hook(_hook).build_merging()
    )
    _same_hook_results(tws.transform_with_hook(img, seeds), jws.transform_with_hook(img, seeds))
    # transform_to_list / transform_history through the host loop.
    for length in (None, len(seeds) + 1):
        for (lvl, row), (jlvl, jrow) in zip(
            tws.transform_to_list(img, seeds, counts_length=length),
            jws.transform_to_list(img, seeds, counts_length=length),
        ):
            assert lvl == jlvl
            np.testing.assert_array_equal(row, jrow)
    for (lvl, s), (jlvl, js) in zip(tws.transform_history(img, seeds), jws.transform_history(img, seeds)):
        assert lvl == jlvl
        np.testing.assert_array_equal(s, js)
