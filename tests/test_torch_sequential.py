"""The sequential frame path, the oracle backend and the clip-capacity
ladder of the PyTorch port against the JAX package on the CPU.

Scenes are built the same way in both packages from numpy inputs made
from a seed: frames where a later surface clears, where a pipeline does
not write depth, or both. The port's tile backend must give the JAX
pallas backend's (interpret mode) winners per pass and its framebuffer
bit for bit; the port's oracle must give the JAX oracle's winners and
framebuffer bit for bit, and the same winners as the port's tile
backend."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myrenderer_tpu as jmr
import myrenderer_tpu_torch as tmr
from myrenderer_tpu_torch.ops.vertex_stage import matvec4
from myrenderer_tpu_torch.renderer import draw as tdraw
from myrenderer_tpu_torch.utils.trisets import random_triangles

torch.set_num_threads(1)

SIZE = 48
CLEAR = (0.0, 0.0, 1.0, 1.0)
LATER_CLEAR = (0.2, 0.1, 0.0, 1.0)


def jax_vertex_fn(ctx):
    p = ctx.attr("pos")
    c = ctx.attr("color")
    clip = ctx.world @ jnp.stack([p[0], p[1], p[2], jnp.float32(1.0)])
    return clip, jnp.stack([c[0], c[1], c[2], jnp.float32(1.0)])


def torch_vertex_fn(ctx):
    p = ctx.attr("pos")
    c = ctx.attr("color")
    one = torch.ones((), dtype=torch.float32)
    return (matvec4(ctx.world, torch.stack([p[0], p[1], p[2], one])),
            torch.stack([c[0], c[1], c[2], one]))


JAX = types.SimpleNamespace(pkg=jmr, vertex_fn=jax_vertex_fn,
                            renderer=lambda core, backend: jmr.Renderer(
                                core, raster_backend=backend))
TORCH = types.SimpleNamespace(pkg=tmr, vertex_fn=torch_vertex_fn,
                              renderer=lambda core, backend: tmr.Renderer(
                                  core, device="cpu",
                                  raster_backend=backend))


def triangle_rows(n, seed, dup=0):
    """[3n, 6] vertex rows (x, y, z, r, g, b) of random triangles over
    the unit square, half of them clockwise; ``dup`` repeats the first
    triangles (exact depth ties)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-0.1, 1.1, (n, 3, 2))
    z = rng.uniform(0.2, 1.8, (n, 3, 1))
    col = rng.uniform(0.0, 1.0, (n, 3, 3))
    rows = np.concatenate([pos, z, col], -1).astype(np.float32)
    rows = np.concatenate([rows, rows[:dup]])
    return rows.reshape(-1, 6)


# scene: per surface (clear before it?, [(pipeline, n, seed, dup), ...]);
# pipelines: "flat" (defaults), "nocull" (cull none), "nodepth"
# (depth_write=False, cull none)
SCENES = {
    "later surface clears": [
        (True, [("nocull", 40, 1, 6), ("flat", 30, 2, 0)]),
        (True, [("flat", 30, 3, 4)]),
        (False, [("nocull", 12, 4, 0)]),
    ],
    "depth_write off": [
        (True, [("nodepth", 40, 5, 6), ("nocull", 30, 6, 3),
                ("nodepth", 20, 7, 0), ("flat", 30, 8, 0)]),
    ],
    "both": [
        (True, [("nocull", 30, 9, 0)]),
        (True, [("nodepth", 30, 10, 5), ("nocull", 30, 11, 0)]),
    ],
}


def build_scene(api, backend, scene):
    pkg = api.pkg
    core = pkg.Core(fixed_timestep=1.0 / 60.0)
    window = core.create_window(SIZE, SIZE, "sequential")
    rend = api.renderer(core, backend)
    rend.adopt_window(window)
    rend.debug_winner = True
    layout = pkg.VertexLayout.create([("pos", 3), ("color", 3)])
    kinds = {"flat": {}, "nocull": {"cull_mode": "none"},
             "nodepth": {"cull_mode": "none", "depth_write": False}}
    pipes = {k: pkg.Pipeline.create(
        rend, vertex_fn=api.vertex_fn,
        bindings=[pkg.BindingLayout(0, pkg.renderer.BUILTIN_TRANSFORM)],
        vertex_layout=layout, **kw) for k, kw in kinds.items()}
    surfaces = []
    for clear, items in scene:
        root = pkg.SceneNode.create(rend)
        for kind, n, seed, dup in items:
            rows = triangle_rows(n, seed, dup)
            vb = pkg.VertexBuffer.new(rend, 0, rows.shape[0] // 3, layout)
            vb.write_vertices(rows)
            node = pkg.Instance.create_node(
                rend, pipeline=pipes[kind], bounding_box_p0=(-1, -1, 0),
                bounding_box_p1=(2, 2, 2))
            node.get_backing().set_vertex_buffer(vb)
            root.add_child(node)
        surf = pkg.Surface.create_window_scene(rend, window, root)
        surf.set_perspective(pkg.math3d.projection_2d(
            left=0.0, right=1.0, bottom=1.0, top=0.0, near=0.1, far=2.0))
        surfaces.append((clear, surf))
    return rend, window, surfaces


def render(api, backend, scene, stats=False):
    """One frame of ``scene``; returns (framebuffer f32, [winner i32 per
    raster pass], frame_stats)."""
    rend, window, surfaces = build_scene(api, backend, scene)
    rend.collect_stats = stats
    draw = api.pkg.Draw.create(rend)
    draw.begin()
    for i, (clear, surf) in enumerate(surfaces):
        if clear:
            draw.clear(CLEAR if i == 0 else LATER_CLEAR)
        draw.draw_surface(surf)
    draw.end()
    return (window.read_pixels(as_uint8=False),
            [np.asarray(w) for w in draw.last_winners], rend.frame_stats)


def assert_goldens_rule(a, b):
    qa = np.clip(np.rint(a * 255.0), 0, 255).astype(int)
    qb = np.clip(np.rint(b * 255.0), 0, 255).astype(int)
    diff = np.abs(qa - qb)
    assert diff.max() <= 1
    assert (diff == 0).mean() > 0.999


def assert_winners_equal(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)


def n_batches(scene):
    return sum(len(items) for _clear, items in scene)


@pytest.mark.parametrize("scene", list(SCENES))
def test_tile_matches_jax_pallas(scene):
    jfb, jwin, _ = render(JAX, "pallas", SCENES[scene])
    tfb, twin, _ = render(TORCH, "auto", SCENES[scene])
    assert len(twin) == n_batches(SCENES[scene])
    assert_winners_equal(jwin, twin)
    assert all(int((w >= 0).sum()) > 100 for w in twin)
    np.testing.assert_array_equal(jfb.view(np.int32), tfb.view(np.int32))


@pytest.mark.parametrize("scene", list(SCENES))
def test_oracle_matches_jax_oracle(scene):
    """Winners and the framebuffer bit for bit, cull_mode "none"
    batches included (their varying denominator plane takes the JAX
    oracle's own rounding form, ``raster_common.triangle_setup``)."""
    jfb, jwin, _ = render(JAX, "oracle", SCENES[scene])
    tfb, twin, _ = render(TORCH, "oracle", SCENES[scene])
    assert_winners_equal(jwin, twin)
    np.testing.assert_array_equal(jfb.view(np.int32), tfb.view(np.int32))


@pytest.mark.parametrize("scene", list(SCENES))
def test_oracle_matches_tile(scene):
    _, owin, _ = render(TORCH, "oracle", SCENES[scene])
    _, twin, _ = render(TORCH, "auto", SCENES[scene])
    assert_winners_equal(owin, twin)


def test_depth_write_off_keeps_depth_buffer():
    """A depth_write=False batch leaves the surface's depth buffer as it
    was: the same triangle drawn again by a depth-writing batch passes
    the 'less' test at every pixel the first one covered."""
    scene = [(True, [("nodepth", 1, 0, 0), ("nocull", 1, 0, 0)])]
    _fb, (first, second), _ = render(TORCH, "auto", scene)
    assert int((first >= 0).sum()) > 100
    np.testing.assert_array_equal(first, second)


def test_frame_stats():
    """The JAX package's frame_stats keys, its capacity machinery's
    (big_scale, overflow_risk_frames) included; the same counts."""
    scene = SCENES["later surface clears"]
    *_, jstats = render(JAX, "pallas", scene, stats=True)
    *_, tstats = render(TORCH, "auto", scene, stats=True)
    assert set(tstats) == set(jstats)
    for key in ("frame", "surfaces", "batches", "triangles_submitted",
                "merged", "fragment_programs", "big_scale",
                "overflow_risk_frames"):
        assert tstats[key] == jstats[key], key
    assert tstats["backend"] == "tile" and tstats["big_scale"] == 1
    assert tstats["overflow_risk_frames"] == 0
    assert tstats["ms_since_last_end"] is None
    assert tstats["batches"] == 4 and not tstats["merged"]
    *_, ostats = render(TORCH, "oracle", SCENES["depth_write off"],
                        stats=True)
    assert ostats["backend"] == "oracle" and ostats["batches"] == 4


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="raster backend"):
        render(TORCH, "vulkan", SCENES["both"])


# --------------------------------------------------------------------------
# the clip-capacity ladder
# --------------------------------------------------------------------------

STRADDLERS = 760        # triangles, of which about 200 straddle


def straddler_scene(api, backend):
    """One batch of random clip-space triangles, many straddling the
    eye plane; the vertex function passes clip positions through."""
    pkg = api.pkg
    clip, vary = random_triangles(STRADDLERS, 21, w_range=(-0.5, 5.0),
                                  mixed_winding=True)
    core = pkg.Core(fixed_timestep=1.0 / 60.0)
    window = core.create_window(SIZE, SIZE, "straddlers")
    rend = api.renderer(core, backend)
    rend.adopt_window(window)
    rend.debug_winner = True
    layout = pkg.VertexLayout.create([("clip", 4), ("color", 4)])
    pipe = pkg.Pipeline.create(
        rend, vertex_fn=lambda ctx: (ctx.attr("clip"), ctx.attr("color")),
        bindings=[pkg.BindingLayout(0, pkg.renderer.BUILTIN_TRANSFORM)],
        vertex_layout=layout, cull_mode="none")
    vb = pkg.VertexBuffer.new(rend, 0, STRADDLERS, layout)
    vb.write_vertices(np.concatenate([clip, vary], -1).reshape(-1, 8))
    node = pkg.Instance.create_node(rend, pipeline=pipe)
    node.get_backing().set_vertex_buffer(vb)
    surf = pkg.Surface.create_window_scene(rend, window, node)
    surf.set_perspective(pkg.math3d.identity())
    draw = pkg.Draw.create(rend)
    draw.begin()
    draw.clear(CLEAR)
    draw.draw_surface(surf)
    draw.end()
    w = clip[..., 3]
    n_straddle = int(((w > 1e-6).any(-1) & (w <= 1e-6).any(-1)).sum())
    return (draw, window.read_pixels(as_uint8=False),
            np.asarray(draw.last_winners[0]), n_straddle)


def test_clip_ladder_renders_what_the_reference_renders():
    """About 200 eye-plane straddlers in one batch: more than the
    clip capacity of 128. The frame's clip flag raises the port's
    big_scale x4 and the frame renders again, as the JAX package raises
    its big_scale; both then reserve 2 * 128 * 4 straddler ids, so
    winners compare equal."""
    tdraw_, tfb, twin, n = straddler_scene(TORCH, "auto")
    jdraw_, jfb, jwin, _ = straddler_scene(JAX, "pallas")
    assert tdraw.CLIP_CAPACITY < n <= 4 * tdraw.CLIP_CAPACITY
    assert tdraw_.big_scale == 4
    assert jdraw_._big_scale == 4 * 1       # both scales start at 1
    assert not bool(tdraw_.last_overflow.any())
    np.testing.assert_array_equal(jwin, twin)
    assert int((twin >= STRADDLERS).sum()) > 0   # clipped fragments won
    np.testing.assert_array_equal(jfb.view(np.int32), tfb.view(np.int32))


def test_clip_ladder_stops_at_its_top(monkeypatch):
    """At BIG_SCALE_MAX the ladder stops, as the reference's does: the
    frame publishes with its clip flag set (the straddlers past the
    capacity dropped) and frame_stats reports the unbounded risk."""
    monkeypatch.setattr(tdraw, "BIG_SCALE_MAX", 1)
    draw, _fb, win, n = straddler_scene(TORCH, "auto")
    assert n > tdraw.CLIP_CAPACITY and draw.big_scale == 1
    assert np.asarray(draw.last_overflow).tolist() == [False, True]
    draw.renderer.collect_stats = True
    draw.renderer.update()
    draw.begin()
    draw.clear(CLEAR)
    draw.draw_surface(draw.renderer.surfaces[0])
    draw.end()
    assert draw.renderer.frame_stats["overflow_risk_frames"] == -1
