"""The slice end to end: the PyTorch port's demo frame (terrain + two
polygons, merged one-pass frame) against the golden PNGs and against
the JAX package's DemoApp (pallas backend, interpret mode on the CPU).
Winners must be exact and the framebuffers bit-equal."""

import os

import numpy as np
import pytest
import torch

from myrenderer_tpu.app.demo import DemoApp as JaxDemoApp
from myrenderer_tpu_torch import math3d
from myrenderer_tpu_torch.app.demo import CLEAR_COLOR, DemoApp
from myrenderer_tpu_torch.renderer import Draw, Surface
from myrenderer_tpu_torch.state import state_from_numpy
from myrenderer_tpu_torch.utils.png import load_rgba8

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
FRAMES = (1, 31)


def run_frames(app, frames):
    """{frame: (rgba uint8, framebuffer f32, winner i32)} at each of
    ``frames`` (1-based)."""
    app.renderer.debug_winner = True
    out = {}
    for i in range(1, max(frames) + 1):
        app.tick()
        if i in frames:
            out[i] = (app.window.read_pixels(),
                      app.window.read_pixels(as_uint8=False),
                      np.asarray(app.draw.last_winners[0]))
    return out


@pytest.fixture(scope="module")
def frames_jax():
    app = JaxDemoApp(width=128, height=128, backend="pallas")
    return app, run_frames(app, FRAMES)


@pytest.fixture(scope="module")
def frames_torch():
    app = DemoApp(width=128, height=128, device="cpu")
    return app, run_frames(app, FRAMES)


def assert_goldens_rule(got, want):
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1
    assert (diff == 0).mean() > 0.999


@pytest.mark.parametrize("frame", FRAMES)
def test_demo_frame_golden(frame, frames_torch):
    want = load_rgba8(os.path.join(GOLDEN_DIR,
                                   f"demo_128_frame{frame}.png"))
    assert_goldens_rule(frames_torch[1][frame][0], want)


@pytest.mark.parametrize("frame", FRAMES)
def test_demo_matches_jax(frame, frames_jax, frames_torch):
    jrgba, jfb, jwin = frames_jax[1][frame]
    trgba, tfb, twin = frames_torch[1][frame]
    np.testing.assert_array_equal(jwin, twin)
    assert int((twin >= 0).sum()) > 9000
    # polygon ids sit after the terrain's 20000 + 2 * 128 ids
    assert twin.max() >= 20256
    assert_goldens_rule(trgba, jrgba)
    np.testing.assert_array_equal(jfb.view(np.int32), tfb.view(np.int32))


def jax_state(rend):
    """The JAX renderer's host state as state_from_numpy's dict (read
    only: vertex buffers are read without map(), which would bump their
    version)."""
    nodes = rend.scene_nodes
    state = {
        "node.xform": np.stack([n.xform for n in nodes]).astype(np.float32),
        "node.aabb_p0": np.stack([n.bounding_box_p0 for n in nodes]),
        "node.aabb_p1": np.stack([n.bounding_box_p1 for n in nodes]),
    }
    for i, inst in enumerate(rend.instances):
        for loc, store in inst.stores.items():
            state[f"instance{i}.binding{loc}"] = store.host.copy()
        if inst.vertex_buffer.has_buffer:
            state[f"instance{i}.vertices"] = \
                inst.vertex_buffer._staging.copy()
    return state


def test_state_from_numpy_renders_jax_frame(frames_jax):
    """Load the JAX renderer's state after frame 31 into a port demo
    built from another heightmap, draw one frame through the Draw API
    (no tick: the camera comes from the loaded transforms), and get the
    JAX frame's winners."""
    japp, jframes = frames_jax
    app = DemoApp(width=128, height=128, device="cpu",
                  heightmap=np.zeros((100, 100), np.float32))
    app.renderer.debug_winner = True
    state_from_numpy(app.renderer, jax_state(japp.renderer))
    draw = app.draw
    draw.begin()
    draw.clear(CLEAR_COLOR)
    draw.draw_surface(app.surface3d)
    draw.draw_surface(app.surface2d)
    draw.end()
    np.testing.assert_array_equal(np.asarray(draw.last_winners[0]),
                                  jframes[31][2])


def test_state_from_numpy_checks_structure(frames_jax):
    app = DemoApp(width=32, height=32, device="cpu")
    state = jax_state(frames_jax[0].renderer)
    state["node.xform"] = state["node.xform"][:2]
    with pytest.raises(ValueError, match="node.xform"):
        state_from_numpy(app.renderer, state)


def later_surface_frame(app, draw_cls, surface_cls, math3d_mod):
    """Draw the demo's terrain, then a later surface over the 2D root
    that clears first: the sequential frame path. Returns (framebuffer,
    winners per pass) as numpy."""
    app.renderer.debug_winner = True
    extra = surface_cls.create_window_scene(app.renderer, app.window,
                                            app.base_2d_node)
    extra.set_perspective(math3d_mod.projection_2d(
        left=0.0, right=200.0, bottom=200.0, top=0.0, near=0.1, far=200.0))
    draw = draw_cls.create(app.renderer)
    draw.begin()
    draw.clear(CLEAR_COLOR)
    draw.draw_surface(app.surface3d)
    draw.clear((0.0, 0.0, 0.0, 1.0))
    draw.draw_surface(extra)
    draw.end()
    return (app.window.read_pixels(as_uint8=False),
            [np.asarray(w) for w in draw.last_winners])


def test_sequential_frame_matches_jax():
    """A later surface that clears takes the sequential frame path (one
    raster pass per batch): winners of every pass exact and the
    framebuffer bit-equal against the JAX package (pallas backend)."""
    from myrenderer_tpu import math3d as jmath3d
    from myrenderer_tpu.renderer import Draw as JDraw, Surface as JSurface
    jfb, jwin = later_surface_frame(
        JaxDemoApp(width=32, height=32, backend="pallas"), JDraw, JSurface,
        jmath3d)
    tfb, twin = later_surface_frame(DemoApp(width=32, height=32,
                                            device="cpu"),
                                    Draw, Surface, math3d)
    assert len(twin) == len(jwin) == 2
    for j, t in zip(jwin, twin):
        np.testing.assert_array_equal(j, t)
    assert int((twin[1] >= 0).sum()) > 0
    np.testing.assert_array_equal(jfb.view(np.int32), tfb.view(np.int32))
