"""The stress scene of the PyTorch port against the JAX package's
``StressApp`` on the CPU, at the JAX test's sizes (96x96, terrain 48, 16
instances, ``tests/test_stress_app.py``), and the profiling helpers.

The port renders frames 1 and 31 with the JAX pallas backend's winners
and framebuffer bit for bit; the marker vertex stage is also held bit
for bit at full width (terrain 708, 10,000 instances)."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myrenderer_tpu import math3d as jmath3d
from myrenderer_tpu.app import stress as jstress
from myrenderer_tpu.ops import vertex_stage as jvs
from myrenderer_tpu_torch.app import stress as tstress
from myrenderer_tpu_torch.ops import vertex_stage as tvs
from myrenderer_tpu_torch.state import state_from_numpy
from myrenderer_tpu_torch.utils.profiling import FrameTimer, trace
from test_torch_demo import jax_state

torch.set_num_threads(1)

SIZE, TERRAIN, INSTANCES = 96, 48, 16
FRAMES = (1, 31)
# marker ids follow the terrain's 2 * 48 * 48 ids and its 2 * 128 slots
MARKER_IDS = (2 * TERRAIN * TERRAIN + 256,
              2 * TERRAIN * TERRAIN + 256 + INSTANCES)


def run_frames(app, frames=FRAMES):
    """{frame: (framebuffer f32, winner i32)} at each of ``frames``."""
    app.renderer.debug_winner = True
    out = {}
    for i in range(1, max(frames) + 1):
        app.tick()
        if i in frames:
            out[i] = (app.window.read_pixels(as_uint8=False),
                      np.asarray(app.draw.last_winners[0]))
    return out


@pytest.fixture(scope="module")
def jax_app_frames():
    app = jstress.StressApp(width=SIZE, height=SIZE, terrain_size=TERRAIN,
                            instances=INSTANCES, backend="pallas")
    return app, run_frames(app)


@pytest.fixture(scope="module")
def torch_frames():
    return run_frames(tstress.StressApp(SIZE, SIZE, TERRAIN, INSTANCES,
                                        device="cpu"))


@pytest.mark.parametrize("frame", FRAMES)
def test_stress_matches_jax(frame, jax_app_frames, torch_frames):
    jfb, jwin = jax_app_frames[1][frame]
    tfb, twin = torch_frames[frame]
    np.testing.assert_array_equal(jwin, twin)
    np.testing.assert_array_equal(jfb.view(np.int32), tfb.view(np.int32))


def test_triangle_budget():
    app = tstress.StressApp(SIZE, SIZE, TERRAIN, INSTANCES, device="cpu")
    assert app.triangles == TERRAIN * TERRAIN * 2 + INSTANCES
    with pytest.raises(ValueError, match="square"):
        tstress.StressApp(SIZE, SIZE, TERRAIN, 15, device="cpu")


@pytest.mark.parametrize("frame", FRAMES)
def test_markers_and_terrain_rendered(frame, torch_frames):
    fb, win = torch_frames[frame]
    marker = ((win >= MARKER_IDS[0]) & (win < MARKER_IDS[1]))
    assert int(marker.sum()) >= INSTANCES
    # a constant varying, interpolated: the marker color to rounding
    np.testing.assert_allclose(fb[marker], np.broadcast_to(
        np.float32(tstress.MARKER_COLOR), (int(marker.sum()), 4)),
        atol=1e-4)
    r, g, b = fb[..., 0], fb[..., 1], fb[..., 2]
    assert int(((r == g) & (g == b) & (r > 0.05)).sum()) > 400
    assert np.isfinite(fb).all()


def test_oracle_matches_jax_oracle():
    """The oracle backend on frame 1: the terrain's permuted producer
    resolves in array order, as the JAX oracle's does; winners and the
    framebuffer bit for bit (both batches are cull_mode "none")."""
    j = run_frames(jstress.StressApp(width=SIZE, height=SIZE,
                                     terrain_size=TERRAIN,
                                     instances=INSTANCES,
                                     backend="oracle"), (1,))
    t = run_frames(tstress.StressApp(SIZE, SIZE, TERRAIN, INSTANCES,
                                     device="cpu", backend="oracle"), (1,))
    assert len(t[1]) == 2
    np.testing.assert_array_equal(j[1][1], t[1][1])
    np.testing.assert_array_equal(np.asarray(j[1][0]).view(np.int32),
                                  np.asarray(t[1][0]).view(np.int32))


def test_state_from_numpy_renders_jax_stress_frame(jax_app_frames):
    """The JAX app's host state after frame 31 (camera transform,
    heightmaps, marker heights) loaded into a port app draws the JAX
    frame's winners through the Draw API."""
    japp, jframes = jax_app_frames
    app = tstress.StressApp(SIZE, SIZE, TERRAIN, INSTANCES, device="cpu")
    for inst in app.renderer.instances:        # wipe the port's own data
        for loc in inst.stores:
            inst.update_buffer(loc, np.zeros(inst.stores[loc].host.size,
                                             np.float32))
    app.renderer.debug_winner = True
    state_from_numpy(app.renderer, jax_state(japp.renderer))
    app.draw.begin()
    app.draw.clear(tstress.CLEAR_COLOR)
    app.draw.draw_surface(app.surface)
    app.draw.end()
    np.testing.assert_array_equal(np.asarray(app.draw.last_winners[0]),
                                  jframes[31][1])


def test_marker_vertex_stage_full_width():
    """The instanced marker draw at full width (30,000 vertices reading
    a 501,264-float heightmap row through ``binding_at``) gives the JAX
    package's clip positions and varyings bit for bit."""
    size, grid = 708, 100
    inst = grid * grid
    hm = np.random.default_rng(0).uniform(0, 1, size * size).astype(
        np.float32)
    world = (jmath3d.perspective(90, 1.0, 0.1, 424.8)
             @ jmath3d.look_at((70.0, 70.0, 40.0), (0, 0, 0),
                               (0, 1, 0))).astype(np.float32)
    vidx = np.tile(np.arange(3, dtype=np.int32), inst)
    dinst = np.repeat(np.arange(inst, dtype=np.int32), 3)
    iids = np.zeros(3 * inst, np.int32)

    class Registry:
        pipelines = []
        device = torch.device("cpu")

        def _register(self, pool, obj):
            pool.append(obj)
            return 0

    jpipe = jstress._instanced_marker_pipeline(Registry(), grid, size)
    tpipe = tstress._instanced_marker_pipeline(Registry(), grid, size)
    jclip, jvary = jax.jit(lambda w, h: jvs.run_vertex_stage(
        jpipe.vertex_fn, jnp.asarray(vidx), {}, w[None], jnp.asarray(iids),
        {0: h[None]}, draw_instances=jnp.asarray(dinst)))(world, hm)
    tris = tvs.run_vertex_stage(
        tpipe.vertex_fn, torch.from_numpy(vidx), {},
        torch.from_numpy(world)[None], torch.from_numpy(iids),
        {0: torch.from_numpy(hm)[None]},
        draw_instances=torch.from_numpy(dinst))
    for want, got in ((jclip, tris.clip), (jvary, tris.vary)):
        want = np.asarray(want).reshape(inst, 3, 4)
        np.testing.assert_array_equal(want.view(np.int32),
                                      got.numpy().view(np.int32))


def test_main_cli_on_cpu(tmp_path, capsys):
    out = tmp_path / "stress.png"
    tstress.main(["--device", "cpu", "--size", "32x32", "--terrain", "8",
                  "--instances", "4", "--frames", "2", "--time",
                  "--out", str(out)])
    text = capsys.readouterr().out
    assert "triangles/frame: 132" in text
    assert "ms/frame" in text and "Mtri/s" in text and "on cpu" in text
    assert out.exists()


class TestFrameTimer:
    def test_rolling_window(self, monkeypatch):
        clock = iter(np.arange(0.0, 10.0, 0.01))
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        ft = FrameTimer(window=4)
        assert np.isnan(ft.ms_per_frame)   # no samples yet
        for _ in range(8):
            ft.tick()
        assert len(ft.samples) == 4        # window capped
        assert ft.ms_per_frame == pytest.approx(10.0, rel=1e-6)
        assert ft.fps == pytest.approx(100.0, rel=1e-6)

    def test_first_tick_records_nothing(self):
        ft = FrameTimer()
        ft.tick()
        assert ft.samples == []
        assert np.isnan(ft.fps)


def test_trace_writes_chrome_trace(tmp_path):
    with trace(str(tmp_path)) as prof:
        torch.ones(64).add_(1.0)
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert any("add" in e.key for e in prof.key_averages())
