"""The content modules and the demo app of the PyTorch port against the
JAX package on the CPU: the cases of ``tests/test_content_demo.py``,
each with the JAX test's assertions, the same scene rendered through
both packages (the port's ``"oracle"`` for the JAX ``"oracle"``), winners
exact and framebuffers bit-equal; and the apps' command lines
(``--backend``, ``--gif``, the ``overflow=`` print and the stress CLI's
exit when its timed frames overflowed)."""

import numpy as np
import pytest
import torch

from myrenderer_tpu import math3d as jmath3d
from myrenderer_tpu.app.assets import default_heightmap as jdefault_heightmap
from myrenderer_tpu.app.demo import DemoApp as JaxDemoApp
from myrenderer_tpu.content import Polygon as JPolygon
from myrenderer_tpu.content import Terrain as JTerrain
from myrenderer_tpu.renderer import Surface as JSurface
from myrenderer_tpu_torch import math3d
from myrenderer_tpu_torch.app import demo as tdemo
from myrenderer_tpu_torch.app import stress as tstress
from myrenderer_tpu_torch.app.assets import default_heightmap
from myrenderer_tpu_torch.app.demo import (CLEAR_COLOR, POLYGON1, POLYGON2,
                                           DemoApp)
from myrenderer_tpu_torch.content import Polygon, Terrain
from myrenderer_tpu_torch.content.polygon import PALETTE
from myrenderer_tpu_torch.ops import raster
from myrenderer_tpu_torch.renderer import Surface
from myrenderer_tpu_torch.utils.scenes import make_renderer, render_frame
from test_render_e2e import make_renderer as jmake_renderer
from test_render_e2e import render_frame as jrender_frame

torch.set_num_threads(1)


def tmake_renderer(w=64, h=64, backend="oracle"):
    return make_renderer(w, h, backend=backend, device="cpu")


def test_default_heightmap_properties():
    hm = default_heightmap()
    assert hm.shape == (100, 100) and hm.dtype == np.uint16
    assert hm.min() >= 0 and hm.max() <= 65535
    assert np.array_equal(hm, default_heightmap())  # deterministic
    assert hm.std() > 2000                          # non-trivial relief
    np.testing.assert_array_equal(hm, jdefault_heightmap())


def test_terrain_node_structure():
    rend, _ = tmake_renderer()
    node = Terrain(rend).create_terrain(default_heightmap(16))
    inst = node.get_backing()
    assert inst.vertex_buffer.vertex_count == 16 * 16 * 6  # Terrain.zig:126
    assert not inst.vertex_buffer.has_buffer               # procedural
    np.testing.assert_allclose(node.bounding_box_p0, [-1.6, 0.0, -1.6])
    np.testing.assert_allclose(node.bounding_box_p1, [1.6, 5.0, 1.6])
    u = inst.stores[0].host.view(np.float32)
    np.testing.assert_array_equal(u[:16].reshape(4, 4), np.eye(4))
    assert u[16] == 16.0
    jrend, _ = jmake_renderer()
    jinst = JTerrain(jrend).create_terrain(jdefault_heightmap(16)) \
        .get_backing()
    for loc in (0, 1):
        np.testing.assert_array_equal(inst.stores[loc].host,
                                      jinst.stores[loc].host)


def render_flat_terrains(make, terrain_cls, m3d, render):
    """``test_terrain_renders_heights``'s two frames (flat heightmaps at
    heights 0.1 and 0.5, seen from above) and each frame's winners."""
    rend, window = make(96, 96)
    rend.debug_winner = True
    terr = terrain_cls(rend)
    out = []
    for h in (0.1, 0.5):
        node = terr.create_terrain(np.full((8, 8), h, np.float32))
        node.set_xform(m3d.look_at((4.0, 6.0, 0.0), (0, 0, 0), (0, 1, 0)))
        surf = (JSurface if terrain_cls is JTerrain else Surface) \
            .create_window_scene(rend, window, node)
        surf.set_perspective(m3d.perspective(90, 1.0, 0.1, 200))
        fb = render(rend, [surf], clear=(1.0, 0.0, 0.0, 1.0))
        out.append((fb, [np.asarray(w) for w in rend.draws[-1].last_winners]))
    return out


def test_terrain_renders_heights():
    """Flat heightmaps render as uniform color = 5h (Terrain.zig:73);
    higher terrain is taller (covers higher scanlines). Winners and the
    framebuffer equal the JAX package's (oracle)."""
    got = render_flat_terrains(tmake_renderer, Terrain, math3d, render_frame)
    want = render_flat_terrains(jmake_renderer, JTerrain, jmath3d,
                                jrender_frame)
    for (fb, win), (jfb, jwin) in zip(got, want):
        assert len(win) == len(jwin)
        for a, b in zip(win, jwin):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(fb.view(np.int32),
                                      np.asarray(jfb).view(np.int32))
    (fb, _), (fb_tall, _) = got
    covered = fb[..., 1] > 0.1
    assert covered.any()
    np.testing.assert_allclose(fb[covered][:, :3], 0.5, atol=1e-4)
    covered_tall = fb_tall[..., 1] > 0.1
    # raw float fb is unclamped: color = 5h = 2.5
    np.testing.assert_allclose(fb_tall[covered_tall][:, :3], 2.5, atol=1e-4)
    top_tall = np.nonzero(covered_tall.any(axis=1))[0].min()
    top_flat = np.nonzero(covered.any(axis=1))[0].min()
    assert top_tall < top_flat


def test_polygon_palette_cycling():
    rend, _ = tmake_renderer()
    h = Polygon(rend).create_polygon(POLYGON1)
    rows = h.vertex_buffer._staging
    assert rows.shape == (15, 5)
    for tri in range(5):
        for v in range(3):
            np.testing.assert_allclose(rows[tri * 3 + v, 2:5],
                                       PALETTE[tri % 4], atol=1e-6)
    jrend, _ = jmake_renderer()
    np.testing.assert_array_equal(
        rows, JPolygon(jrend).create_polygon(POLYGON1).vertex_buffer._staging)


def test_polygon_aabb_correct():
    rend, _ = tmake_renderer()
    node = Polygon(rend).create_polygon(POLYGON2).get_node()
    np.testing.assert_allclose(node.bounding_box_p0, [10.0, 10.0, 1.0])
    np.testing.assert_allclose(node.bounding_box_p1, [40.0, 40.0, 1.0])


def test_terrain_batch_vertex_path_matches_vmap():
    """The whole-stream terrain vertex function agrees with the
    per-vertex one (``test_terrain_batch_vertex_path_matches_vmap``):
    the batch's triangles, put back in submission order through its
    ``ids``, against the vmapped stage, to the JAX test's tolerances.
    (``test_torch_vertex_stage.py`` holds both to the JAX package's bits.)"""
    from myrenderer_tpu_torch.content.terrain import (_make_vertex_batch_fn,
                                                      _make_vertex_fn)
    from myrenderer_tpu_torch.ops import vertex_stage as vs
    size = 16
    dev = torch.device("cpu")
    hm = np.random.default_rng(0).random(size * size).astype(np.float32)
    uniform = np.concatenate([np.eye(4, dtype=np.float32).reshape(-1),
                              [np.float32(size)]])
    world = (math3d.perspective(1.2, 1.0, 0.1, 50.0)
             @ math3d.look_at((3, 4, 2), (0, 0, 0), (0, 1, 0)))
    V = size * size * 6
    vidx = torch.arange(V, dtype=torch.int32)
    iids = torch.zeros(V, dtype=torch.int32)
    worlds = torch.from_numpy(np.asarray(world, np.float32))[None]
    bindings = {0: torch.from_numpy(uniform)[None],
                1: torch.from_numpy(hm)[None]}
    per_vertex = vs.run_vertex_stage(_make_vertex_fn(size, dev), vidx, {},
                                     worlds, iids, bindings)
    batch = vs.run_vertex_stage(None, vidx, {}, worlds, iids, bindings,
                                vertex_batch_fn=_make_vertex_batch_fn(size,
                                                                      dev))
    assert batch.planar and per_vertex.ids is None
    order = torch.argsort(batch.ids)
    np.testing.assert_allclose(per_vertex.clip.numpy(),
                               batch.clip[order].numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(per_vertex.vary.numpy(),
                               batch.vary[order].numpy(), rtol=1e-6,
                               atol=1e-6)


class TestDemoScene:
    """``TestDemoScene``: DemoApp(128, 128, backend="oracle") frame 1, held
    to the JAX oracle frame (winners exact, framebuffer bit-equal), and
    the JAX test's assertions on it."""

    @pytest.fixture(scope="class")
    def frame(self):
        app = DemoApp(width=128, height=128, backend="oracle", device="cpu")
        app.renderer.debug_winner = True
        fb = app.run(1)
        japp = JaxDemoApp(width=128, height=128, backend="oracle")
        japp.renderer.debug_winner = True
        jfb = japp.run(1)
        return fb, app, (jfb, japp)

    def test_matches_jax_oracle(self, frame):
        fb, app, (jfb, japp) = frame
        assert app.renderer.raster_backend == "oracle"
        assert len(app.draw.last_winners) == len(japp.draw.last_winners) == 2
        for a, b in zip(app.draw.last_winners, japp.draw.last_winners):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(fb.view(np.int32),
                                      np.asarray(jfb).view(np.int32))

    def test_clear_color_visible(self, frame):
        fb, _app, _ = frame
        np.testing.assert_allclose(fb[2, 125], CLEAR_COLOR, atol=1e-5)

    def test_square_polygon_position(self, frame):
        fb, _app, _ = frame
        ui = lambda x: int(x / 200 * 128)  # noqa: E731
        mint = np.array([*PALETTE[1], 1.0])
        purple = np.array([*PALETTE[0], 1.0])
        for px in (fb[ui(15), ui(20)], fb[ui(25), ui(25)]):
            assert (np.allclose(px, mint, atol=1e-4)
                    or np.allclose(px, purple, atol=1e-4))

    def test_heptagon_covered_by_palette(self, frame):
        fb, _app, _ = frame
        ui = lambda x: int(x / 200 * 128)  # noqa: E731
        px = fb[ui(100), ui(105)]
        assert any(np.allclose(px, np.array([*c, 1.0]), atol=1e-4)
                   for c in PALETTE), px

    def test_terrain_visible_below_horizon(self, frame):
        fb, _app, _ = frame
        px = fb[120, 64]
        assert px[0] == px[1] == px[2]
        assert not np.allclose(px, CLEAR_COLOR, atol=1e-3)

    def test_frame_deterministic(self, frame):
        fb, _app, _ = frame
        fb2 = DemoApp(width=128, height=128, backend="oracle",
                      device="cpu").run(1)
        np.testing.assert_array_equal(fb, fb2)

    def test_camera_orbits(self, frame):
        fb, app, _ = frame
        fb5 = app.run(5)  # elapsed_time advances -> different view
        assert not np.array_equal(fb, fb5)


def test_demo_app_backend():
    """``DemoApp(backend=...)`` reaches the renderer: the oracle frame
    runs the sequential passes, one a batch, covers the tile frame's
    pixels and meets the goldens rule against it. (Frame-wide ids differ
    in the terrain batch: its whole-stream vertex function emits
    triangles out of submission order, and the oracle numbers them in
    array order, as the JAX oracle does.)"""
    apps = {be: DemoApp(width=48, height=32, backend=be, device="cpu")
            for be in ("auto", "oracle")}
    for be, app in apps.items():
        app.renderer.debug_winner = app.renderer.collect_stats = True
        app.tick()
        assert app.renderer.frame_stats["backend"] == \
            {"auto": "tile", "oracle": "oracle"}[be]
    owin = [w.numpy() for w in apps["oracle"].draw.last_winners]
    (twin,) = [w.numpy() for w in apps["auto"].draw.last_winners]
    assert len(owin) == 2
    np.testing.assert_array_equal(twin >= 0, (owin[0] >= 0) | (owin[1] >= 0))
    assert_goldens_rule(*(app.window.read_pixels() for app in apps.values()))


def assert_goldens_rule(got, want):
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1
    assert (diff == 0).mean() > 0.999


def test_demo_gif_cli(tmp_path, capsys):
    """``--gif`` writes an animated GIF of the orbit, every ``--frames``
    frame at the app's fixed step (the JAX test's CLI call, on the CPU
    at a smaller size)."""
    out = tmp_path / "orbit.gif"
    tdemo.main(["--device", "cpu", "--size", "48x48", "--frames", "3",
                "--backend", "oracle", "--gif", str(out)])
    assert f"wrote {out} (3 frames)" in capsys.readouterr().out
    from PIL import Image
    im = Image.open(out)
    assert im.n_frames == 3 and im.size == (48, 48)
    im.seek(0)
    first = np.asarray(im.convert("RGB")).copy()
    assert im.info["duration"] == 20       # max(20, 1000 / 60) ms
    im.seek(2)
    third = np.asarray(im.convert("RGB"))
    assert (first != third).any()     # the camera actually orbits


def test_demo_time_prints_overflow(capsys):
    tdemo.main(["--device", "cpu", "--size", "32x32", "--frames", "2",
                "--time"])
    text = capsys.readouterr().out
    assert "1 frames:" in text and "overflow=[False, False] on cpu" in text


def test_stress_cli_backend(capsys):
    tstress.main(["--device", "cpu", "--size", "32x32", "--terrain", "8",
                  "--instances", "4", "--frames", "1", "--backend", "oracle",
                  "--time"])
    text = capsys.readouterr().out
    assert "triangles/frame: 132" in text
    assert "overflow=[False, False] on cpu" in text
    with pytest.raises(SystemExit):
        tstress.main(["--device", "cpu", "--backend", "pallas"])


def test_starved_stress_loop_exits(monkeypatch, capsys):
    """A pair capacity the ladder cannot outgrow (1 slot at big scale 1,
    256 at its top, for about 600 pairs): the timed frames overflow, the
    CLI prints the flag beside ms/frame and exits through SystemExit, as
    the JAX stress CLI does."""
    monkeypatch.setattr(raster, "_FORCE_PAIR_CAPACITY", 1)
    with pytest.raises(SystemExit, match="OVERFLOW"):
        tstress.main(["--device", "cpu", "--size", "48x48", "--terrain",
                      "12", "--instances", "4", "--frames", "2", "--time"])
    text = capsys.readouterr().out
    assert "ms/frame" in text and "overflow=[True, False]" in text
