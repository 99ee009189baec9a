"""Row-band rendering of the PyTorch port against the JAX package's
multi-chip sharding on the CPU (the counterpart of test_parallel.py).

The JAX side runs on its 8 virtual CPU devices (conftest.py); the port's
mesh holds 8 CPU devices. Bands must give the JAX package's winners
exactly, its framebuffers by the goldens rule, and the port's own
single-device frames bit for bit. The last test holds K1 against its
plain version at a band offset on the card (marked ``cuda``)."""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myrenderer_tpu_torch as tmr
from myrenderer_tpu.app.demo import DemoApp as JaxDemoApp
from myrenderer_tpu.ops import raster_common as jrc
from myrenderer_tpu.ops import raster_pallas as jrp
from myrenderer_tpu.parallel import make_mesh as jax_make_mesh
from myrenderer_tpu.parallel import sharded_render_step as jax_step
from myrenderer_tpu_torch.app.demo import DemoApp
from myrenderer_tpu_torch.ops import raster, raster_cuda
from myrenderer_tpu_torch.ops import raster_common as trc
from myrenderer_tpu_torch.parallel import (Banded, Mesh, make_mesh,
                                           sharded_render_step)
from myrenderer_tpu_torch.utils.trisets import band_slivers
from test_raster_pallas import CFG, random_triangles
from test_torch_raster_common import assert_bits_equal, jax_setup_batch
from test_torch_sampling import render_quad
from test_torch_sequential import (SCENES, TORCH, assert_goldens_rule,
                                   render)

torch.set_num_threads(1)


def cpu_mesh(rows, tris=1):
    return make_mesh(rows * tris, rows=rows, tris=tris,
                     devices=["cpu"] * (rows * tris))


def torch_api(mesh):
    """The port's test API (test_torch_sequential.TORCH) with a mesh."""
    return types.SimpleNamespace(
        pkg=tmr, vertex_fn=TORCH.vertex_fn,
        renderer=lambda core, backend: tmr.Renderer(
            core, device="cpu", raster_backend=backend, mesh=mesh))


@pytest.mark.parametrize("backend", ["oracle", "tiles"])
@pytest.mark.parametrize("rows,tris", [(8, 1), (4, 2), (2, 4)])
def test_sharded_step_matches_jax_and_one_device(rows, tris, backend):
    H, W = 16 * rows, 128
    T = 24
    clip, vary = random_triangles(T, seed=3)
    fb = np.zeros((H, W, 4), np.float32)
    tiles = backend == "tiles"
    jstep = jax_step(jax_make_mesh(8, rows=rows, tris=tris), H, W,
                     return_winner=True, raster_cfg=CFG if tiles else None)
    jout, jwin = jstep(clip, vary, jnp.ones(T, bool), jnp.asarray(fb))

    args = (torch.from_numpy(np.array(clip)),
            torch.from_numpy(np.array(vary)),
            torch.ones(T, dtype=torch.bool), torch.from_numpy(fb))
    out, win = sharded_render_step(cpu_mesh(rows, tris), H, W,
                                   return_winner=True, tiles=tiles)(*args)
    assert isinstance(out, Banded) and len(out.bands) == rows
    assert all(b.shape == (H // rows, W, 4) for b in out.bands)
    np.testing.assert_array_equal(np.asarray(jwin), np.asarray(win))
    assert int((np.asarray(win) >= 0).sum()) > 0
    assert_goldens_rule(np.asarray(jout), np.asarray(out))

    one = sharded_render_step(make_mesh(devices=["cpu"]), H, W,
                              return_winner=True, tiles=tiles)
    out1, win1 = one(*args)
    assert len(out1.bands) == 1
    assert_bits_equal(np.asarray(out1), out.cpu())
    assert_bits_equal(np.asarray(win1), win.cpu())


jax_rasterize_packed = jax.jit(
    functools.partial(jrp.rasterize_packed, cfg=CFG),
    static_argnames=("height", "width", "vp_height"))


@pytest.mark.parametrize("y0", [0, 16, 40])
def test_rasterize_packed_band_matches_jax(y0):
    """A 24-row band of a 64x160 frame (y0 = 40 is not tile-aligned):
    the port's binning + K1's plain version against the JAX pass in
    interpret mode, bit for bit, and against the same rows of the
    port's whole frame."""
    VH, W, band = 64, 160, 24
    clip, vary = (np.array(a) for a in random_triangles(200, seed=2))
    packed, valid, bbox = (np.array(x) if not isinstance(x, tuple)
                           else tuple(np.array(c) for c in x)
                           for x in jax_setup_batch(
                               clip, vary, np.ones(200, bool), W, VH))
    depth = np.ones((band, W), np.float32)
    jd, jw, jnum, jden, jovf = jax_rasterize_packed(
        jnp.asarray(packed), jnp.asarray(valid),
        tuple(jnp.asarray(c) for c in bbox), height=band, width=W,
        depth=jnp.asarray(depth), y0=jnp.int32(y0), vp_height=VH)
    assert not bool(np.asarray(jovf).any())
    t_in = (torch.from_numpy(packed), torch.from_numpy(valid),
            tuple(torch.from_numpy(c) for c in bbox))
    td, tw, tnum, tden, tovf = raster.rasterize_packed(
        *t_in, band, W, depth=torch.from_numpy(depth), y0=y0, vp_height=VH)
    assert not bool(tovf)
    assert_bits_equal(jw, tw)
    assert_bits_equal(jd, td)
    assert_bits_equal(jnum, tnum)
    assert_bits_equal(jden, tden)
    assert int((tw >= 0).sum()) > 0

    fd, fw, fnum, fden, _fovf = raster.rasterize_packed(*t_in, VH, W)
    rows = slice(y0, y0 + band)
    assert_bits_equal(fw[rows], tw)
    assert_bits_equal(fd[rows], td)
    assert_bits_equal(fnum[:, rows], tnum)
    assert_bits_equal(fden[rows], tden)


@pytest.mark.parametrize("y0,band,base", [(0, 64, 0), (16, 24, 3)])
def test_rasterize_entry_points_match_jax(y0, band, base):
    """``raster.rasterize`` (setup done by the caller at the full frame
    height, ids from ``base``) and ``rasterize_visibility`` against the
    JAX package's, jitted with setup, in interpret mode."""
    VH, W, T = 64, 160, 120
    clip, vary = (np.array(a) for a in random_triangles(T, seed=5))
    valid = np.ones(T, bool)

    @functools.partial(jax.jit, static_argnames=("visibility",))
    def jax_pass(clip, vary, valid, visibility=False):
        tc = jrc.triangle_setup(clip, vary, valid, W, VH)
        if visibility:
            return jrp.rasterize_visibility(tc, VH, W, base_index=base,
                                            tri_clip=clip, cfg=CFG)
        return jrp.rasterize(tc, band, W, base_index=base, tri_clip=clip,
                             cfg=CFG, y0=y0, vp_height=VH)

    clip_t, vary_t = torch.from_numpy(clip), torch.from_numpy(vary)
    tc = trc.triangle_setup(clip_t, vary_t, torch.from_numpy(valid), W, VH)
    jd, jw, jnum, jden, jovf = jax_pass(clip, vary, valid)
    assert not bool(np.asarray(jovf).any())
    td, tw, tnum, tden, tovf = raster.rasterize(
        tc, band, W, base_index=base, tri_clip=clip_t, y0=y0, vp_height=VH)
    assert int((tw >= 0).sum()) > 0
    assert bool(tovf) == bool(np.asarray(jovf).any())
    for j, t in ((jw, tw), (jd, td), (jnum, tnum), (jden, tden)):
        assert_bits_equal(j, t)
    jd, jw = jax_pass(clip, vary, valid, visibility=True)
    td, tw = raster.rasterize_visibility(tc, VH, W, base_index=base,
                                         tri_clip=clip_t)
    assert_bits_equal(jw, tw)
    assert_bits_equal(jd, td)


@pytest.mark.parametrize("height,width,y0,x0", [(8, 12, 0, 0),
                                                (24, 160, 40, 0),
                                                (270, 33, 810, 16)])
def test_pixel_grids_offsets_match_jax(height, width, y0, x0):
    jpx, jpy = jrc.pixel_grids(height, width, y0=y0, x0=x0)
    tpx, tpy = trc.pixel_grids(height, width, y0=y0, x0=x0)
    assert_bits_equal(jpx, tpx.contiguous())
    assert_bits_equal(jpy, tpy.contiguous())


def test_band_binning_is_band_local():
    """Every record in a band's bins touches the band, out-of-band
    records are culled (at least T // 2 exclusions over 4 bands), and
    bin_bands gives each band bin_packed's bins, with no host sync."""
    H, W, bands = 64, 128, 4
    band = H // bands
    T = 60
    clip, vary = (torch.from_numpy(np.array(a))
                  for a in random_triangles(T, seed=11))
    tc = trc.triangle_setup(clip, vary, torch.ones(T, dtype=torch.bool),
                            W, H, "back")
    packed = trc.pack_coeffs_full(tc)
    bbox = raster.viewport_bbox(clip, W, H)
    minv, maxv = bbox[2].numpy(), bbox[3].numpy()
    setup_valid = tc.valid.numpy()
    batched = raster.bin_bands([(tc.valid, bbox, band, g * band)
                                for g in range(bands)], W)
    excluded = 0
    for g in range(bands):
        y0 = g * band
        binned = raster.bin_packed(packed, tc.valid, bbox, band, W, y0=y0)
        for a, b in zip(binned, batched[g]):
            assert torch.equal(a, b)
        index, starts, counts, overflow = binned
        assert not bool(overflow)
        index = index[:int(counts.sum())]
        ids = set(packed[index.long(), 16].long().tolist())
        in_band = setup_valid & (maxv >= y0) & (minv < y0 + band)
        assert ids, f"band {g} unexpectedly empty"
        assert ids <= set(np.nonzero(in_band)[0].tolist())
        excluded += int((~in_band & setup_valid).sum())
    assert excluded > T // 2


@pytest.fixture(scope="module")
def demo_frames():
    """Frames 1 and 2 of the 64x64 demo: the port on an 8-row mesh and
    on one device, and the JAX package on its 8-row mesh. Per frame:
    (framebuffer, winners) each."""
    apps = {"banded": DemoApp(64, 64, device="cpu", mesh=cpu_mesh(8)),
            "single": DemoApp(64, 64, device="cpu"),
            "jax": JaxDemoApp(width=64, height=64, backend="pallas",
                              mesh=jax_make_mesh(8, rows=8, tris=1))}
    out = {k: [] for k in apps}
    for _ in range(2):
        for name, app in apps.items():
            app.renderer.debug_winner = True
            fb = app.tick()
            out[name].append((fb, app.draw.last_winners))
    return apps, out


@pytest.mark.parametrize("frame", [1, 2])
def test_banded_demo_equals_single_device(frame, demo_frames):
    _apps, out = demo_frames
    fb_b, win_b = out["banded"][frame - 1]
    fb_1, win_1 = out["single"][frame - 1]
    assert isinstance(fb_b, Banded) and len(win_b) == len(win_1) == 1
    assert_bits_equal(np.asarray(fb_b), fb_1)
    assert_bits_equal(np.asarray(win_b[0]), win_1[0])


@pytest.mark.parametrize("frame", [1, 2])
def test_banded_demo_winners_equal_jax(frame, demo_frames):
    _apps, out = demo_frames
    fb_b, win_b = out["banded"][frame - 1]
    fb_j, win_j = out["jax"][frame - 1]
    np.testing.assert_array_equal(np.asarray(win_j[0]), np.asarray(win_b[0]))
    assert_goldens_rule(np.asarray(fb_j), np.asarray(fb_b))


def test_banded_demo_frame_stays_banded(demo_frames):
    apps, out = demo_frames
    fb = apps["banded"].window.framebuffer
    assert isinstance(fb, Banded) and fb.shape == (64, 64, 4)
    assert len(fb.bands) == 8
    assert all(b.shape == (8, 64, 4) and b.device.type == "cpu"
               for b in fb.bands)
    np.testing.assert_array_equal(apps["banded"].window.read_pixels(),
                                  apps["single"].window.read_pixels())


def test_renderer_without_mesh_adopts_a_banded_window():
    """A window a mesh renderer has drawn to is adopted by a renderer
    without a mesh: its banded frame is assembled on that device, and a
    frame drawn there without a clear loads it."""
    app = DemoApp(64, 64, device="cpu", mesh=cpu_mesh(4))
    app.tick()
    banded = app.window.framebuffer
    assert isinstance(banded, Banded) and len(banded.bands) == 4
    rend = tmr.Renderer(app.core, device="cpu")
    rend.adopt_window(app.window)
    fb = app.window.framebuffer
    assert isinstance(fb, torch.Tensor) and fb.shape == (64, 64, 4)
    assert_bits_equal(banded.cpu(), fb)
    draw = tmr.Draw.create(rend)
    draw.begin()
    draw.draw_surface(tmr.Surface.create_window_scene(
        rend, app.window, tmr.SceneNode.create(rend)))
    draw.end()
    assert_bits_equal(banded.cpu(), app.window.framebuffer)


@pytest.mark.parametrize("rows", [3, 8])
@pytest.mark.parametrize("scene", list(SCENES))
def test_banded_sequential_path_equals_single_device(scene, rows):
    """The sequential path (later clears, depth_write=False) in bands of
    16 and of 6 rows: the framebuffer and every pass's winners equal the
    single-device frame's bit for bit."""
    bfb, bwin, _ = render(torch_api(cpu_mesh(rows)), "auto", SCENES[scene])
    tfb, twin, _ = render(TORCH, "auto", SCENES[scene])
    assert len(bwin) == len(twin) > 1
    assert_bits_equal(tfb, bfb)
    for a, b in zip(twin, bwin):
        assert_bits_equal(a, b)


def test_fragment_ctx_through_banded_path():
    """A ctx-consuming fragment program (texture sampling) through the
    banded path: bit-equal to the single-device frame."""
    fb_b, win_b = render_quad(torch_api(cpu_mesh(8)), "auto", 64)
    fb_1, win_1 = render_quad(TORCH, "auto", 64)
    assert_bits_equal(fb_1, fb_b)
    assert_bits_equal(win_1, win_b)
    # the checker landed per pixel
    assert fb_b[int(0.22 * 64), int(0.22 * 64), 0] > 0.9


@pytest.mark.parametrize("case", ["not divisible", "oracle", "no rows"])
def test_plan_time_checks(case):
    height, backend = (60, "auto") if case == "not divisible" else \
        (64, "oracle" if case == "oracle" else "auto")
    mesh = cpu_mesh(8)
    if case == "no rows":
        mesh = Mesh(mesh.devices, ("x", "y"))
    core = tmr.Core(fixed_timestep=1.0 / 60.0)
    window = core.create_window(64, height, "t")
    rend = tmr.Renderer(core, device="cpu", raster_backend=backend,
                        mesh=mesh)
    rend.adopt_window(window)
    surf = tmr.Surface.create_window_scene(rend, window,
                                           tmr.SceneNode.create(rend))
    draw = tmr.Draw.create(rend)
    draw.begin()
    draw.draw_surface(surf)
    match = {"not divisible": "not divisible",
             "oracle": "requires the tile backend",
             "no rows": "needs a 'rows' axis"}[case]
    with pytest.raises(ValueError, match=match):
        draw.end()


def test_mesh_shape_must_match_devices():
    with pytest.raises(ValueError, match="mesh 3x2 != 8 devices"):
        make_mesh(8, rows=3, tris=2, devices=["cpu"] * 8)
    mesh = make_mesh(8, rows=4, tris=2, devices=["cpu"] * 8)
    assert mesh.shape == {"rows": 4, "tris": 2}
    assert mesh.axis_names == ("rows", "tris")
    assert len(mesh.band_devices()) == 4


def test_renderer_runs_on_the_meshs_first_device():
    mesh = make_mesh(devices=["cpu"] * 2)
    rend = tmr.Renderer(tmr.Core(), device="cpu", mesh=mesh)
    assert rend.device == mesh.first_device == torch.device("cpu")
    assert rend.mesh is mesh
    with pytest.raises(ValueError, match="unsupported device"):
        Mesh(np.array([[torch.device("meta")]], dtype=object))


def test_make_mesh_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()


def test_band_slivers_lie_in_the_last_band():
    H, W, y0 = 4320, 7680, 4320 - 270
    clip, vary = band_slivers(400, 7, H, W, y0)
    assert clip.shape == (400, 3, 4) and vary.shape == (400, 3, 4)
    ndc = clip[..., :2] / clip[..., 3:4]
    py = (1.0 - ndc[..., 1]) * H / 2.0
    assert (py > y0 - 1.0).all() and (py < H + 1.0).all()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_devices_resolve_with_their_index(cuda_device):
    """The renderer's device carries its index, as a tensor's does, so
    the upload caches keyed by device hit from the second frame on."""
    rend = tmr.Renderer(tmr.Core(), device="cuda")
    assert rend.device == torch.zeros(1, device="cuda").device
    assert make_mesh(devices=["cuda"]).first_device == rend.device


@pytest.mark.cuda
@pytest.mark.parametrize("set_name", ["random", "slivers"])
def test_k1_band_matches_plain_version_on_card(set_name, cuda_device):
    """K1 at y0 > 0 against its plain version on the card, bit for bit:
    random triangles in the third band of a 64x160 frame, and thin
    slivers in the last 270-row band of a 7680x4320 frame."""
    if set_name == "random":
        VH, W, band, y0 = 64, 160, 24, 40
        clip, vary = (np.array(a) for a in random_triangles(200, seed=2))
    else:
        VH, W, band, y0 = 4320, 7680, 270, 4320 - 270
        clip, vary = band_slivers(2000, 7, VH, W, y0)
    dev = cuda_device
    clip_t = torch.from_numpy(clip).to(dev)
    tc = trc.triangle_setup(clip_t, torch.from_numpy(vary).to(dev),
                            torch.ones(clip.shape[0], dtype=torch.bool,
                                       device=dev), W, VH, "none")
    packed = trc.pack_coeffs_full(tc)
    index, starts, counts, _overflow = raster.bin_packed(
        packed, tc.valid, raster.viewport_bbox(clip_t, W, VH), band, W,
        y0=y0)
    depth = torch.ones((band, W), device=dev)
    before = raster_cuda.K1.launches
    fused, winner = raster_cuda.rasterize_tiles(packed, index, starts,
                                                counts, depth, y0=y0,
                                                vp_height=VH)
    assert raster_cuda.K1.launches == before + 1
    rfused, rwinner = raster_cuda.rasterize_tiles_reference(
        packed, index, starts, counts, depth, y0=y0, vp_height=VH)
    assert int((rwinner >= 0).sum()) > 0
    assert torch.equal(winner, rwinner)
    assert torch.equal(fused.view(torch.int32), rfused.view(torch.int32))


def test_pre_kernel_stage_actually_partitions():
    """``tests/test_parallel.py``'s case of the same name: the vertex
    stage, setup and pack split over the mesh's devices. The port runs
    the pre-kernel stage once, on the mesh's first device."""
    pytest.skip("queue 1 item 4")
