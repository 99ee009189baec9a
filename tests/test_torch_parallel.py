"""Row-band rendering of the PyTorch port against the JAX package's
multi-chip sharding on the CPU (the counterpart of test_parallel.py).

The JAX side runs on its 8 virtual CPU devices (conftest.py); the port's
mesh holds 8 CPU devices, or fewer for the other mesh shapes. Bands
must give the JAX package's winners exactly, its framebuffers by the
goldens rule, and the port's own single-device frames bit for bit. A
mesh frame shards the pre-kernel stage over the mesh's rows and gathers
the records to every band: its pack is checked to split, its straddler
merge against ``select_straddlers``. The tests marked ``cuda`` hold K1
against its plain version at a band offset and the mesh frame's
segmented CUDA graphs against its eager frame on the card."""

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
from myrenderer_tpu_torch.parallel.sharding import shard_ranges
from myrenderer_tpu_torch.renderer import draw as tdraw
from myrenderer_tpu_torch.utils.trisets import band_slivers
from myrenderer_tpu_torch.utils.trisets import \
    random_triangles as tri_random
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


def test_pre_kernel_stage_actually_partitions(monkeypatch):
    """``tests/test_parallel.py``'s case of the same name: on a mesh of 8
    rows the 64x64 demo's terrain batch (20,000 triangles) is packed in 8
    pieces of about T / 8 rows (within 64, as the JAX test allows), piece
    k on band k's device, no pack holds the whole batch, and every
    band's raster pass receives the full gathered table (T + 2 * 128
    clip slots a batch)."""
    packs, passes = [], []
    orig_pack, orig_bands = trc.pack_coeffs_full, raster.rasterize_bands

    def pack(tc, *args, **kw):
        out = orig_pack(tc, *args, **kw)
        packs.append((out.shape[0], out.device))
        return out

    def bands(packed, valid, bbox, width, vp_height, band_list, **kw):
        passes.append((packed.shape[0], [d.device for _y0, d in band_list]))
        return orig_bands(packed, valid, bbox, width, vp_height, band_list,
                          **kw)

    monkeypatch.setattr(trc, "pack_coeffs_full", pack)
    monkeypatch.setattr(raster, "rasterize_bands", bands)
    mesh = cpu_mesh(8)
    app = DemoApp(64, 64, device="cpu", mesh=mesh)
    app.tick()
    t_main = 20000
    part = [(n, d) for n, d in packs if abs(n - t_main // 8) <= 64]
    assert len(part) == 8, packs
    assert [d for _n, d in part] == mesh.band_devices()
    assert not any(n >= t_main for n, _d in packs)
    plan = next(iter(app.draw._plans.values()))
    table = sum(b.tri_count + 2 * tdraw.CLIP_CAPACITY
                for batches in plan.surfaces for b in batches)
    assert table == 20519
    assert passes and all(n == table for n, _d in passes)
    assert sum(len(d) for _n, d in passes) == 8


@pytest.mark.parametrize("tri_count,rows", [(20000, 8), (7, 8), (5, 3),
                                            (0, 4), (9, 3)])
def test_shard_ranges(tri_count, rows):
    """Shard k holds [k * ceil(T / rows), ...) clipped to T: contiguous,
    covering every triangle once, empty shards last when T < rows."""
    ranges = shard_ranges(tri_count, rows)
    chunk = -(-tri_count // rows)
    assert len(ranges) == rows
    assert ranges[0][0] == 0 and ranges[-1][1] == tri_count
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(hi - lo == min(chunk, max(tri_count - lo, 0))
               for lo, hi in ranges)


# (T, seed, cap, rows, kind): kind "spread" holds more straddlers than
# cap in all while each shard holds fewer than cap, so only the merged
# count can set the flag
MERGE_CASES = [(200, 1, 128, 8, None), (200, 1, 16, 8, None),
               (64, 3, 12, 8, "spread"), (300, 4, 1, 3, None),
               (5, 0, 4, 8, "T < rows"), (7, 2, 128, 8, "T < rows"),
               (40, 5, 3, 4, None)]


@pytest.mark.parametrize("n,seed,cap,rows,kind", MERGE_CASES)
def test_straddler_merge_equals_select_straddlers(n, seed, cap, rows, kind):
    """``merge_straddlers`` over the shards' ``straddler_candidates``
    gives ``select_straddlers``' appendee block, selection and flag bit
    for bit, below and above the capacity."""
    clip, vary = tri_random(n, seed, w_range=(-1.0, 3.0))
    valid = np.random.default_rng(seed + 10).uniform(size=n) < 0.85
    clip, vary, valid = (torch.from_numpy(np.ascontiguousarray(a))
                         for a in (clip, vary, valid))
    want = trc.select_straddlers(clip, vary, valid, cap)
    cands = [trc.straddler_candidates(clip[lo:hi], vary[lo:hi],
                                      valid[lo:hi], cap, lo, n)
             for lo, hi in shard_ranges(n, rows)]
    got = trc.merge_straddlers(cands, clip[-1:], vary[-1:], cap, n)
    for a, b in zip(want, got):
        assert_bits_equal(a, b)
    counts = [int(c[3]) for c in cands]
    assert bool(got[4]) == (sum(counts) > cap)
    if kind == "spread":
        assert max(counts) < cap < sum(counts) and bool(got[4])
    if kind == "T < rows":
        assert n < rows and any(lo == hi for lo, hi in shard_ranges(n, rows))
        assert sum(counts) > 0


# mesh shapes beside test_banded_demo_*'s 8x1, at 64x48 (48 rows divide
# by 8, 4, 2 and 3)
MESH_SHAPES = {"4x2": (4, 2), "2x4": (2, 4), "3x1": (3, 1)}
ALL_SHAPES = {"8x1": (8, 1), **MESH_SHAPES}


@pytest.fixture(scope="module", params=list(MESH_SHAPES))
def mesh_demo_frames(request):
    """Frames 1 and 2 of the 64x48 demo on a mesh shape: the port
    sharded, the port on one device and the JAX package on the same
    mesh shape. Per app: [(framebuffer, winners)] per frame."""
    rows, tris = MESH_SHAPES[request.param]
    apps = {"sharded": DemoApp(64, 48, device="cpu",
                               mesh=cpu_mesh(rows, tris)),
            "single": DemoApp(64, 48, device="cpu"),
            "jax": JaxDemoApp(width=64, height=48, backend="pallas",
                              mesh=jax_make_mesh(rows * tris, rows=rows,
                                                 tris=tris))}
    out = {k: [] for k in apps}
    for _ in range(2):
        for name, app in apps.items():
            app.renderer.debug_winner = True
            fb = app.tick()
            out[name].append((fb, app.draw.last_winners))
    return out


@pytest.mark.parametrize("frame", [1, 2])
def test_sharded_demo_equals_one_device_and_jax(frame, mesh_demo_frames):
    """The sharded demo on 4x2, 2x4 and 3x1 meshes: framebuffer and
    winners bit-equal to one device's, winners equal to the JAX mesh
    frame's."""
    fb_s, win_s = mesh_demo_frames["sharded"][frame - 1]
    fb_1, win_1 = mesh_demo_frames["single"][frame - 1]
    fb_j, win_j = mesh_demo_frames["jax"][frame - 1]
    assert isinstance(fb_s, Banded) and len(win_s) == len(win_1) == 1
    assert_bits_equal(np.asarray(fb_s), fb_1)
    assert_bits_equal(np.asarray(win_s[0]), win_1[0])
    np.testing.assert_array_equal(np.asarray(win_j[0]),
                                  np.asarray(win_s[0]))
    assert int((np.asarray(win_s[0]) >= 0).sum()) > 0


@pytest.fixture(scope="module")
def stress_one_device():
    """Frames 1 and 2 of the small stress scene (64x48, terrain 16, 16
    markers) on one device, and the JAX package's frames 1 and 2."""
    from myrenderer_tpu.app import stress as jstress
    from myrenderer_tpu_torch.app.stress import StressApp
    out = {}
    for name, app in (("single", StressApp(64, 48, 16, 16, device="cpu")),
                      ("jax", jstress.StressApp(width=64, height=48,
                                                terrain_size=16,
                                                instances=16,
                                                backend="pallas"))):
        app.renderer.debug_winner = True
        out[name] = [(np.asarray(app.tick()),
                      np.asarray(app.draw.last_winners[0]))
                     for _ in range(2)]
    return out


@pytest.mark.parametrize("shape", list(ALL_SHAPES))
def test_sharded_stress_equals_one_device(shape, stress_one_device):
    """The small stress scene (a whole-stream terrain and vmapped
    instanced markers, cull_mode none) sharded: frames 1 and 2 bit-equal
    to one device's, winners equal to the JAX package's."""
    from myrenderer_tpu_torch.app.stress import StressApp
    app = StressApp(64, 48, 16, 16, device="cpu",
                    mesh=cpu_mesh(*ALL_SHAPES[shape]))
    app.renderer.debug_winner = True
    for (fb_1, win_1), (_fb_j, win_j) in zip(stress_one_device["single"],
                                             stress_one_device["jax"]):
        fb = app.tick()
        win = np.asarray(app.draw.last_winners[0])
        assert_bits_equal(fb_1, np.asarray(fb))
        assert_bits_equal(win_1, win)
        np.testing.assert_array_equal(win_j, win)
    assert int((win >= 0).sum()) > 0


@pytest.mark.parametrize("shape", ["4x2", "2x4"])
@pytest.mark.parametrize("scene", list(SCENES))
def test_sharded_sequential_path_equals_single_device(scene, shape):
    """The sequential scenes on meshes with a ``tris`` axis (rows 3 and
    8 are test_banded_sequential_path_equals_single_device's): every
    pass's winners and the framebuffer bit-equal to one device's."""
    bfb, bwin, _ = render(torch_api(cpu_mesh(*MESH_SHAPES[shape])), "auto",
                          SCENES[scene])
    tfb, twin, _ = render(TORCH, "auto", SCENES[scene])
    assert len(bwin) == len(twin) > 1
    assert_bits_equal(tfb, bfb)
    for a, b in zip(twin, bwin):
        assert_bits_equal(a, b)


@pytest.mark.parametrize("shape", list(MESH_SHAPES))
def test_sharded_textured_quad_equals_single_device(shape):
    """A ctx-consuming fragment program (texture sampling) on the other
    mesh shapes, 48x48: bit-equal to one device."""
    fb_s, win_s = render_quad(torch_api(cpu_mesh(*MESH_SHAPES[shape])),
                              "auto", 48)
    fb_1, win_1 = render_quad(TORCH, "auto", 48)
    assert_bits_equal(fb_1, fb_s)
    assert_bits_equal(win_1, win_s)
    assert int((np.asarray(win_s) >= 0).sum()) > 0


@pytest.mark.parametrize("shape", ["8x1", "4x2", "2x4"])
def test_sharded_straddler_scene_equals_single_device(shape):
    """``utils/scenes.py``'s eye-plane straddler scene (clipped pieces in
    every frame, vertex rows rewritten between frames) on each mesh
    shape whose rows divide its 64 rows: 4 frames, framebuffer and
    winners bit-equal to one device."""
    from myrenderer_tpu_torch.utils.scenes import SCRIPTED
    sharded = SCRIPTED["straddler"]("cpu", "auto",
                                    mesh=cpu_mesh(*ALL_SHAPES[shape]))
    single = SCRIPTED["straddler"]("cpu", "auto")
    for k in range(4):
        fb_s, fb_1 = sharded.step(k), single.step(k)
        assert isinstance(fb_s, Banded)
        assert_bits_equal(np.asarray(fb_1), np.asarray(fb_s))
        for a, b in zip(single.draw.last_winners, sharded.draw.last_winners):
            assert_bits_equal(np.asarray(a), np.asarray(b))
        assert int((np.asarray(sharded.draw.last_winners[0]) >= 0)
                   .sum()) > 0


def test_mesh_over_two_devices_equals_single_device():
    """A mesh whose 4 bands alternate between two devices (``cpu:0`` and
    ``cpu:1``: two entries of the plan's devices, each with its own
    views, shards and bands, on the one CPU): frames 1 and 2 of the demo
    bit-equal to one device's, bands assembled in band order."""
    two = [torch.device("cpu", 0), torch.device("cpu", 1)]
    mesh = make_mesh(devices=two * 2)
    sharded = DemoApp(64, 48, device="cpu:0", mesh=mesh)
    single = DemoApp(64, 48, device="cpu")
    for app in (sharded, single):
        app.renderer.debug_winner = True
    for _ in range(2):
        fb_s, fb_1 = sharded.tick(), single.tick()
        assert_bits_equal(fb_1, np.asarray(fb_s))
        assert_bits_equal(single.draw.last_winners[0],
                          np.asarray(sharded.draw.last_winners[0]))
    plan = next(iter(sharded.draw._plans.values()))
    assert plan.devices == two


def mesh_graph_against_eager(devices, frames: int):
    """The 96x64 demo on a mesh of ``devices`` as segmented graph
    replays and eagerly: framebuffers and winners bit-equal after every
    frame, K1 launched once a band a frame."""
    mesh = make_mesh(devices=devices)
    graph, eager = (DemoApp(96, 64, mesh=mesh) for _ in range(2))
    eager.draw._eager_frames = True
    for app in (graph, eager):
        app.renderer.debug_winner = True
    for _ in range(frames):
        before = raster_cuda.K1.launches
        graph.tick()
        assert raster_cuda.K1.launches == before + len(devices)
        eager.tick()
        for a, b in ((graph.window.framebuffer, eager.window.framebuffer),
                     (graph.draw.last_winners[0], eager.draw.last_winners[0])):
            assert torch.equal(a.cpu().view(torch.int32),
                               b.cpu().view(torch.int32))
    plan = next(iter(graph.draw._plans.values()))
    assert plan.compiled is not None
    assert plan.compiled.k1_launches == len(devices)
    assert [len(g) for g in plan.compiled.graphs] == [2] * len(
        set(devices))
    return plan.compiled


@pytest.mark.cuda
def test_mesh_graph_replay_equals_eager_on_card(cuda_device):
    """Four bands of one card as segmented CUDA graph replays (the
    shards' graph and the bands' graph), bit-equal to eager frames."""
    compiled = mesh_graph_against_eager([cuda_device] * 4, 6)
    assert compiled.gather_bytes == 0


@pytest.mark.cuda
def test_mesh_graph_replay_equals_eager_on_every_card(cuda_device):
    """One band a card on every card (as many as divide 64 rows):
    per-card segmented graph replays bit-equal to eager frames, the
    shards' records copied between cards."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA cards")
    while 64 % n:
        n -= 1
    compiled = mesh_graph_against_eager(
        [torch.device("cuda", i) for i in range(n)], 6)
    assert compiled.gather_bytes > 0
