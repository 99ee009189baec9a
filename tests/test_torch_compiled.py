"""The compiled frame of the PyTorch port on the CPU: static capacities
with device overflow flags, the capacity ladder and its overflow queue
(ports of the JAX package's ladder tests, ``tests/test_render_e2e.py``),
and a frame that reads nothing back to the host.

- Binning at a static pair capacity against exact binning computed here
  with numpy, on random sets, the K1 sets of ``utils/trisets.py`` and
  the frame-1 records of the demo and the stress scene at reduced sizes.
- ``select_straddlers`` against the JAX package's, jitted on the CPU,
  below and above the capacity.
- The ladder through the pair-capacity starve hook
  (``raster._FORCE_PAIR_CAPACITY``, the counterpart of the JAX
  package's ``_FORCE_STREAM_ROWS``), against the port's unstarved frames
  and the JAX package's frames (pallas backend, interpret mode).

The tests marked ``cuda`` hold the CUDA graph against the eager frame on
the card and skip without one."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myrenderer_tpu as jmr
import myrenderer_tpu_torch as tmr
from myrenderer_tpu.ops import raster_common as jrc
from myrenderer_tpu_torch.app.demo import DemoApp
from myrenderer_tpu_torch.app.stress import StressApp
from myrenderer_tpu_torch.ops import raster, raster_cuda
from myrenderer_tpu_torch.ops import raster_common as trc
from myrenderer_tpu_torch.ops.vertex_stage import matvec4
from myrenderer_tpu_torch.parallel import make_mesh
from myrenderer_tpu_torch.renderer import draw as tdraw
from myrenderer_tpu_torch.utils.trisets import (band_slivers,
                                                crowded_triangles,
                                                random_triangles)
from test_torch_raster_common import assert_bits_equal

torch.set_num_threads(1)

TILE = raster_cuda.TILE_H


# --------------------------------------------------------------------------
# binning at a static capacity against exact binning
# --------------------------------------------------------------------------

def exact_bins(valid, bbox, H, W, y0=0, limit=None):
    """Exact CSR binning in numpy: (index, starts, counts, pairs). The
    pairs are enumerated record by record, each record's tiles row by
    row; ``limit`` keeps only the first ``limit`` of them."""
    nty, ntx = -(-H // TILE), -(-W // TILE)
    ph = nty * TILE
    b0, b1, b2, b3 = (np.asarray(c, np.float32) for c in bbox)
    live = valid & (b3 >= y0) & (b2 < y0 + ph) & (b1 >= 0) & (b0 < W)
    tx0 = (np.clip(np.floor(b0), 0, W - 1) / TILE).astype(np.int64)
    tx1 = (np.clip(np.ceil(b1), 0, W - 1) / TILE).astype(np.int64)
    ty0 = (np.clip(np.floor(b2) - y0, 0, ph - 1) / TILE).astype(np.int64)
    ty1 = (np.clip(np.ceil(b3) - y0, 0, ph - 1) / TILE).astype(np.int64)
    tiles, recs = [], []
    for r in np.nonzero(live)[0]:
        for ty in range(ty0[r], ty1[r] + 1):
            for tx in range(tx0[r], tx1[r] + 1):
                tiles.append(ty * ntx + tx)
                recs.append(r)
    pairs = len(tiles)
    tiles = np.asarray(tiles[:limit], np.int64)
    recs = np.asarray(recs[:limit], np.int64)
    order = np.argsort(tiles, kind="stable")
    counts = np.bincount(tiles, minlength=nty * ntx)
    starts = np.cumsum(counts) - counts
    return recs[order].astype(np.int32), starts, counts, pairs


def setup_records(clip, vary, H, W, cull="back"):
    clip_t = torch.from_numpy(np.ascontiguousarray(clip))
    tc = trc.triangle_setup(
        clip_t, torch.from_numpy(np.ascontiguousarray(vary)),
        torch.ones(clip.shape[0], dtype=torch.bool), W, H, cull)
    return (trc.pack_coeffs_full(tc), tc.valid,
            raster.viewport_bbox(clip_t, W, H))


def capture_pass(app):
    """(packed, valid, bbox) of the first raster pass of the app's next
    frame."""
    store = []
    orig = raster.rasterize_bands

    def wrapped(packed, valid, bbox, *args, **kw):
        store.append((packed, valid, bbox))
        return orig(packed, valid, bbox, *args, **kw)

    raster.rasterize_bands = wrapped
    try:
        app.tick()
    finally:
        raster.rasterize_bands = orig
    return store[0]


def binning_case(name):
    """(packed, valid, bbox, H, W, y0) of a named binning case."""
    if name.startswith("random"):
        n, seed = {"random 200": (200, 1), "random 900": (900, 2)}[name]
        H, W = 70, 90
        return (*setup_records(*random_triangles(n, seed,
                                                 w_range=(-0.5, 5.0)),
                               H, W), H, W, 0)
    if name == "crowded tile":
        H, W = 64, 64
        return (*setup_records(*crowded_triangles(600, 3, H, W, (16, 32)),
                               H, W), H, W, 0)
    if name == "slivers, last band":
        H, W, band = 256, 320, 48
        clip, vary = band_slivers(400, 5, H, W, H - band)
        return (*setup_records(clip, vary, H, W, "none"), band, W,
                H - band)
    if name == "demo 96x64 frame 1":
        return (*capture_pass(DemoApp(96, 64, device="cpu")), 64, 96, 0)
    if name == "stress 96x96 frame 1":
        app = StressApp(96, 96, terrain_size=24, instances=16, device="cpu")
        return (*capture_pass(app), 96, 96, 0)
    raise KeyError(name)


BINNING_CASES = ["random 200", "random 900", "crowded tile",
                 "slivers, last band", "demo 96x64 frame 1",
                 "stress 96x96 frame 1"]


@pytest.mark.parametrize("case", BINNING_CASES)
def test_static_binning_equals_exact_binning(case):
    """index[:total], starts and counts bit-equal to exact binning; no
    flag; the index holds pair_capacity(records) slots."""
    packed, valid, bbox, H, W, y0 = binning_case(case)
    index, starts, counts, overflow = raster.bin_packed(packed, valid, bbox,
                                                        H, W, y0=y0)
    want_index, want_starts, want_counts, pairs = exact_bins(
        valid.numpy(), [c.numpy() for c in bbox], H, W, y0)
    assert pairs > 0 and not bool(overflow)
    assert index.shape == (raster.pair_capacity(packed.shape[0]),)
    assert_bits_equal(want_index, index[:pairs])
    assert_bits_equal(want_starts.astype(np.int32), starts)
    assert_bits_equal(want_counts.astype(np.int32), counts)
    # the tail names valid records and lies past every segment
    assert int((starts + counts).max()) == pairs
    assert int(index.min()) >= 0 and int(index.max()) < packed.shape[0]


@pytest.mark.parametrize("case", BINNING_CASES)
def test_starved_binning_raises_the_flag(case, monkeypatch):
    """A pair capacity below the pairs: the flag is set, every segment
    lies in [0, C], and the kept pairs are the first C in record order,
    binned exactly. At big_scale 4 the same capacity hook holds 4C."""
    packed, valid, bbox, H, W, y0 = binning_case(case)
    pairs = exact_bins(valid.numpy(), [c.numpy() for c in bbox], H, W,
                       y0)[3]
    cap = max(pairs // 3, 1)
    monkeypatch.setattr(raster, "_FORCE_PAIR_CAPACITY", cap)
    index, starts, counts, overflow = raster.bin_packed(packed, valid, bbox,
                                                        H, W, y0=y0)
    assert bool(overflow) and index.shape == (cap,)
    assert int(starts.min()) >= 0 and int((starts + counts).max()) <= cap
    assert int(counts.sum()) == cap
    want_index, want_starts, want_counts, _ = exact_bins(
        valid.numpy(), [c.numpy() for c in bbox], H, W, y0, limit=cap)
    assert_bits_equal(want_index, index)
    assert_bits_equal(want_starts.astype(np.int32), starts)
    assert_bits_equal(want_counts.astype(np.int32), counts)
    index, starts, counts, overflow = raster.bin_packed(
        packed, valid, bbox, H, W, y0=y0, big_scale=4)
    assert not bool(overflow) and int(counts.sum()) == pairs


def test_pair_capacity():
    """max(2 * records, 2^19) * big_scale, rounded up to 4096 slots: the
    frame-1 pair counts of the demo at 1080p and 8K (60,872 and 398,991
    pairs, 20,519 records) and of the 4K stress scene (1,441,404 pairs,
    about 1.03 M records) fit at big scale 1."""
    assert raster.pair_capacity(20519) == 2**19
    assert raster.pair_capacity(20519, 4) == 2**21
    assert raster.pair_capacity(1_030_000) == 2_060_288 >= 1_441_404
    assert raster.pair_capacity(2**19 + 1) % 4096 == 0
    assert raster.pair_capacity(2**19 + 1) >= 2**20 + 2


def test_bin_bands_reads_nothing_back():
    """Binning several bands makes no host read (no .tolist(), .item())."""
    packed, valid, bbox, H, W, _y0 = binning_case("random 900")
    with no_host_reads():
        bins = raster.bin_bands([(valid, bbox, 16, 16 * k)
                                 for k in range(4)], W)
    assert len(bins) == 4 and all(len(b) == 4 for b in bins)


# --------------------------------------------------------------------------
# the static straddler selection against the JAX package's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,seed,cap", [(5, 0, 128), (200, 1, 128),
                                        (200, 1, 16), (64, 3, 4),
                                        (300, 4, 1)])
def test_select_straddlers_matches_jax(n, seed, cap):
    """app_clip, app_vary, app_valid, sel and overflow equal to the JAX
    package's, below and above the capacity (T < cap included)."""
    clip, vary = random_triangles(n, seed, w_range=(-1.0, 3.0))
    valid = np.random.default_rng(seed + 10).uniform(size=n) < 0.85
    j = jax.jit(lambda c, v, m: jrc.select_straddlers(c, v, m, cap))(
        clip, vary, valid)
    t = trc.select_straddlers(torch.from_numpy(clip), torch.from_numpy(vary),
                              torch.from_numpy(valid), cap)
    for a, b in zip(j, t):
        assert_bits_equal(a, b)
    w = clip[..., 3]
    n_straddle = int((valid & (w > 1e-6).any(-1) & (w <= 1e-6).any(-1))
                     .sum())
    assert bool(t[4]) == (n_straddle > cap) == bool(np.asarray(j[4]))


# --------------------------------------------------------------------------
# the capacity ladder (ports of the JAX package's tests)
# --------------------------------------------------------------------------

def jax_vertex_fn(ctx):
    p = ctx.attr("pos")
    c = ctx.attr("color")
    clip = ctx.world @ jnp.stack([p[0], p[1], p[2], jnp.float32(1.0)])
    return clip, jnp.stack([c[0], c[1], c[2], jnp.float32(1.0)])


def torch_vertex_fn(ctx):
    p = ctx.attr("pos")
    c = ctx.attr("color")
    one = torch.ones((), dtype=torch.float32, device=p.device)
    return (matvec4(ctx.world, torch.stack([p[0], p[1], p[2], one])),
            torch.stack([c[0], c[1], c[2], one]))


JAX = types.SimpleNamespace(pkg=jmr, vertex_fn=jax_vertex_fn,
                            renderer=lambda core: jmr.Renderer(
                                core, raster_backend="pallas"))
TORCH = types.SimpleNamespace(pkg=tmr, vertex_fn=torch_vertex_fn,
                              renderer=lambda core: tmr.Renderer(
                                  core, device="cpu"))

SIZE = 64
# 12 small triangles in the first tile row, three in each 16-pixel tile
# column and none across a column border: one pair each, 12 in all.
# Stretched x8 in y (TALL) each spans 4 tile rows: 48 pairs.
SMALL_PAIRS, TALL_PAIRS = 12, 48
STARVED = 16          # pairs at big_scale 1: 12 fit, 48 do not, 4 * 16 do
TALL = np.diag([1.0, 8.0, 1.0, 1.0]).astype(np.float32)


def ladder_rows():
    rows = []
    for col in range(4):
        for k in range(3):
            x0 = (16 * col + 1 + 5 * k) / SIZE
            x1 = x0 + 3 / SIZE
            for x, y in ((x0, 1 / SIZE), (x1, 1 / SIZE), (x0, 6 / SIZE)):
                rows.append([x, y, 1.0, 1.0, 0.2 * k, 0.25 * col])
    return np.asarray(rows, np.float32)


def ladder_scene(api, xform=None):
    """(renderer, surface, node, draw) of the ladder scene."""
    pkg = api.pkg
    core = pkg.Core(fixed_timestep=1.0 / 60.0)
    window = core.create_window(SIZE, SIZE, "ladder")
    rend = api.renderer(core)
    rend.adopt_window(window)
    rend.debug_winner = True
    layout = pkg.VertexLayout.create([("pos", 3), ("color", 3)])
    pipe = pkg.Pipeline.create(
        rend, vertex_fn=api.vertex_fn,
        bindings=[pkg.BindingLayout(0, pkg.renderer.BUILTIN_TRANSFORM)],
        vertex_layout=layout)
    rows = ladder_rows()
    vb = pkg.VertexBuffer.new(rend, 0, rows.shape[0] // 3, layout)
    vb.write_vertices(rows)
    node = pkg.Instance.create_node(rend, pipeline=pipe)
    node.get_backing().set_vertex_buffer(vb)
    if xform is not None:
        node.set_xform(xform)
    surf = pkg.Surface.create_window_scene(rend, window, node)
    surf.set_perspective(pkg.math3d.projection_2d(
        left=0.0, right=1.0, bottom=1.0, top=0.0, near=0.1, far=2.0))
    return rend, surf, node, pkg.Draw.create(rend)


def ladder_frame(rend, surf, draw):
    """One frame; returns (framebuffer f32, winner i32) on the host."""
    draw.begin()
    draw.clear((0.0, 0.0, 1.0, 1.0))
    draw.draw_surface(surf)
    draw.end()
    rend.update()
    return (rend.window.read_pixels(as_uint8=False),
            np.asarray(draw.last_winners[0]))


@pytest.fixture(scope="module")
def tall_frames():
    """The TALL scene's first frame: the JAX package's, and the port's
    unstarved one."""
    out = {}
    for name, api in (("jax", JAX), ("torch", TORCH)):
        rend, surf, _node, draw = ladder_scene(api, TALL)
        out[name] = ladder_frame(rend, surf, draw)
    return out


def assert_frame_equal(got, want):
    np.testing.assert_array_equal(want[1], got[1])
    assert_bits_equal(want[0], torch.from_numpy(got[0]))


def test_ladder_scene_pair_counts(tall_frames):
    """The scene holds the pair counts the ladder tests rely on, and the
    port's unstarved TALL frame equals the JAX package's."""
    for xform, want in ((None, SMALL_PAIRS), (TALL, TALL_PAIRS)):
        rend, surf, _node, draw = ladder_scene(TORCH, xform)
        packed, valid, bbox = capture_pass(types.SimpleNamespace(
            tick=lambda: ladder_frame(rend, surf, draw)))
        _i, _s, counts, _o = raster.bin_packed(packed, valid, bbox, SIZE,
                                               SIZE)
        assert int(counts.sum()) == want
    assert_frame_equal(tall_frames["torch"], tall_frames["jax"])
    assert int((tall_frames["torch"][1] >= 0).sum()) > 12 * 30


def test_stream_overflow_triggers_rebuild(tall_frames, monkeypatch):
    """``test_stream_overflow_triggers_rebuild`` (JAX e2e :308): the
    pairs outgrow a starved capacity on the first frame, inside the
    synchronous window, so the very first published frame is already
    right: big_scale 4, the flag clear, the frame equal to the unstarved
    frame and to the JAX package's."""
    monkeypatch.setattr(raster, "_FORCE_PAIR_CAPACITY", STARVED)
    rend, surf, _node, draw = ladder_scene(TORCH, TALL)
    rend.collect_stats = True
    got = ladder_frame(rend, surf, draw)
    assert draw.big_scale == 4
    assert not bool(draw.last_overflow.any())
    assert rend.frame_stats["big_scale"] == 4
    assert_frame_equal(got, tall_frames["torch"])
    assert_frame_equal(got, tall_frames["jax"])
    # the dropped pairs were real: at big_scale 1 the frame misses pixels
    draw_1 = ladder_scene(TORCH, TALL)
    monkeypatch.setattr(tdraw, "BIG_SCALE_MAX", 1)
    starved = ladder_frame(draw_1[0], draw_1[1], draw_1[3])
    assert bool(draw_1[3].last_overflow[0])
    assert int((starved[1] >= 0).sum()) < int((got[1] >= 0).sum())


def test_late_big_list_overflow_triggers_rebuild(tall_frames, monkeypatch):
    """``test_late_big_list_overflow_triggers_rebuild`` (JAX e2e :248),
    on the port's pair capacity: an overflow first occurring AFTER the
    3-frame synchronous window still bumps the capacity (the queued flag
    is read a frame later); the post-bump frame equals a fresh render of
    the scene and the JAX package's frame."""
    monkeypatch.setattr(raster, "_FORCE_PAIR_CAPACITY", STARVED)
    rend, surf, node, draw = ladder_scene(TORCH)
    for _ in range(4):
        ladder_frame(rend, surf, draw)
    assert draw.big_scale == 1
    node.set_xform(TALL)
    ladder_frame(rend, surf, draw)        # one frame of drops is allowed
    assert bool(draw.last_overflow.any())
    fb6 = ladder_frame(rend, surf, draw)  # then the queued flag bumps
    assert draw.big_scale >= 4, "late overflow never bumped capacity"
    assert not bool(draw.last_overflow.any())
    assert_frame_equal(fb6, tall_frames["torch"])
    assert_frame_equal(fb6, tall_frames["jax"])


class NeverReady:
    """A queued flag that never reaches the host on its own."""

    def __init__(self, flag):
        self.flag = flag

    def is_ready(self):
        return False

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.flag, dtype)


def test_overflow_detection_window_is_bounded(tall_frames, monkeypatch):
    """``test_overflow_detection_window_is_bounded`` (JAX e2e
    :1158-1226): with flags that never become ready, the force-drain
    still detects a steady-state overflow within OVERFLOW_WINDOW frames
    and the detecting frame is rendered again before it publishes;
    overflow_risk_frames reads 8 when queued, 0 under strict_overflow
    and -1 at the top of the ladder."""
    monkeypatch.setattr(raster, "_FORCE_PAIR_CAPACITY", STARVED)
    rend, surf, node, draw = ladder_scene(TORCH)
    rend.collect_stats = True

    def frame():
        out = ladder_frame(rend, surf, draw)
        draw._pending_overflow = [
            f if isinstance(f, NeverReady) else NeverReady(f)
            for f in draw._pending_overflow]
        return out

    for _ in range(4):
        frame()
    assert draw.big_scale == 1
    assert rend.frame_stats["overflow_risk_frames"] == draw.OVERFLOW_WINDOW

    node.set_xform(TALL)
    detected_after = None
    for i in range(draw.OVERFLOW_WINDOW + 2):
        got = frame()
        if draw.big_scale > 1:
            detected_after = i
            break
    assert detected_after is not None, "overflow never detected"
    assert detected_after <= draw.OVERFLOW_WINDOW
    # the detecting frame re-rendered before publishing
    assert not bool(draw.last_overflow.any())
    assert_frame_equal(got, tall_frames["jax"])

    rend.strict_overflow = True
    frame()
    assert rend.frame_stats["overflow_risk_frames"] == 0

    rend.strict_overflow = False
    draw.big_scale = tdraw.BIG_SCALE_MAX
    frame()
    assert rend.frame_stats["overflow_risk_frames"] == -1


def test_precompile_capacity_bump_warms_next_plan(tall_frames, monkeypatch):
    """``test_precompile_capacity_bump_warms_next_plan`` (JAX e2e :787),
    at the level of the plan: after a frame the next rung's plan is in
    the Draw's cache (on a card with its CUDA graph), and warming it
    neither re-arms the synchronous window nor drops queued flags. The
    bumped frame shows every triangle."""
    monkeypatch.setattr(raster, "_FORCE_PAIR_CAPACITY", STARVED)
    rend, surf, _node, draw = ladder_scene(TORCH, TALL)
    rend.precompile_capacity_bump = True
    got = ladder_frame(rend, surf, draw)
    assert draw.big_scale == 4            # bumped in the sync window
    scales = {plan.big_scale for plan in draw._plans.values()}
    assert scales == {4, 16}, f"next rung not warmed: {scales}"
    assert draw._frames_since_rebuild == 1
    assert_frame_equal(got, tall_frames["jax"])
    for _ in range(3):
        ladder_frame(rend, surf, draw)
    assert draw._frames_since_rebuild == 3
    assert len(draw._pending_overflow) == 1
    assert len(draw._plans) == 2


def test_ladder_on_a_mesh(tall_frames, monkeypatch):
    """The ladder and ``precompile_capacity_bump`` on a 2x2 mesh: each
    of the 2 bands bins 24 of the TALL scene's 48 pairs against 16
    starved slots, the first frame bumps to big scale 4 and re-renders
    before it publishes, the next rung's plan is made ahead, and the
    published frame equals the unstarved one and the JAX package's."""
    monkeypatch.setattr(raster, "_FORCE_PAIR_CAPACITY", STARVED)
    mesh = make_mesh(4, rows=2, tris=2, devices=["cpu"] * 4)
    rend, surf, _node, draw = ladder_scene(types.SimpleNamespace(
        pkg=tmr, vertex_fn=torch_vertex_fn,
        renderer=lambda core: tmr.Renderer(core, device="cpu", mesh=mesh)),
        TALL)
    rend.precompile_capacity_bump = True
    got = ladder_frame(rend, surf, draw)
    assert draw.big_scale == 4 and not bool(draw.last_overflow.any())
    assert {plan.big_scale for plan in draw._plans.values()} == {4, 16}
    assert_frame_equal(got, tall_frames["torch"])
    assert_frame_equal(got, tall_frames["jax"])


def test_bump_drops_lower_rungs_and_queue(monkeypatch):
    """A bump leaves only plans at or above the new scale, drops the
    queued flags and re-arms the synchronous window for 2 more frames."""
    monkeypatch.setattr(raster, "_FORCE_PAIR_CAPACITY", STARVED)
    rend, surf, node, draw = ladder_scene(TORCH)
    for _ in range(5):
        ladder_frame(rend, surf, draw)
    assert len(draw._pending_overflow) == 1
    node.set_xform(TALL)
    ladder_frame(rend, surf, draw)
    ladder_frame(rend, surf, draw)        # detects, bumps, re-renders
    assert draw.big_scale == 4
    assert {p.big_scale for p in draw._plans.values()} == {4}
    assert draw._frames_since_rebuild == 1
    # only the re-rendered frame's own (clear) flag is queued
    assert len(draw._pending_overflow) == 1
    assert not np.asarray(draw._pending_overflow[0]).any()


# --------------------------------------------------------------------------
# no host read inside the frame
# --------------------------------------------------------------------------

class no_host_reads:
    """Make ``Tensor.item``, ``tolist``, ``__bool__`` and
    ``torch.nonzero`` raise inside the block."""

    NAMES = ((torch.Tensor, "item"), (torch.Tensor, "tolist"),
             (torch.Tensor, "__bool__"), (torch, "nonzero"))

    def __enter__(self):
        self.saved = [(o, n, getattr(o, n)) for o, n in self.NAMES]

        def boom(*_a, **_k):
            raise AssertionError("a host read inside the frame")

        for owner, name, _fn in self.saved:
            setattr(owner, name, boom)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self.saved:
            setattr(owner, name, fn)


def frame_without_host_reads(monkeypatch):
    """Patch draw._frame and draw._mesh_frame so that they run under
    :class:`no_host_reads`, K1 excepted: on the CPU its plain version
    stands in for the kernel, which reads nothing back on the card.
    Returns the list of frames checked."""
    checked = []
    orig_k1 = raster.rasterize_tiles

    def k1(*args, **kw):
        reads.__exit__()
        try:
            return orig_k1(*args, **kw)
        finally:
            reads.__enter__()

    def guarded(orig):
        def frame(*args, **kw):
            with reads:
                out = orig(*args, **kw)
            checked.append(out)
            return out
        return frame

    reads = no_host_reads()
    monkeypatch.setattr(tdraw, "_frame", guarded(tdraw._frame))
    monkeypatch.setattr(tdraw, "_mesh_frame", guarded(tdraw._mesh_frame))
    monkeypatch.setattr(raster, "rasterize_tiles", k1)
    return checked


@pytest.mark.parametrize("scene", ["demo", "stress", "sequential",
                                   "demo on a mesh"])
def test_frame_reads_nothing_back(scene, monkeypatch):
    """After the synchronous window, a frame does no host read: the
    demo (merged pass, whole-stream terrain, vmapped polygons), the
    stress scene (vmapped instanced markers), a sequential frame, and
    the demo sharded over a 4x2 mesh (the shards' stage, the all-gather
    and the bands' stage)."""
    if scene == "demo":
        app = DemoApp(64, 48, device="cpu")
    elif scene == "stress":
        app = StressApp(64, 64, terrain_size=16, instances=16, device="cpu")
    elif scene == "demo on a mesh":
        app = DemoApp(64, 48, device="cpu", mesh=make_mesh(
            8, rows=4, tris=2, devices=["cpu"] * 8))
    else:
        rend, surf, node, draw = ladder_scene(TORCH)
        node.get_backing().pipeline.depth_write = False
        app = types.SimpleNamespace(
            draw=draw, tick=lambda: ladder_frame(rend, surf, draw))
    for _ in range(3):
        app.tick()
    assert app.draw._frames_since_rebuild == 3
    checked = frame_without_host_reads(monkeypatch)
    app.tick()
    app.tick()
    assert len(checked) == 2
    assert checked[-1][2].shape == (2,) and not bool(checked[-1][2].any())
    assert len(app.draw._pending_overflow) == 1


def test_frame_returns_both_lanes(monkeypatch):
    """The frame's flag has the pair lane and the clip lane (set by
    more straddlers than the clip capacity, test_torch_sequential's
    ladder tests): a starved pair capacity sets lane 0 alone."""
    rend, surf, _node, draw = ladder_scene(TORCH, TALL)
    ladder_frame(rend, surf, draw)
    plan = next(iter(draw._plans.values()))
    args = tdraw.device_args(draw._gather_args(plan, rend.window),
                             rend.device)
    _fb, _w, overflow = tdraw._frame(plan, args, rend.device)
    assert overflow.tolist() == [False, False]
    monkeypatch.setattr(raster, "_FORCE_PAIR_CAPACITY", 8)
    _fb, _w, overflow = tdraw._frame(plan, args, rend.device)
    assert overflow.tolist() == [True, False]


# --------------------------------------------------------------------------
# the CUDA graph on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graph_replay_equals_eager_on_card(cuda_device):
    """Demo frames replayed from the CUDA graph bit-equal to eager ones,
    one K1 launch a frame, and a published frame left unchanged by the
    next replay."""
    graph, eager = DemoApp(96, 64), DemoApp(96, 64)
    eager.draw._eager_frames = True
    for app in (graph, eager):
        app.renderer.debug_winner = True
    kept = None
    for frame in range(6):
        before = raster_cuda.K1.launches
        graph.tick()
        assert raster_cuda.K1.launches == before + 1
        eager.tick()
        for a, b in ((graph.window.framebuffer, eager.window.framebuffer),
                     (graph.draw.last_winners[0], eager.draw.last_winners[0])):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        if frame == 2:
            kept = (graph.window.framebuffer,
                    graph.window.framebuffer.clone())
    assert torch.equal(kept[0], kept[1])
    plan = next(iter(graph.draw._plans.values()))
    assert plan.compiled is not None and plan.compiled.k1_launches == 1


@pytest.mark.cuda
def test_capture_of_a_host_read_raises_on_card(cuda_device):
    """A vertex function that reads a value back (``.item()``) cannot be
    captured: Draw.end raises instead of rendering eagerly."""
    gain = torch.ones((), device=cuda_device)

    def vertex_fn(ctx):
        clip, vary = torch_vertex_fn(ctx)
        return clip * gain.item(), vary

    rend, surf, _node, draw = ladder_scene(types.SimpleNamespace(
        pkg=tmr, vertex_fn=vertex_fn,
        renderer=lambda core: tmr.Renderer(core, device="cuda")))
    with pytest.raises(RuntimeError):
        ladder_frame(rend, surf, draw)
