"""Setup-stage parity: triangle setup, eye-plane straddler clipping and
the 32-lane record pack of the PyTorch port against the JAX package on
the CPU. Records must be bit-equal, every lane, valid or not (NaN equal
to NaN). Inputs are made with numpy from a seed."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myrenderer_tpu.ops import raster_common as jrc
from myrenderer_tpu.ops import raster_pallas as jrp
from myrenderer_tpu.renderer import draw as jdraw
from myrenderer_tpu_torch.app.demo import DemoApp
from myrenderer_tpu_torch.ops import raster_common as trc
from myrenderer_tpu_torch.ops import setup_pack as sp
from myrenderer_tpu_torch.ops import vertex_stage as tvs
from myrenderer_tpu_torch.renderer import draw as tdraw
from myrenderer_tpu_torch.renderer.compiled import device_args
from myrenderer_tpu_torch.utils.trisets import random_triangles

torch.set_num_threads(1)


def assert_bits_equal(a, b):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    if a.dtype == np.float32:
        bad = (a.view(np.int32) != b.view(np.int32)) & ~(
            np.isnan(a) & np.isnan(b))
    else:
        bad = a != b
    assert not bad.any(), (f"{int(bad.sum())} of {a.size} values differ at "
                           f"{np.argwhere(bad)[:5].tolist()}")


def jax_setup_batch(clip, vary, valid, width, height, cull_mode="back",
                    z_bias=None, base=0, ids=None, planar=False):
    """The JAX package's per-batch clip + setup + pack + bbox
    (``draw._setup_batch``), run as its frame runs it on the CPU."""
    plan = types.SimpleNamespace(
        raster_cfg=jrp.RasterConfig(interpret=True), width=width,
        height=height, mesh=None)

    def f(clip, vary, valid, ids):
        tri = clip
        if planar:
            tri = jrc.PlanarTris(
                tuple(tuple(clip[:, k, ch] for ch in range(4))
                      for k in range(3)),
                tuple(tuple(vary[:, k, ch] for ch in range(4))
                      for k in range(3)), ids)
        packed, v, bbox, _ovf = jdraw._setup_batch(
            plan, tri, vary, valid, cull_mode, jnp.zeros(3, bool),
            z_bias=z_bias, base_index=base)
        return packed, v, bbox

    return jax.jit(f)(clip, vary, valid, ids)


def torch_setup_batch(clip, vary, valid, width, height, cull_mode="back",
                      z_bias=None, base=0, ids=None, planar=False):
    plan = types.SimpleNamespace(width=width, height=height)
    tris = trc.Triangles(torch.from_numpy(clip), torch.from_numpy(vary),
                         None if ids is None else torch.from_numpy(ids),
                         planar)
    table = sp.new_table(base + clip.shape[0] + 2 * tdraw.CLIP_CAPACITY,
                         "cpu")
    segments, _ovf = tdraw._batch_segments(
        plan, tris, torch.from_numpy(valid), cull_mode, table,
        z_bias=z_bias, base_index=base)
    sp.setup_pack_pass(segments)
    return table.rows(base, base + clip.shape[0] + 2 * tdraw.CLIP_CAPACITY)


@pytest.mark.parametrize("cull_mode", ["back", "front", "none"])
@pytest.mark.parametrize("z_bias", [None, 0.0, 2.0])
@pytest.mark.parametrize("planar", [False, True])
def test_setup_and_pack(cull_mode, z_bias, planar):
    """Setup + pack of a random batch with straddlers and both windings:
    every lane of every record bit-equal, in every rounding-form case
    (cull mode, z bias, planar producer)."""
    n = 300
    clip, vary = random_triangles(n, 7, w_range=(-0.5, 5.0),
                                  mixed_winding=True)
    valid = np.random.default_rng(8).uniform(size=n) < 0.9
    ids = np.random.default_rng(9).permutation(n).astype(np.int32)
    kw = dict(cull_mode=cull_mode, z_bias=z_bias, base=1000,
              ids=ids if planar else None, planar=planar)
    jpacked, jvalid, jbbox = jax_setup_batch(clip, vary, valid, 160, 48,
                                             **kw)
    tpacked, tvalid, tbbox = torch_setup_batch(clip, vary, valid, 160, 48,
                                               **kw)
    assert tpacked.shape == (n + 2 * tdraw.CLIP_CAPACITY, trc.FULL_LANES)
    assert_bits_equal(jpacked, tpacked)
    assert_bits_equal(jvalid, tvalid)
    for a, b in zip(jbbox, tbbox):
        assert_bits_equal(a, b)
    assert 0 < int(tvalid[n:].sum()) < 2 * tdraw.CLIP_CAPACITY


@pytest.mark.parametrize("culls", [("back", "none"), ("front", "back")])
def test_two_batch_pass_table(culls):
    """Two batches written by the pass path (each batch's
    ``draw._batch_segments``, then one ``setup_pack_pass`` over the four
    segments, as ``draw._merged_pass`` does) into one table: each batch's
    rows equal the JAX package's ``_setup_batch`` at its first id, bit for
    bit in every lane, flag and box. The first batch is planar with ids
    and biased, the second not."""
    plan = types.SimpleNamespace(width=160, height=48)
    cap = tdraw.CLIP_CAPACITY
    batches = []
    for k, (n, seed) in enumerate(((300, 21), (130, 22))):
        clip, vary = random_triangles(n, seed, w_range=(-0.5, 5.0),
                                      mixed_winding=True)
        valid = np.random.default_rng(seed).uniform(size=n) < 0.9
        ids = (np.random.default_rng(seed + 1).permutation(n)
               .astype(np.int32) if k == 0 else None)
        batches.append((clip, vary, valid, ids, k == 0, 2.0 if k == 0
                        else None))
    table = sp.new_table(sum(b[0].shape[0] + 2 * cap for b in batches),
                         "cpu")
    segments, base, bases = [], 0, []
    for (clip, vary, valid, ids, planar, bias), cull in zip(batches, culls):
        tris = trc.Triangles(torch.from_numpy(clip), torch.from_numpy(vary),
                             None if ids is None else torch.from_numpy(ids),
                             planar)
        segs, _ovf = tdraw._batch_segments(plan, tris,
                                           torch.from_numpy(valid), cull,
                                           table, z_bias=bias,
                                           base_index=base)
        segments += segs
        bases.append(base)
        base += clip.shape[0] + 2 * cap
    assert len(sp.launch_groups(segments)) == 1
    sp.setup_pack_pass(segments)
    for (clip, vary, valid, ids, planar, bias), cull, lo in zip(
            batches, culls, bases):
        hi = lo + clip.shape[0] + 2 * cap
        jpacked, jvalid, jbbox = jax_setup_batch(
            clip, vary, valid, 160, 48, cull_mode=cull, z_bias=bias,
            base=lo, ids=ids, planar=planar)
        packed, v, bbox = table.rows(lo, hi)
        assert_bits_equal(jpacked, packed)
        assert_bits_equal(jvalid, v)
        for a, b in zip(jbbox, bbox):
            assert_bits_equal(a, b)
        assert 0 < int(v[clip.shape[0]:].sum())


@pytest.mark.parametrize("n,seed", [(5, 0), (200, 1)])
def test_select_straddlers(n, seed):
    clip, vary = random_triangles(n, seed, w_range=(-1.0, 3.0))
    valid = np.random.default_rng(seed).uniform(size=n) < 0.8
    j = jax.jit(lambda c, v, m: jrc.select_straddlers(c, v, m, 128))(
        clip, vary, valid)
    t = trc.select_straddlers(torch.from_numpy(clip), torch.from_numpy(vary),
                              torch.from_numpy(valid), 128)
    assert len(t) == len(j) == 5
    for a, b in zip(j, t):
        assert_bits_equal(a, b)
    assert bool(np.asarray(j[2]).any()) and not bool(t[4])


def test_select_straddlers_raises_over_capacity():
    """More straddlers than the capacity raise the device flag (no
    exception, no host read): the first ``cap`` straddlers in array
    order are clipped, as the reference clips them."""
    clip, vary = random_triangles(64, 3, w_range=(-1.0, 1.0))
    w = clip[..., 3]
    straddle = np.nonzero((w > 1e-6).any(-1) & (w <= 1e-6).any(-1))[0]
    assert straddle.size > 4
    _c, _v, app_valid, sel, overflow = trc.select_straddlers(
        torch.from_numpy(clip), torch.from_numpy(vary),
        torch.ones(64, dtype=torch.bool), 4)
    assert overflow.shape == () and bool(overflow)
    np.testing.assert_array_equal(sel.numpy(), straddle[:4])
    assert app_valid.shape == (8,) and bool(app_valid[:4].all())


def test_coverage_depth_and_top_left():
    """The shared per-pixel rule on records with exact zeros on edges
    (top-left ties), against the JAX package's coverage_depth."""
    clip, vary = random_triangles(50, 4)
    # snap vertices to the pixel-center lattice so edges pass through
    # pixel centers exactly
    clip[..., :2] = (np.round(clip[..., :2] / clip[..., 3:] * 8) / 8
                     * clip[..., 3:])
    tpacked, _v, _b = torch_setup_batch(clip, vary, np.ones(50, bool),
                                        32, 32)
    rec = tpacked.numpy()[:50]
    H = W = 32
    py, px = np.mgrid[0:H, 0:W].astype(np.float32) + 0.5
    jcov, jz = jax.jit(lambda r, x, y: jrc.coverage_depth(
        tuple(r[:, k, None, None] for k in range(16)), x, y))(rec, px, py)
    tcov, tz = trc.coverage_depth(torch.from_numpy(rec)[:, None, None, :],
                                  torch.from_numpy(px), torch.from_numpy(py))
    np.testing.assert_array_equal(np.asarray(jcov), tcov.numpy())
    jz, tz = np.asarray(jz), tz.numpy()
    cov = np.asarray(jcov)
    assert_bits_equal(jz[cov], tz[cov])
    a = torch.tensor([1.0, 0.0, 0.0, -1.0, 0.0])
    b = torch.tensor([0.0, 1.0, -1.0, 5.0, 0.0])
    np.testing.assert_array_equal(
        np.asarray(jrc.edge_is_top_left(jnp.asarray(a.numpy()),
                                        jnp.asarray(b.numpy()))),
        trc.edge_is_top_left(a, b).numpy())


@pytest.fixture(scope="module")
def demo_batches():
    """The 128x128 demo's frame-1 triangle batches, from the port's
    vertex stage (held bit-equal to the JAX package's by
    test_torch_vertex_stage), with their setup inputs."""
    app = DemoApp(128, 128, device="cpu")
    app.tick()
    draw = app.draw
    plan = draw._get_plan(app.window)
    args = device_args(draw._gather_args(plan, app.window),
                       torch.device("cpu"))
    world = tvs.compose_world_transforms(args["locals"],
                                         plan.level_index[torch.device("cpu")])
    return tdraw._batch_vertex_products(plan, args, world,
                                        torch.device("cpu"))


def test_demo_frame1_batches(demo_batches):
    """Setup + pack of the demo's frame-1 batches (terrain: 20000
    triangles in the planar order with submission ranks, bias 2;
    polygons: 7 triangles, bias 0) with the merged pass's global id
    layout: each batch takes T + 2 * 128 ids."""
    assert [b.tri_count for _s, b, _t, _v, _f in demo_batches] == [20000, 7]
    base = 0
    for s_i, b, tris, valid, _fctx in demo_batches:
        kw = dict(cull_mode=b.pipeline.cull_mode, z_bias=2.0 * (1 - s_i),
                  base=base,
                  ids=None if tris.ids is None else tris.ids.numpy(),
                  planar=tris.planar)
        args = (tris.clip.numpy(), tris.vary.numpy(), valid.numpy(), 128,
                128)
        jpacked, jvalid, jbbox = jax_setup_batch(*args, **kw)
        tpacked, tvalid, tbbox = torch_setup_batch(*args, **kw)
        assert_bits_equal(jpacked, tpacked)
        assert_bits_equal(jvalid, tvalid)
        for a, c in zip(jbbox, tbbox):
            assert_bits_equal(a, c)
        base += tpacked.shape[0]
    assert base == 20000 + 256 + 7 + 256


@pytest.mark.parametrize("planar", [False, True])
def test_clip_near_capacity(planar):
    """The oracle's clip stage: the appendee block concatenated after
    the batch in array order (a permuted producer's ids dropped, as the
    JAX package's planar concat drops them)."""
    n = 150
    clip, vary = random_triangles(n, 11, w_range=(-1.0, 3.0))
    valid = np.random.default_rng(12).uniform(size=n) < 0.9
    ids = np.random.default_rng(13).permutation(n).astype(np.int32)

    def f(c, v, m, i):
        tri = c
        if planar:
            tri = jrc.PlanarTris(
                tuple(tuple(c[:, k, ch] for ch in range(4))
                      for k in range(3)),
                tuple(tuple(v[:, k, ch] for ch in range(4))
                      for k in range(3)), i)
        out, ov, om, _zb, _cc, ovf = jrc.clip_near_capacity(tri, v, m, 128)
        return (out.interleaved() if planar else (out, ov)), om, ovf

    (jc, jv), jm, jovf = jax.jit(f)(clip, vary, valid, ids)
    tris, tm, tovf = trc.clip_near_capacity(
        trc.Triangles(torch.from_numpy(clip), torch.from_numpy(vary),
                      torch.from_numpy(ids) if planar else None, planar),
        torch.from_numpy(valid), 128)
    assert not bool(jovf) and not bool(tovf)
    assert_bits_equal(jc, tris.clip)
    assert_bits_equal(jv, tris.vary)
    assert_bits_equal(jm, tm)
    assert tris.ids is None and tris.planar == planar
    assert tris.clip.shape[0] == n + 256 and bool(tm[n:].any())


def test_pixel_grids_depth_test_and_resolve():
    H, W = 12, 20
    jpx, jpy = jrc.pixel_grids(H, W)
    tpx, tpy = trc.pixel_grids(H, W)
    assert_bits_equal(jpx, tpx)
    assert_bits_equal(jpy, tpy)
    rng = np.random.default_rng(14)
    cov = rng.uniform(size=(H, W)) < 0.5
    z = rng.uniform(0, 1, (H, W)).astype(np.float32)
    depth = rng.uniform(0, 1, (H, W)).astype(np.float32)
    winner = rng.integers(-1, 5, (H, W)).astype(np.int32)
    jd, jw = jrc.depth_test_update(cov, z, depth, winner, 7)
    td, tw = trc.depth_test_update(*(torch.from_numpy(a) for a in
                                     (cov, z, depth, winner)), 7)
    assert_bits_equal(jd, td)
    assert_bits_equal(jw, tw)
    # resolve of random winners, as the oracle's full-frame graph runs it
    clip, vary = random_triangles(40, 15)
    m = np.ones(40, bool)
    win = rng.integers(-1, 40, (H, W)).astype(np.int32)
    jv, jcov = jax.jit(lambda c, v, m, w: jrc.resolve_varyings(
        jrc.triangle_setup(c, v, m, W, H), w,
        *jrc.pixel_grids(H, W)))(clip, vary, m, win)
    tc = trc.triangle_setup(torch.from_numpy(clip), torch.from_numpy(vary),
                            torch.from_numpy(m), W, H, oracle=True)
    tv, tcov = trc.resolve_varyings(tc, torch.from_numpy(win),
                                    *trc.pixel_grids(H, W))
    assert_bits_equal(jcov, tcov)
    assert_bits_equal(np.asarray(jv)[win >= 0], tv.numpy()[win >= 0])
