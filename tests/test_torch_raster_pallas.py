"""The renderer-level cases of ``tests/test_raster_pallas.py`` through the
PyTorch port on the CPU: the port's tile path (binning and K1's plain
version) and its oracle against each other, with the JAX test's
assertions, and against the JAX package's oracle (jitted) bit for bit.

The JAX test's depth rule between the tile path and the oracle (at most
2 ulps) holds; the port's oracle depth equals the JAX oracle's to the
bit. The cases that test the Pallas kernel's TPU configuration (its
``RasterConfig`` knobs, ``auto_config``, the big-triangle list,
``tiles_x``, span budgets, fused-key sorts, row-group splits and wide
packs) have no counterpart in the port and are skipped by name.
``test_visibility_parity`` is ported as ``test_torch_raster.py``'s
``test_rasterize_packed_parity``, ``test_band_rendering_matches_full_frame``
as ``test_torch_parallel.py``'s band tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myrenderer_tpu.app.demo import DemoApp as JaxDemoApp
from myrenderer_tpu.ops import raster_common as jrc
from myrenderer_tpu.ops import raster_ref as jrr
from myrenderer_tpu_torch import SceneNode, math3d
from myrenderer_tpu_torch.app.demo import DemoApp
from myrenderer_tpu_torch.ops import raster, raster_ref
from myrenderer_tpu_torch.ops import raster_common as rc
from myrenderer_tpu_torch.utils import scenes
from myrenderer_tpu_torch.utils.trisets import random_triangles

torch.set_num_threads(1)


def assert_depth_close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    ulps = np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))
    assert ulps.max() <= 2, f"depth differs by {ulps.max()} ulps"


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def setup(clip, vary, H, W):
    return rc.triangle_setup(t(clip), t(vary),
                             torch.ones(clip.shape[0], dtype=torch.bool), W,
                             H, "back")


def jax_oracle(clip, vary, H, W, depth=None):
    """The JAX oracle's (depth, winner) over the JAX package's setup of
    the same triangles, jitted."""
    def run(c, v, d):
        tc = jrc.triangle_setup(c, v, jnp.ones(c.shape[0], bool), W, H,
                                "back")
        return jrr.rasterize_visibility(tc, H, W, depth=d)
    return jax.jit(run)(clip, vary, depth)


def test_parity_with_carried_depth():
    """A second batch rasterized against the first batch's depth, on a
    frame of partial tiles: the tile path's winners equal the oracle's
    (depth within 2 ulps), and the oracle's equal the JAX oracle's."""
    H, W = 40, 130
    clip1, vary1 = random_triangles(20, 10)
    clip2, vary2 = random_triangles(20, 11)
    tc1, tc2 = setup(clip1, vary1, H, W), setup(clip2, vary2, H, W)
    d1r, _ = raster_ref.rasterize_visibility(tc1, H, W)
    d2r, w2r = raster_ref.rasterize_visibility(tc2, H, W, depth=d1r)
    d1p, _ = raster.rasterize_visibility(tc1, H, W, tri_clip=t(clip1))
    d2p, w2p = raster.rasterize_visibility(tc2, H, W, depth=d1p,
                                           tri_clip=t(clip2))
    np.testing.assert_array_equal(w2r.numpy(), w2p.numpy())
    assert_depth_close(d2r.numpy(), d2p.numpy())
    jd1, _ = jax_oracle(clip1, vary1, H, W)
    jd2, jw2 = jax_oracle(clip2, vary2, H, W, jd1)
    np.testing.assert_array_equal(np.asarray(jw2), w2r.numpy())
    np.testing.assert_array_equal(np.asarray(jd2).view(np.int32),
                                  d2r.numpy().view(np.int32))


def test_overflow_reported():
    """A pass whose (tile, record) pairs outgrow the pair capacity (the
    port's one static capacity of binning; the JAX test starves its
    big-triangle list) reports it; at the full capacity it does not."""
    H, W = 16, 128
    clip, vary = random_triangles(64, 7)
    tc = setup(clip, vary, H, W)
    bbox = raster.viewport_bbox(t(clip), W, H)
    packed = rc.pack_coeffs_full(tc)
    *_, ovf = raster.rasterize_packed(packed, tc.valid, bbox, H, W)
    assert not bool(ovf)
    pairs = int(raster.bin_packed(packed, tc.valid, bbox, H, W)[2].sum())
    raster._FORCE_PAIR_CAPACITY = pairs // 2
    try:
        *_, ovf = raster.rasterize_packed(packed, tc.valid, bbox, H, W)
    finally:
        raster._FORCE_PAIR_CAPACITY = None
    assert bool(ovf)


def test_demo_scene_backend_parity():
    """The demo frame 2 at 128x128 on both backends: same covered pixels,
    colours within the JAX test's tolerance; the port's oracle frame
    bit-equal to the JAX oracle's."""
    fb_o = DemoApp(width=128, height=128, backend="oracle",
                   device="cpu").run(2)
    fb_p = DemoApp(width=128, height=128, backend="auto", device="cpu").run(2)
    np.testing.assert_array_equal(fb_o[..., 3] > 0, fb_p[..., 3] > 0)
    np.testing.assert_allclose(fb_o, fb_p, atol=5e-4, rtol=1e-4)
    jfb_o = np.asarray(JaxDemoApp(width=128, height=128,
                                  backend="oracle").run(2))
    np.testing.assert_array_equal(jfb_o.view(np.int32), fb_o.view(np.int32))


def test_hierarchical_instances_backend_parity():
    """Four instanced triangles under a chain of transforms
    (``utils/scenes.hierarchy_root``): the same image from both backends,
    and each equal to the JAX package's frame on the same backend."""
    import test_render_e2e as je2e
    from myrenderer_tpu import SceneNode as JSceneNode
    from myrenderer_tpu import math3d as jmath3d
    from myrenderer_tpu.renderer.surface import Surface as JSurface

    def jax_build(backend):
        rend, window = je2e.make_renderer(96, 128, backend=backend)
        pipe, layout = je2e.flat_pipeline(rend)
        root = JSceneNode.create(rend)
        root.set_xform(jmath3d.translate([0.05, 0.05, 0.0]))
        colors = [(1, 0, 0), (0, 1, 0), (1, 1, 0), (0, 1, 1)]
        group = root
        for i in range(4):
            child = JSceneNode.create(rend)
            child.set_xform(jmath3d.translate([0.18, 0.12, 0.0]))
            child.add_child(je2e.triangle_node(
                rend, pipe, layout, [(0.0, 0.0), (0.22, 0.0), (0.0, 0.22)],
                color=colors[i]))
            group.add_child(child)
            group = child
        surf = JSurface.create_window_scene(rend, window, root)
        surf.set_perspective(je2e.ortho_unit())
        return np.asarray(je2e.render_frame(rend, [surf],
                                            clear=(0, 0, 0, 1)))

    def build(backend):
        rend, window = scenes.make_renderer(96, 128, backend=backend,
                                            device="cpu")
        root = scenes.hierarchy_root(rend)
        surf = scenes.window_surface(rend, window, root)
        return scenes.render_frame(rend, [surf], clear=(0, 0, 0, 1))

    fb_o, fb_p = build("oracle"), build("auto")
    np.testing.assert_array_equal(fb_o[..., 3] > 0.5, fb_p[..., 3] > 0.5)
    np.testing.assert_allclose(fb_o, fb_p, atol=5e-4)
    found = {tuple(np.round(c, 2)) for c in
             fb_o[fb_o[..., 3] > 0.5].reshape(-1, 4)[:, :3].tolist()}
    assert len(found) >= 4
    for fb, backend in ((fb_o, "oracle"), (fb_p, "pallas")):
        np.testing.assert_array_equal(jax_build(backend).view(np.int32),
                                      fb.view(np.int32))


def test_perspective_correct_interpolation():
    """A triangle with a large depth gradient: varyings interpolate
    perspective-correctly (attr/w linear in screen space), against the
    analytic value at a pixel centre, on both backends."""
    H, W = 64, 128

    def cv(x, y, z, w, c):
        return [x * w, y * w, z * w, w], c

    verts = [cv(-0.9, 0.9, 0.5, 1.0, (1, 0, 0, 1)),
             cv(0.9, 0.9, 0.5, 10.0, (0, 1, 0, 1)),
             cv(-0.9, -0.9, 0.5, 1.0, (1, 0, 0, 1))]
    clip = np.array([[v[0] for v in verts]], np.float32)
    vary = np.array([[v[1] for v in verts]], np.float32)
    tc = setup(clip, vary, H, W)
    _d, w_ref = raster_ref.rasterize_visibility(tc, H, W)
    px, py = rc.pixel_grids(H, W)
    varp, _cov = rc.resolve_varyings(tc, torch.clamp(w_ref, min=0), px, py)
    varp = varp.numpy()
    covered = w_ref.numpy() >= 0
    assert covered.any()

    ys, xs = np.nonzero(covered)
    mid = len(ys) // 2
    y, x = int(ys[mid]), int(xs[mid])
    ndc = np.array([[v[0][0] / v[0][3], v[0][1] / v[0][3]] for v in verts])
    scr = np.stack([(ndc[:, 0] * 0.5 + 0.5) * W,
                    (0.5 - ndc[:, 1] * 0.5) * H], axis=1)
    T_mat = np.array([[scr[0, 0] - scr[2, 0], scr[1, 0] - scr[2, 0]],
                      [scr[0, 1] - scr[2, 1], scr[1, 1] - scr[2, 1]]])
    b01 = np.linalg.solve(T_mat, np.array([x + 0.5 - scr[2, 0],
                                           y + 0.5 - scr[2, 1]]))
    beta = np.array([b01[0], b01[1], 1 - b01.sum()])
    ws = np.array([1.0, 10.0, 1.0])
    cols = np.array([v[1] for v in verts], np.float64)
    expect = (beta / ws) @ cols / (beta / ws).sum()
    np.testing.assert_allclose(varp[y, x], expect, atol=1e-3)
    linear = beta @ cols
    assert abs(linear[1] - expect[1]) > 0.05

    _d2, w2, num, den, _ovf = raster.rasterize(tc, H, W, tri_clip=t(clip))
    np.testing.assert_array_equal(w2.numpy(), w_ref.numpy())
    varp_p = num.numpy()[:, y, x] / den.numpy()[y, x]
    np.testing.assert_allclose(varp_p, expect, atol=1e-3)
    # the oracle's planes (raster_ref.planes) are the tile path's, bit
    # for bit: tools/tpu_checks.py's plane check
    num_r, den_r = raster_ref.planes(tc, w_ref)
    np.testing.assert_array_equal(num_r.numpy().view(np.int32),
                                  num.numpy().view(np.int32))
    np.testing.assert_array_equal(den_r.numpy().view(np.int32),
                                  den.numpy().view(np.int32))


def test_exact_depth_tie_first_submitted_wins():
    """Two coplanar identical triangles: the 'less' test keeps the FIRST
    submitted on both backends."""
    H, W = 32, 128
    tri = np.array([[[-0.8, 0.8, 0.5, 1.0], [0.8, 0.8, 0.5, 1.0],
                     [-0.8, -0.8, 0.5, 1.0]]], np.float32)
    clip = np.concatenate([tri, tri])
    vary = np.stack([np.full((3, 4), [1, 0, 0, 1], np.float32),
                     np.full((3, 4), [0, 1, 0, 1], np.float32)])
    tc = setup(clip, vary, H, W)
    _d_r, w_r = raster_ref.rasterize_visibility(tc, H, W)
    w_r = w_r.numpy()
    assert (w_r >= 0).any() and (w_r[w_r >= 0] == 0).all(), \
        "oracle: first submitted must win exact ties"
    _d_p, w_p = raster.rasterize_visibility(tc, H, W, tri_clip=t(clip))
    np.testing.assert_array_equal(w_r, w_p.numpy())
    np.testing.assert_array_equal(np.asarray(jax_oracle(clip, vary, H,
                                                        W)[1]), w_r)


@pytest.mark.parametrize("name", [
    "test_big_triangle_path", "test_wide_pack_matches_narrow",
    "test_stream_window_boundaries", "test_fused_key_vs_two_key_sort_paths",
    "test_row_group_split_matches_single_group",
    "test_big_vs_binned_exact_tie_lowest_id_wins",
    "test_span_budget_scales_with_resolution",
    "test_banded_kernel_matches_single_band", "test_config_from_flag_slots",
    "test_auto_config_mapping", "test_auto_config_is_the_planner_default",
    "test_auto_config_reselects_on_resize"])
def test_tpu_configuration_cases(name):
    pytest.skip(f"{name}: TPU machinery, ROADMAP 0d")


def test_hierarchy_scene_draws_every_level():
    """``utils/scenes.hierarchy_root`` builds one node a level under the
    root, each with its own triangle (the scene above)."""
    rend, _ = scenes.make_renderer(32, 32, device="cpu")
    root = scenes.hierarchy_root(rend)
    assert isinstance(root, SceneNode)
    drawn = [n for n in root.walk() if n.backing_instance is not None]
    assert len(drawn) == 4
    np.testing.assert_allclose(root.xform, math3d.translate([0.05, 0.05, 0]))
