"""Eye-plane clipping of the PyTorch port against the JAX package on the
CPU: the cases of ``tests/test_clipping.py`` (its straddler from
``utils/scenes.py``), each with the JAX test's assertions, the port's
clip outputs bit-equal to the JAX package's (jitted, whose compiler
contracts the lerps into FMAs as the port spells them) and winners
equal."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from myrenderer_tpu.ops import raster_common as jrc
from myrenderer_tpu.ops import raster_ref as jrr
from myrenderer_tpu_torch.ops import raster, raster_ref
from myrenderer_tpu_torch.ops import raster_common as rc
from myrenderer_tpu_torch.utils.scenes import straddler
from myrenderer_tpu_torch.utils.trisets import random_triangles

torch.set_num_threads(1)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def assert_bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a.view(np.int32) if a.dtype.itemsize == 4
                                  else a, b.view(np.int32)
                                  if b.dtype.itemsize == 4 else b)


def clip_both(clip, vary):
    """_clip_straddlers through both packages, outputs bit-equal."""
    want = jax.jit(jrc._clip_straddlers)(clip, vary)
    got = rc._clip_straddlers(t(clip), t(vary))
    for a, b in zip(want, got):
        assert_bits_equal(a, b.numpy())
    return [g.numpy() for g in got]


def test_clip_one_inside_vertex_geometry():
    clip = np.array([[[0.0, 0.0, 0.5, 1.0], [1.0, 0.0, 0.5, -1.0],
                      [-1.0, 0.0, 0.5, -3.0]]], np.float32)
    vary = np.tile(np.eye(3, 4, dtype=np.float32)[None], (1, 1, 1))
    t1c, t1v, _t2c, _t2v, v1, v2 = clip_both(clip, vary)
    assert bool(v1[0]) and not bool(v2[0])
    t1c = t1c[0]
    np.testing.assert_allclose(t1c[0], [0.0, 0.0, 0.5, 1.0])
    np.testing.assert_allclose(t1c[1:, 3], rc.W_CLIP, atol=5e-7)
    assert (t1c[1:, 3] > rc.W_EPS).all()
    t01 = (rc.W_CLIP - 1.0) / (-2.0)
    np.testing.assert_allclose(t1c[1, 0], t01, rtol=1e-5)
    t20 = (rc.W_CLIP + 3.0) / 4.0
    np.testing.assert_allclose(t1c[2, 0], -1.0 + t20, rtol=1e-5)
    np.testing.assert_allclose(t1v[0][1, 0], 1.0 - t01, rtol=1e-5)
    np.testing.assert_allclose(t1v[0][1, 1], t01, rtol=1e-5)


def test_clip_two_inside_vertices_quad():
    clip = np.array([[[0.0, 0.0, 0.5, -1.0], [1.0, 0.0, 0.5, 2.0],
                      [-1.0, 0.0, 0.5, 3.0]]], np.float32)
    t1c, _t1v, t2c, _t2v, v1, v2 = clip_both(clip, np.zeros((1, 3, 4),
                                                            np.float32))
    assert bool(v1[0]) and bool(v2[0])
    t1c, t2c = t1c[0], t2c[0]
    np.testing.assert_allclose(t1c[1], [1.0, 0.0, 0.5, 2.0])
    np.testing.assert_allclose(t1c[2], [-1.0, 0.0, 0.5, 3.0])
    np.testing.assert_allclose(t2c[1], [-1.0, 0.0, 0.5, 3.0])
    np.testing.assert_allclose(t1c[0], t2c[0])
    np.testing.assert_allclose([t1c[0, 3], t2c[2, 3]], rc.W_CLIP, atol=5e-7)


def clip_near(clip, vary, valid, cap):
    """The port's clip stage and the JAX package's: (port Triangles,
    port valid, overflow), the clipped stream and flag bit-equal."""
    want = jax.jit(lambda c, v, m: jrc.clip_near_capacity(c, v, m, cap=cap))(
        clip, vary, valid)
    tris, v, ovf = rc.clip_near_capacity(rc.Triangles(t(clip), t(vary)),
                                         t(valid), cap)
    for a, b in zip((want[0], want[1], want[2], want[5]),
                    (tris.clip, tris.vary, v, ovf)):
        assert_bits_equal(a, b.numpy())
    return tris, v, bool(ovf)


def test_clipped_triangles_keep_facing():
    clip, vary = straddler()
    tris, v, ovf = clip_near(clip, vary, np.ones(1, bool), 4)
    assert not ovf
    tc = rc.triangle_setup(tris.clip, tris.vary, v, 64, 64, "back")
    valid = tc.valid.numpy()
    assert not valid[0], "the straddler itself must still be dropped"
    assert valid[1:].sum() == 2, "both clipped pieces must survive facing/w"


def test_clip_matches_manual_preclip_coverage():
    """Rendering through the clip stage covers the same pixels as
    rendering analytically pre-clipped geometry (edge pixels may flip by
    1 ulp: bounded); both oracle frames equal the JAX package's."""
    H = W = 96
    clip, vary = straddler()
    tris, v, _ = clip_near(clip, vary, np.ones(1, bool), 4)
    tc = rc.triangle_setup(tris.clip, tris.vary, v, W, H, "back")
    _d, win = raster_ref.rasterize_visibility(tc, H, W)
    got = win.numpy() >= 0

    vv = clip[0].astype(np.float64)
    inside = vv[:, 3] > rc.W_EPS
    assert inside.sum() == 2
    b = int(np.argmax(~inside))
    i0, i1, i2 = b, (b + 1) % 3, (b + 2) % 3

    def isect(i, j):
        s = (rc.W_CLIP - vv[i, 3]) / (vv[j, 3] - vv[i, 3])
        return vv[i] + s * (vv[j] - vv[i])

    q = [isect(i0, i1), vv[i1], vv[i2], isect(i2, i0)]
    man_clip = np.stack([[q[0], q[1], q[2]], [q[0], q[2], q[3]]]) \
        .astype(np.float32)
    man_vary = np.zeros((2, 3, 4), np.float32)
    tcm = rc.triangle_setup(t(man_clip), t(man_vary),
                            torch.ones(2, dtype=torch.bool), W, H, "back")
    _dm, winm = raster_ref.rasterize_visibility(tcm, H, W)
    want = winm.numpy() >= 0
    assert want.sum() > 100, "pre-clipped reference must cover pixels"
    assert (got != want).mean() < 5e-3
    jwinm = jax.jit(lambda c, v: jrr.rasterize_visibility(
        jrc.triangle_setup(c, v, jnp.ones(2, bool), W, H, "back"), H, W)[1])(
            man_clip, man_vary)
    np.testing.assert_array_equal(np.asarray(jwinm), winm.numpy())


def test_clip_backend_parity():
    """A straddler among random triangles: the tile path and the oracle
    decision-exact on the same clipped stream, and equal to the JAX
    oracle's winners."""
    H, W = 48, 160
    clip, vary = random_triangles(20, 9)
    sc, sv = straddler()
    clip = np.concatenate([clip[:10], sc, clip[10:]])
    vary = np.concatenate([vary[:10], sv, vary[10:]])
    tris, v, _ = clip_near(clip, vary, np.ones(21, bool), 4)
    tc = rc.triangle_setup(tris.clip, tris.vary, v, W, H, "back")
    _d_ref, w_ref = raster_ref.rasterize_visibility(tc, H, W)
    _d_t, w_t = raster.rasterize_visibility(tc, H, W, tri_clip=tris.clip)
    np.testing.assert_array_equal(w_ref.numpy(), w_t.numpy())
    jw = jax.jit(lambda c, vr, m: jrr.rasterize_visibility(
        jrc.triangle_setup(*jrc.clip_near_capacity(c, vr, m, cap=4)[:3],
                           W, H, "back"), H, W)[1])(clip, vary,
                                                    np.ones(21, bool))
    np.testing.assert_array_equal(np.asarray(jw), w_ref.numpy())
    assert int((w_ref.numpy() >= 21).sum()) > 0     # clipped pieces win


def test_no_straddlers_is_identity():
    H, W = 32, 128
    clip, vary = random_triangles(12, 4)
    valid = np.ones(12, bool)
    tris, v, ovf = clip_near(clip, vary, valid, 8)
    assert not ovf
    tc0 = rc.triangle_setup(t(clip), t(vary), t(valid), W, H, "back")
    tc1 = rc.triangle_setup(tris.clip, tris.vary, v, W, H, "back")
    _d0, w0 = raster_ref.rasterize_visibility(tc0, H, W)
    _d1, w1 = raster_ref.rasterize_visibility(tc1, H, W)
    np.testing.assert_array_equal(w0.numpy(), w1.numpy())


def test_clip_capacity_overflow_flag():
    c, v = straddler()
    many_c, many_v = np.tile(c, (9, 1, 1)), np.tile(v, (9, 1, 1))
    assert clip_near(many_c, many_v, np.ones(9, bool), 8)[2]
    assert not clip_near(many_c, many_v, np.ones(9, bool), 16)[2]
