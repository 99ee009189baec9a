"""The JAX package's end-to-end behaviour suite (``tests/test_render_e2e.py``)
through the PyTorch port on the CPU.

Each case builds its scene in both packages: the JAX side with the JAX
test's own helpers (or its inline code, copied), the port's with
``myrenderer_tpu_torch/utils/scenes.py``, which ``chip_smoke.py`` also
drives on the card. The port's ``"auto"`` stands for the JAX
``"pallas"`` (interpret mode) and ``"oracle"`` for ``"oracle"``. Winners
must be equal (``debug_winner``), framebuffers bit-equal, and every
assertion of the JAX test holds on the port's frame.

Cases ported elsewhere: the capacity-ladder cases
(``test_late_big_list_overflow_triggers_rebuild``,
``test_stream_overflow_triggers_rebuild``,
``test_precompile_capacity_bump_warms_next_plan``,
``test_overflow_detection_window_is_bounded``) are in
``test_torch_compiled.py``, ``test_frame_stats`` in
``test_torch_sequential.py``. The scripted scenes of ``utils/scenes.py``
run frame by frame in ``test_torch_scenes.py``."""

import functools
import types
import unittest.mock as mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import myrenderer_tpu as jmr
import myrenderer_tpu_torch as tmr
import test_render_e2e as je2e
from myrenderer_tpu.content.polygon import Polygon as JPolygon
from myrenderer_tpu.ops.raster_common import PlanarTris
from myrenderer_tpu.ops.sampling import sample_bilinear as jbilinear
from myrenderer_tpu.ops.sampling import sample_nearest as jnearest
from myrenderer_tpu.ops.vertex_stage import bitcast_u32 as jbitcast_u32
from myrenderer_tpu.renderer import draw as jdraw_mod
from myrenderer_tpu.renderer.pipeline import (BUILTIN_TRANSFORM,
                                              TEXTURE_SAMPLER, TEXTURE_VIEW,
                                              UNMANAGED_BUFFER)
from myrenderer_tpu_torch.content.polygon import Polygon
from myrenderer_tpu_torch.ops.vertex_stage import matvec4
from myrenderer_tpu_torch.renderer import draw as tdraw_mod
from myrenderer_tpu_torch.renderer.pipeline import _fragment_arity
from myrenderer_tpu_torch.utils import scenes

torch.set_num_threads(1)

JAX = types.SimpleNamespace(
    name="jax", pkg=jmr, tile="pallas", draw_mod=jdraw_mod, polygon=JPolygon,
    make_renderer=je2e.make_renderer, flat_pipeline=je2e.flat_pipeline,
    triangle_node=je2e.triangle_node, ortho_unit=je2e.ortho_unit,
    render_frame=je2e.render_frame, checker=je2e._checker_texture,
    textured_quad=je2e._textured_quad)
TORCH = types.SimpleNamespace(
    name="torch", pkg=tmr, tile="auto", draw_mod=tdraw_mod, polygon=Polygon,
    make_renderer=functools.partial(scenes.make_renderer, device="cpu"),
    flat_pipeline=scenes.flat_pipeline, triangle_node=scenes.triangle_node,
    ortho_unit=scenes.ortho_unit, render_frame=scenes.render_frame,
    checker=scenes.checker_texture, textured_quad=scenes.textured_quad)
APIS = (JAX, TORCH)


def surface(api, rend, window, node, perspective=None):
    surf = api.pkg.Surface.create_window_scene(rend, window, node)
    surf.set_perspective(api.ortho_unit() if perspective is None
                         else perspective)
    return surf


def winners(rend, draw_index=-1):
    return [np.asarray(w) for w in rend.draws[draw_index].last_winners]


def both(build):
    """Run ``build(api)`` -> (framebuffer, winners, ...) through both
    packages; the winners must be equal and the framebuffers bit-equal.
    Returns the port's result."""
    jout, tout = build(JAX), build(TORCH)
    assert len(jout[1]) == len(tout[1]) > 0
    for a, b in zip(jout[1], tout[1]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.asarray(jout[0]).view(np.int32),
                                  tout[0].view(np.int32))
    return tout


def flat_scene(pts, clear, backend=None, size=(64, 64), color=(1, 0, 0)):
    def build(api):
        rend, window = api.make_renderer(*size, **(
            {} if backend is None else {"backend": backend(api)}))
        rend.debug_winner = True
        pipe, layout = api.flat_pipeline(rend)
        node = api.triangle_node(rend, pipe, layout, pts, color=color)
        fb = api.render_frame(rend, [surface(api, rend, window, node)],
                              clear=clear)
        return fb, winners(rend)
    return build


def test_flat_triangle_offscreen():
    fb, _ = both(flat_scene([(0.1, 0.1), (0.9, 0.1), (0.1, 0.9)],
                            (0.0, 0.0, 1.0, 1.0)))
    assert fb.shape == (64, 64, 4)
    red = (fb[..., 0] > 0.9) & (fb[..., 1] < 0.1) & (fb[..., 2] < 0.1)
    blue = (fb[..., 2] > 0.9) & (fb[..., 0] < 0.1)
    assert red[int(0.2 * 64), int(0.2 * 64)]
    assert blue[int(0.8 * 64), int(0.8 * 64)]
    assert 0.28 < red.mean() < 0.36
    assert (red | blue).all()


def test_ccw_triangle_backface_culled():
    fb, win = both(flat_scene([(0.1, 0.1), (0.1, 0.9), (0.9, 0.1)],
                              (0.0, 0.0, 1.0, 1.0)))
    assert (fb[..., 2] > 0.9).all(), "back-facing triangle must be culled"
    assert (win[0] < 0).all()


def jax_depth_node(rend, layout, z, color):
    """``test_depth_order_and_ties``'s ``tri_at`` (JAX)."""
    vb = jmr.VertexBuffer.new(rend, 0, 1, layout)
    vb.write_vertices(np.array([[x, y, *color] for x, y in
                                [(0.0, 0.0), (1.0, 0.0), (0.0, 1.0)]],
                               np.float32))

    def vfn(ctx, z=z):
        p = ctx.attr("pos")
        clip = ctx.world @ jnp.array([p[0], p[1], z, 1.0], jnp.float32)
        c = ctx.attr("color")
        return clip, jnp.array([c[0], c[1], c[2], 1.0], jnp.float32)

    pz = jmr.Pipeline.create(rend, vertex_fn=vfn,
                             bindings=[jmr.BindingLayout(0, BUILTIN_TRANSFORM)],
                             vertex_layout=layout)
    node = jmr.Instance.create_node(rend, pipeline=pz,
                                    bounding_box_p0=(0, 0, 0),
                                    bounding_box_p1=(1, 1, 2))
    node.get_backing().set_vertex_buffer(vb)
    return node


@pytest.mark.parametrize("order", ["far first", "near first"])
def test_depth_order_and_ties(order):
    """Nearer z wins regardless of submission order (the JAX test draws
    the far triangle first; here also second)."""
    def build(api):
        rend, window = api.make_renderer()
        rend.debug_winner = True
        layout = api.pkg.VertexLayout.create([("pos", 2), ("color", 3)])
        make = jax_depth_node if api is JAX else scenes.depth_node
        tris = [make(rend, layout, 1.5, (1.0, 0.0, 0.0)),
                make(rend, layout, 0.5, (0.0, 1.0, 0.0))]
        root = api.pkg.SceneNode.create(rend)
        for t in (tris if order == "far first" else tris[::-1]):
            root.add_child(t)
        fb = api.render_frame(rend, [surface(api, rend, window, root)])
        return fb, winners(rend)

    fb, _ = both(build)
    assert fb[10, 10, 1] > 0.9 and fb[10, 10, 0] < 0.1


def test_scene_transform_propagation():
    def build(api):
        rend, window = api.make_renderer()
        rend.debug_winner = True
        pipe, layout = api.flat_pipeline(rend)
        tri = api.triangle_node(rend, pipe, layout,
                                [(0.0, 0.0), (0.4, 0.0), (0.0, 0.4)])
        root = api.pkg.SceneNode.create(rend)
        root.add_child(tri)
        root.set_xform(api.pkg.math3d.translate([0.5, 0.5, 0.0]))
        fb = api.render_frame(rend, [surface(api, rend, window, root)],
                              clear=(0, 0, 0, 1))
        return fb, winners(rend)

    fb, _ = both(build)
    red = fb[..., 0] > 0.9
    assert red[int(0.55 * 64), int(0.55 * 64)]
    assert not red[int(0.1 * 64), int(0.1 * 64)]


def test_multi_surface_clear_then_load():
    def build(api):
        rend, window = api.make_renderer()
        rend.debug_winner = True
        pipe, layout = api.flat_pipeline(rend)
        t1 = api.triangle_node(rend, pipe, layout,
                               [(0.0, 0.0), (1.0, 0.0), (0.0, 1.0)],
                               color=(1.0, 0.0, 0.0))
        t2 = api.triangle_node(rend, pipe, layout,
                               [(0.5, 0.5), (1.0, 0.5), (0.5, 1.0)],
                               color=(0.0, 1.0, 0.0))
        fb = api.render_frame(rend, [surface(api, rend, window, t1),
                                     surface(api, rend, window, t2)],
                              clear=(0, 0, 1, 1))
        return fb, winners(rend)

    fb, _ = both(build)
    assert fb[5, 5, 0] > 0.9
    assert fb[int(0.6 * 64), int(0.6 * 64), 1] > 0.9
    assert fb[int(0.6 * 64), int(0.98 * 64), 2] > 0.9


@pytest.mark.parametrize("api", APIS, ids=lambda a: a.name)
def test_surface_dedupe_per_frame(api):
    """A surface draws at most once per frame, through both packages."""
    rend, window = api.make_renderer()
    pipe, layout = api.flat_pipeline(rend)
    node = api.triangle_node(rend, pipe, layout,
                             [(0.0, 0.0), (1.0, 0.0), (0.0, 1.0)])
    surf = surface(api, rend, window, node)
    draw = api.pkg.Draw.create(rend)
    draw.begin()
    draw.clear((0, 0, 1, 1))
    draw.draw_surface(surf)
    draw.draw_surface(surf)  # must be ignored
    draw.end()
    assert len(draw._items) == 1
    rend.update()
    draw.begin()
    draw.clear((0, 0, 1, 1))
    draw.draw_surface(surf)
    assert len(draw._items) == 1


def test_culled_when_behind_camera():
    fb, win = both(flat_scene([(5.0, 5.0), (6.0, 5.0), (5.0, 6.0)],
                              (0, 0, 1, 1)))
    assert (fb[..., 2] > 0.9).all()
    assert (win[0] < 0).all()


def test_moved_child_outside_parent_box_still_renders():
    def build(api):
        rend, window = api.make_renderer()
        rend.debug_winner = True
        pipe, layout = api.flat_pipeline(rend)
        child = api.triangle_node(rend, pipe, layout,
                                  [(5.1, 5.1), (5.9, 5.1), (5.1, 5.9)])
        root = api.pkg.SceneNode.create(rend)
        root.set_bounding_box((4.0, 4.0, 0.0), (7.0, 7.0, 2.0))
        root.add_child(child)
        assert root.has_finite_aabb
        child.set_xform(api.pkg.math3d.translate((-5.0, -5.0, 0.0)))
        fb = api.render_frame(rend, [surface(api, rend, window, root)],
                              clear=(0, 0, 1, 1))
        return fb, winners(rend)

    fb, _ = both(build)
    red = (fb[..., 0] > 0.9) & (fb[..., 2] < 0.1)
    assert red.any(), "visible child was culled by its parent's stale box"
    assert red[int(0.3 * 64), int(0.3 * 64)]


def test_frame_program_cache_reuse():
    """Three frames of one scene: one frame plan (the JAX package's one
    program in ``draw._program_cache``; the port's ``draw._plans``)."""
    for api in APIS:
        rend, window = api.make_renderer()
        pipe, layout = api.flat_pipeline(rend)
        node = api.triangle_node(rend, pipe, layout,
                                 [(0.1, 0.1), (0.9, 0.1), (0.1, 0.9)])
        surf = surface(api, rend, window, node)
        draw = api.pkg.Draw.create(rend)
        for _ in range(3):
            draw.begin()
            draw.clear((0, 0, 0, 1))
            draw.draw_surface(surf)
            draw.end()
            rend.update()
        cache = draw._program_cache if api is JAX else draw._plans
        assert len(cache) == 1


def jax_instanced_node(rend):
    layout = jmr.VertexLayout.create([("pos", 2), ("color", 3)])

    def vfn(ctx):
        p = ctx.attr("pos")
        off = ctx.draw_instance.astype(jnp.float32) * 0.3
        clip = ctx.world @ jnp.stack([p[0] + off, p[1],
                                      jnp.float32(1.0), jnp.float32(1.0)])
        c = ctx.attr("color")
        return clip, jnp.stack([c[0], c[1], c[2], jnp.float32(1.0)])

    pipe = jmr.Pipeline.create(
        rend, vertex_fn=vfn,
        bindings=[jmr.BindingLayout(0, BUILTIN_TRANSFORM)],
        vertex_layout=layout)
    vb = jmr.VertexBuffer.new(rend, 0, 1, layout)
    vb.write_vertices(np.array([[0.05, 0.1, 1, 0, 0], [0.25, 0.1, 1, 0, 0],
                                [0.05, 0.5, 1, 0, 0]], np.float32))
    vb.instance_count = 3
    node = jmr.Instance.create_node(rend, pipeline=pipe,
                                    bounding_box_p0=(0, 0, 0),
                                    bounding_box_p1=(1, 1, 2))
    node.get_backing().set_vertex_buffer(vb)
    return node


def node_scene(jax_make, torch_make, clear=(0, 0, 1, 1), backend=None,
               size=(64, 64), perspective=None):
    """A one-node scene built by ``jax_make(rend)`` / ``torch_make(rend)``."""
    def build(api):
        rend, window = api.make_renderer(*size, **(
            {} if backend is None else {"backend": backend(api)}))
        rend.debug_winner = True
        node = (jax_make if api is JAX else torch_make)(rend)
        persp = None if perspective is None else perspective(api)
        fb = api.render_frame(rend, [surface(api, rend, window, node,
                                             persp)], clear=clear)
        return fb, winners(rend), rend
    return build


def test_instanced_draw():
    fb, _, _ = both(node_scene(jax_instanced_node, scenes.instanced_node))
    red = fb[..., 0] > 0.9
    for cx in (0.08, 0.38, 0.68):
        assert red[int(0.15 * 64), int(cx * 64)], cx
    assert not red[int(0.15 * 64), int(0.95 * 64)]


def jax_vertex_textured_node(rend):
    layout = jmr.VertexLayout.create([("pos", 2), ("uv", 2)])
    tex = np.zeros((2, 2, 4), np.float32)
    tex[0, 0] = tex[1, 1] = [1, 0, 0, 1]
    tex[0, 1] = tex[1, 0] = [0, 1, 0, 1]

    def vfn(ctx):
        p = ctx.attr("pos")
        clip = ctx.world @ jnp.stack([p[0], p[1], jnp.float32(1.0),
                                      jnp.float32(1.0)])
        return clip, jnearest(ctx.binding(1), ctx.attr("uv"))

    pipe = jmr.Pipeline.create(
        rend, vertex_fn=vfn,
        bindings=[jmr.BindingLayout(0, BUILTIN_TRANSFORM),
                  jmr.BindingLayout(1, TEXTURE_VIEW)],
        vertex_layout=layout)
    vb = jmr.VertexBuffer.new(rend, 0, 1, layout)
    vb.write_vertices(np.array([[0.0, 0.0, 0.2, 0.2], [1.0, 0.0, 0.2, 0.2],
                                [0.0, 1.0, 0.2, 0.2]], np.float32))
    node = jmr.Instance.create_node(
        rend, pipeline=pipe, bindings=[jmr.Binding(1, attachment=tex)],
        bounding_box_p0=(0, 0, 0), bounding_box_p1=(1, 1, 2))
    node.get_backing().set_vertex_buffer(vb)
    return node


def test_textured_pipeline():
    fb, _, _ = both(node_scene(jax_vertex_textured_node,
                               scenes.vertex_textured_node))
    assert fb[10, 10, 0] > 0.9 and fb[10, 10, 1] < 0.1


def jax_u32_node(rend):
    """``test_u32_binding_roundtrip``'s node (JAX)."""
    import struct
    layout = jmr.VertexLayout.create([("pos", 2)])

    def vfn(ctx):
        p = ctx.attr("pos")
        clip = ctx.world @ jnp.stack([p[0], p[1], jnp.float32(1.0),
                                      jnp.float32(1.0)])
        buf = ctx.binding(1)
        ok = ((jbitcast_u32(buf[1]) == jnp.uint32(7))
              & (jbitcast_u32(buf[2]) == jnp.uint32(0xFFC00123))
              & (jbitcast_u32(buf[3]) == jnp.uint32(0xDEADBEEF)))
        g = jnp.where(ok, buf[0], jnp.float32(0.0))
        return clip, jnp.stack([jnp.float32(0.0), g, jnp.float32(0.0),
                                jnp.float32(1.0)])

    pipe = jmr.Pipeline.create(
        rend, vertex_fn=vfn,
        bindings=[jmr.BindingLayout(0, BUILTIN_TRANSFORM),
                  jmr.BindingLayout(1, UNMANAGED_BUFFER)],
        vertex_layout=layout)
    vb = jmr.VertexBuffer.new(rend, 0, 1, layout)
    vb.write_vertices(np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]],
                               np.float32))
    node = jmr.Instance.create_node(
        rend, pipeline=pipe, bindings=[jmr.Binding(1, size=16)],
        bounding_box_p0=(0, 0, 0), bounding_box_p1=(1, 1, 2))
    inst = node.get_backing()
    inst.update_buffer(1, np.float32(0.75))
    inst.update_buffer(1, np.uint32(7), byte_offset=4)
    inst.update_buffer(1, np.uint32(0xFFC00123), byte_offset=8)
    inst.update_buffer(1, struct.pack("<I", 0xDEADBEEF), byte_offset=12)
    inst.set_vertex_buffer(vb)
    return node


def test_u32_binding_roundtrip():
    """f32, u32, a NaN bit pattern and raw bytes in one managed binding
    round-trip bit-exactly (the staging words equal the JAX package's)."""
    fb, _, rend = both(node_scene(jax_u32_node, scenes.u32_node))
    np.testing.assert_allclose(fb[10, 10], [0.0, 0.75, 0.0, 1.0], atol=1e-6)
    jrend, _ = je2e.make_renderer()
    np.testing.assert_array_equal(
        rend.instances[0].stores[1].host,
        jax_u32_node(jrend).get_backing().stores[1].host)


def jax_straddler_node(rend):
    layout = jmr.VertexLayout.create([("pos", 2)])
    verts = jnp.asarray(scenes.STRADDLER_CLIP)

    def vfn(ctx):
        return verts[ctx.vertex_index % 3], jnp.array([1.0, 0.0, 0.0, 1.0],
                                                      jnp.float32)

    pipe = jmr.Pipeline.create(
        rend, vertex_fn=vfn,
        bindings=[jmr.BindingLayout(0, BUILTIN_TRANSFORM)],
        vertex_layout=layout)
    vb = jmr.VertexBuffer.new(rend, 0, 1, layout)
    vb.write_vertices(np.zeros((3, 2), np.float32))
    node = jmr.Instance.create_node(rend, pipeline=pipe)
    node.get_backing().set_vertex_buffer(vb)
    return node


@pytest.mark.parametrize("backend", ["oracle", "tile"])
def test_eye_straddling_triangle_renders(backend):
    """A triangle with a vertex behind the eye renders its visible part,
    both backends (the port's clip positions come from vertex
    attributes, the JAX test's from a constant)."""
    fb, win, _ = both(node_scene(
        jax_straddler_node, scenes.straddler_node,
        backend=lambda api: api.tile if backend == "tile" else "oracle",
        perspective=lambda api: api.pkg.math3d.identity()))
    red = (fb[..., 0] > 0.9) & (fb[..., 2] < 0.1)
    assert red.sum() > 300, "visible part of the straddler must render"
    assert red[int(0.7 * 64), 32]
    assert (win[-1] >= 1).sum() > 300      # the clipped pieces won


def test_window_resize():
    def build(api):
        rend, window = api.make_renderer(64, 64)
        rend.debug_winner = True
        pipe, layout = api.flat_pipeline(rend)
        node = api.triangle_node(rend, pipe, layout,
                                 [(0.1, 0.1), (0.9, 0.1), (0.1, 0.9)])
        surf = surface(api, rend, window, node)
        fb = api.render_frame(rend, [surf], clear=(0, 0, 1, 1))
        assert fb.shape == (64, 64, 4)
        surf.resize((96, 48))
        fb2 = api.render_frame(rend, [surf], clear=(0, 0, 1, 1))
        return fb2, winners(rend)

    fb2, win = both(build)
    assert fb2.shape == (48, 96, 4) and win[0].shape == (48, 96)
    assert (fb2[..., 0] > 0.9).any()


@pytest.mark.parametrize("api", APIS, ids=lambda a: a.name)
def test_empty_surface(api):
    rend, window = api.make_renderer()
    empty = api.pkg.SceneNode.create(rend)
    fb = api.render_frame(rend, [surface(api, rend, window, empty)],
                          clear=(0, 0, 1, 1))
    assert (np.asarray(fb)[..., 2] > 0.9).all()


def jax_sampler_node(rend, use_bilinear):
    layout = jmr.VertexLayout.create([("pos", 2), ("uv", 2)])
    tex = np.zeros((2, 2, 4), np.float32)
    tex[:, :] = [0, 0, 1, 1]
    tex[0, 0] = [1, 0, 0, 1]

    def vfn(ctx):
        p = ctx.attr("pos")
        clip = ctx.world @ jnp.stack([p[0], p[1], jnp.float32(1.0),
                                      jnp.float32(1.0)])
        bilinear = ctx.binding(2)[0] > 0.5
        col = jnp.where(bilinear, jbilinear(ctx.binding(1), ctx.attr("uv")),
                        jnearest(ctx.binding(1), ctx.attr("uv")))
        return clip, col

    pipe = jmr.Pipeline.create(
        rend, vertex_fn=vfn,
        bindings=[jmr.BindingLayout(0, BUILTIN_TRANSFORM),
                  jmr.BindingLayout(1, TEXTURE_VIEW),
                  jmr.BindingLayout(2, TEXTURE_SAMPLER)],
        vertex_layout=layout)
    vb = jmr.VertexBuffer.new(rend, 0, 1, layout)
    vb.write_vertices(np.array([[0.0, 0.0, 0.5, 0.5], [1.0, 0.0, 0.5, 0.5],
                                [0.0, 1.0, 0.5, 0.5]], np.float32))
    node = jmr.Instance.create_node(
        rend, pipeline=pipe,
        bindings=[jmr.Binding(1, attachment=tex),
                  jmr.Binding(2, attachment=np.array([use_bilinear],
                                                     np.float32))],
        bounding_box_p0=(0, 0, 0), bounding_box_p1=(1, 1, 2))
    node.get_backing().set_vertex_buffer(vb)
    return node


@pytest.mark.parametrize("use_bilinear", [0.0, 1.0])
def test_texture_sampler_binding_kind(use_bilinear):
    fb, _, _ = both(node_scene(
        lambda r: jax_sampler_node(r, use_bilinear),
        lambda r: scenes.sampler_node(r, use_bilinear), clear=(0, 1, 0, 1)))
    want = [0.25, 0.0, 0.75, 1.0] if use_bilinear else [0.0, 0.0, 1.0, 1.0]
    np.testing.assert_allclose(fb[10, 10], want, atol=1e-5)


def jax_planar_build(batch):
    """``test_planar_batch_vertex_interface``'s ``build`` (JAX)."""
    pts, zs = scenes.PLANAR_PTS, scenes.PLANAR_Z

    def vertex_fn(ctx):
        vi = ctx.vertex_index
        p = jnp.asarray(pts)[vi]
        z = jnp.asarray(zs)[vi // 3]
        clip = ctx.world @ jnp.array([p[0], p[1], z, 1.0], jnp.float32)
        return clip, jnp.array(scenes.PLANAR_COLOR, jnp.float32)

    def vertex_batch_fn(ctx):
        w = ctx.worlds[0]
        p = jnp.asarray(pts).reshape(2, 3, 2)
        hom = jnp.stack([p[:, :, 0], p[:, :, 1],
                         jnp.broadcast_to(jnp.asarray(zs)[:, None], (2, 3)),
                         jnp.ones((2, 3))], -1)
        clip = jnp.einsum("ab,tkb->tka", w, hom)
        vary = jnp.broadcast_to(jnp.array(scenes.PLANAR_COLOR, jnp.float32),
                                (2, 3, 4))
        return PlanarTris.from_interleaved(clip, vary)

    rend, window = je2e.make_renderer(64, 64, backend="pallas")
    rend.debug_winner = True
    pipe = jmr.Pipeline.create(
        rend, vertex_fn=vertex_fn,
        vertex_batch_fn=vertex_batch_fn if batch else None,
        bindings=[jmr.BindingLayout(0, BUILTIN_TRANSFORM)])
    vb = jmr.VertexBuffer.new(rend, 0, 2)
    node = jmr.Instance.create_node(rend, pipeline=pipe)
    node.get_backing().set_vertex_buffer(vb)
    fb = je2e.render_frame(rend, [surface(JAX, rend, window, node)],
                           clear=(0, 0, 1, 1))
    return fb, winners(rend, 0)


def torch_planar_build(batch):
    rend, window = TORCH.make_renderer(64, 64, backend="auto")
    rend.debug_winner = True
    node = scenes.planar_node(rend, batch)
    fb = scenes.render_frame(rend, [surface(TORCH, rend, window, node)],
                             clear=(0, 0, 1, 1))
    return fb, winners(rend, 0)


def test_planar_batch_vertex_interface():
    """The planar batch (``Triangles(planar=True)``, the JAX package's
    ``PlanarTris``) renders pixel-identically to the vmapped path, in the
    port and against the JAX package's frames."""
    planar_fb, planar_win = torch_planar_build(True)
    vmapped_fb, vmapped_win = torch_planar_build(False)
    for wp, wv in zip(planar_win, vmapped_win):
        np.testing.assert_array_equal(wp, wv)
    assert (planar_win[0] >= 0).sum() > 100
    np.testing.assert_array_equal(planar_fb, vmapped_fb)
    for batch, (fb, win) in ((True, (planar_fb, planar_win)),
                             (False, (vmapped_fb, vmapped_win))):
        jfb, jwin = jax_planar_build(batch)
        np.testing.assert_array_equal(jwin[0], win[0])
        np.testing.assert_array_equal(np.asarray(jfb).view(np.int32),
                                      fb.view(np.int32))


def jax_hetero_root(rend):
    pipe_a, layout = je2e.flat_pipeline(rend)

    def inverted_fragment(c):
        return jnp.concatenate([1.0 - c[..., :3], c[..., 3:]], -1)

    def vfn(ctx):
        p = ctx.attr("pos")
        clip = ctx.world @ jnp.array([p[0], p[1], 1.0, 1.0], jnp.float32)
        c = ctx.attr("color")
        return clip, jnp.array([c[0], c[1], c[2], 1.0], jnp.float32)

    pipe_b = jmr.Pipeline.create(
        rend, vertex_fn=vfn, fragment_fn=inverted_fragment,
        bindings=[jmr.BindingLayout(0, BUILTIN_TRANSFORM)],
        vertex_layout=layout)
    root = jmr.SceneNode.create(rend)
    root.add_child(je2e.triangle_node(rend, pipe_a, layout,
                                      [(0.1, 0.1), (0.9, 0.1), (0.1, 0.9)],
                                      color=(1, 0, 0)))
    root.add_child(je2e.triangle_node(rend, pipe_b, layout,
                                      [(0.3, 0.9), (0.9, 0.3), (0.9, 0.9)],
                                      color=(1, 0, 0)))
    return root


def test_heterogeneous_fragment_programs_merge_into_one_pass():
    """Two pipelines with different fragment programs in ONE merged
    pass, pixels matching the sequential per-batch path; each path's
    frame equal to the JAX package's."""
    def build(api, merged):
        rend, window = api.make_renderer(64, 64, backend=api.tile)
        rend.debug_winner = rend.collect_stats = True
        root = (jax_hetero_root if api is JAX else scenes.hetero_root)(rend)
        surf = surface(api, rend, window, root)
        if merged:
            fb = api.render_frame(rend, [surf], clear=(0, 0, 1, 1))
        else:
            with mock.patch.object(api.draw_mod, "_mergeable",
                                   lambda plan: False):
                fb = api.render_frame(rend, [surf], clear=(0, 0, 1, 1))
        return fb, winners(rend, 0), rend.frame_stats

    fb_merged, win_merged, stats = both(lambda api: build(api, True))
    assert stats["merged"] is True and stats["fragment_programs"] == 2
    fb_seq, wins_seq, stats_seq = both(lambda api: build(api, False))
    assert stats_seq["merged"] is False and len(wins_seq) == 2
    red = (fb_merged[..., 0] > 0.9) & (fb_merged[..., 1] < 0.1) \
        & (fb_merged[..., 2] < 0.1)
    cyan = (fb_merged[..., 0] < 0.1) & (fb_merged[..., 1] > 0.9) \
        & (fb_merged[..., 2] > 0.9)
    assert red.any() and cyan.any()
    np.testing.assert_allclose(fb_merged, fb_seq, atol=1e-5)
    np.testing.assert_array_equal(
        win_merged[0] >= 0, (wins_seq[0] >= 0) | (wins_seq[1] >= 0))


@pytest.mark.parametrize("api", APIS, ids=lambda a: a.name)
def test_event_driven_window_lifecycle(api):
    core = api.pkg.Core(fixed_timestep=1.0 / 60.0)
    win = core.create_window(64, 32, "events")
    ev = core.next_event()
    assert ev is not None and ev.kind == "window_open"
    assert ev.window is win
    assert core.next_event() is None
    core.resize_window(win, 128, 32)
    ev = core.next_event()
    assert ev.kind == "framebuffer_resize" and ev.window is win
    assert tuple(win.framebuffer.shape) == (32, 128, 4)
    assert not core.should_close
    core.request_close(win)
    assert core.next_event().kind == "close"
    assert core.should_close


@pytest.mark.parametrize("api", APIS, ids=lambda a: a.name)
def test_vertex_buffer_refcounting(api):
    pkg = api.pkg
    rend, _ = api.make_renderer(32, 32)
    mod = api.polygon(rend)
    layout = api.polygon.GPU_VERTEX_LAYOUT
    vb1 = pkg.VertexBuffer.new(rend, 0, 2, layout)
    vb2 = pkg.VertexBuffer.new(rend, 0, 2, layout)
    a = pkg.Instance.create_node(rend, pipeline=mod.pipeline).get_backing()
    b = pkg.Instance.create_node(rend, pipeline=mod.pipeline).get_backing()
    a.set_vertex_buffer(vb1)
    b.set_vertex_buffer(vb1)          # shared: refcount 2
    assert vb1.refcount == 2 and vb1.has_buffer
    a.set_vertex_buffer(vb2)          # a lets go; vb1 survives via b
    assert vb1.refcount == 1 and vb1.has_buffer
    assert vb2.refcount == 1
    b.set_vertex_buffer(vb2)          # last holder gone -> freed
    assert vb1.refcount == 0 and not vb1.has_buffer
    assert vb2.refcount == 2


def quad_scene(backend):
    def build(api):
        rend, window = api.make_renderer(backend=backend(api))
        rend.debug_winner = True
        node = api.textured_quad(rend, api.checker(4))
        fb = api.render_frame(rend, [surface(api, rend, window, node)],
                              clear=(0, 0, 1, 1))
        return fb, winners(rend)
    return build


@pytest.mark.parametrize("backend", ["oracle", "tile"])
def test_fragment_ctx_per_pixel_sampling(backend):
    fb, _ = both(quad_scene(lambda api: api.tile if backend == "tile"
                            else "oracle"))

    def at(u, v):
        return fb[int((0.1 + 0.8 * v) * 64), int((0.1 + 0.8 * u) * 64)]

    assert at(0.12, 0.12)[0] > 0.9 and at(0.12, 0.12)[1] < 0.1
    assert at(0.37, 0.12)[1] > 0.9 and at(0.37, 0.12)[0] < 0.1
    assert at(0.62, 0.12)[0] > 0.9
    assert at(0.12, 0.37)[1] > 0.9
    assert fb[2, 2, 2] > 0.9


def test_fragment_ctx_backends_agree():
    fbs = {be: quad_scene(lambda api, be=be: be)(TORCH)[0]
           for be in ("oracle", "auto")}
    same = np.all(fbs["oracle"] == fbs["auto"], axis=-1)
    assert same.mean() > 0.995


def test_fragment_ctx_merges_with_flat_batches():
    def build(api):
        rend, window = api.make_renderer(backend=api.tile)
        rend.debug_winner = rend.collect_stats = True
        tex_node = api.textured_quad(rend, api.checker(4))
        pipe, layout = api.flat_pipeline(rend)
        tri = api.triangle_node(rend, pipe, layout,
                                [(0.0, 0.0), (0.12, 0.0), (0.0, 0.12)],
                                color=(1.0, 1.0, 0.0))
        root = api.pkg.SceneNode.create(rend)
        root.add_child(tex_node)
        root.add_child(tri)
        fb = api.render_frame(rend, [surface(api, rend, window, root)],
                              clear=(0, 0, 1, 1))
        return fb, winners(rend), rend.frame_stats

    fb, _, stats = both(build)
    assert stats["merged"] and stats["fragment_programs"] == 2
    assert fb[1, 1, 0] > 0.9 and fb[1, 1, 1] > 0.9
    assert fb[int(0.22 * 64), int(0.22 * 64), 0] > 0.9


def jax_ctx_instance_root(rend):
    """``test_fragment_ctx_instances_not_coalesced``'s scene (JAX)."""
    layout = jmr.VertexLayout.create([("pos", 2), ("uv", 2)])

    def vfn(ctx):
        p = ctx.attr("pos")
        clip = ctx.world @ jnp.stack([p[0], p[1], jnp.float32(1.0),
                                      jnp.float32(1.0)])
        uv = ctx.attr("uv")
        return clip, jnp.stack([uv[0], uv[1], jnp.float32(0.0),
                                jnp.float32(1.0)])

    def ffn(vary, ctx):
        return jnearest(ctx.binding(1), vary[..., :2])

    pipe = jmr.Pipeline.create(
        rend, vertex_fn=vfn, fragment_fn=ffn,
        bindings=[jmr.BindingLayout(0, BUILTIN_TRANSFORM),
                  jmr.BindingLayout(1, TEXTURE_VIEW)],
        vertex_layout=layout)

    def tri_at(x0, tex):
        vb = jmr.VertexBuffer.new(rend, 0, 1, layout)
        vb.write_vertices(np.array([
            [x0, 0.1, 0.5, 0.5], [x0 + 0.3, 0.1, 0.5, 0.5],
            [x0, 0.6, 0.5, 0.5]], np.float32))
        node = jmr.Instance.create_node(
            rend, pipeline=pipe, bindings=[jmr.Binding(1, attachment=tex)],
            bounding_box_p0=(0, 0, 0), bounding_box_p1=(1, 1, 2))
        node.get_backing().set_vertex_buffer(vb)
        return node

    root = jmr.SceneNode.create(rend)
    root.add_child(tri_at(0.05, np.array([[[0, 1, 1, 1]]], np.float32)))
    root.add_child(tri_at(0.55, np.array([[[1, 0, 1, 1]]], np.float32)))
    return root


def test_fragment_ctx_instances_not_coalesced():
    fb, _, _ = both(node_scene(jax_ctx_instance_root,
                               scenes.ctx_instance_nodes, clear=(0, 0, 0, 1),
                               backend=lambda api: api.tile))
    a = fb[int(0.2 * 64), int(0.12 * 64)]
    b = fb[int(0.2 * 64), int(0.62 * 64)]
    assert a[1] > 0.9 and a[2] > 0.9 and a[0] < 0.1      # cyan
    assert b[0] > 0.9 and b[2] > 0.9 and b[1] < 0.1      # magenta


def test_fragment_fn_bad_arity_rejected_at_create():
    rend, _ = TORCH.make_renderer()
    with pytest.raises(ValueError, match="fragment_fn must take"):
        tmr.Pipeline.create(rend, vertex_fn=lambda ctx: None,
                            fragment_fn=lambda v, ctx, extra: v)


def test_clear_color_cache_bounded():
    """An animated clear colour. The JAX package caches one device array
    per colour (``draw._clear_cache``, bounded at 64); the port has no
    such cache: the colour is a host input of the frame (one pinned copy
    on a card). So: one frame plan across 80 colours, and the final
    frame used the final colour."""
    rend, window = TORCH.make_renderer()
    pipe, layout = scenes.flat_pipeline(rend)
    node = scenes.triangle_node(rend, pipe, layout,
                                [(0.1, 0.1), (0.9, 0.1), (0.1, 0.9)])
    surf = surface(TORCH, rend, window, node)
    draw = tmr.Draw.create(rend)
    for i in range(80):
        draw.begin()
        draw.clear((0.0, (i + 1) / 100.0, 0.0, 1.0))
        draw.draw_surface(surf)
        fb = draw.end()
        rend.update()
        assert len(draw._plans) == 1
    assert abs(float(fb[2, 60, 1]) - 0.80) < 1e-6


def test_fragment_arity_contract():
    assert _fragment_arity(lambda v: v) == 1
    assert _fragment_arity(lambda v, ctx: v) == 2
    assert _fragment_arity(lambda v, ctx=None: v) == 2
    assert _fragment_arity(lambda v, scale=2.0: v) == 1
    assert _fragment_arity(lambda *a: a[0]) == 1

    def two_req_then_var(v, ctx, *rest):
        return v

    assert _fragment_arity(two_req_then_var) == 2
    with pytest.raises(ValueError, match="fragment_fn must take"):
        _fragment_arity(lambda: None)


def test_wrong_varying_count_attributed():
    rend, window = TORCH.make_renderer(backend="auto")
    layout = tmr.VertexLayout.create([("pos", 2)])

    def bad_vfn(ctx):
        p = ctx.attr("pos")
        one = torch.ones((), dtype=torch.float32)
        clip = matvec4(ctx.world, torch.stack([p[0], p[1], one, one]))
        return clip, torch.stack([p[0], p[1]])     # 2 channels: wrong

    pipe = tmr.Pipeline.create(
        rend, vertex_fn=bad_vfn,
        bindings=[tmr.BindingLayout(0, BUILTIN_TRANSFORM)],
        vertex_layout=layout)
    vb = tmr.VertexBuffer.new(rend, 0, 1, layout)
    vb.write_vertices(np.array([[0.1, 0.1], [0.9, 0.1], [0.1, 0.9]],
                               np.float32))
    node = tmr.Instance.create_node(rend, pipeline=pipe,
                                    bounding_box_p0=(0, 0, 0),
                                    bounding_box_p1=(1, 1, 2))
    node.get_backing().set_vertex_buffer(vb)
    with pytest.raises(ValueError, match="bad_vfn.*2 varying channels"):
        scenes.render_frame(rend, [surface(TORCH, rend, window, node)])


def test_layout_without_buffer_raises():
    """A pipeline with a vertex layout over a buffer-less VertexBuffer
    raises the JAX package's error, naming ``set_vertex_buffer``."""
    for api in APIS:
        rend, window = api.make_renderer()
        pipe, _layout = api.flat_pipeline(rend)
        node = api.pkg.Instance.create_node(rend, pipeline=pipe)
        with pytest.raises(ValueError, match="buffer-less VertexBuffer"):
            api.render_frame(rend, [surface(api, rend, window, node)])
