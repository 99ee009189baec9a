"""Behaviour scenes of the port, built against its API from numpy and
torch alone: the CPU parity tests (``tests/test_torch_*.py``) and
``chip_smoke.py`` on the card draw the same scenes from here.

Two kinds of builders:

- **Scene helpers**: the scenes of the JAX package's behaviour tests
  (``tests/test_render_e2e.py``, ``tests/test_clipping.py``) through the
  port's API: :func:`make_renderer`, :func:`flat_pipeline`,
  :func:`triangle_node`, :func:`ortho_unit`, :func:`render_frame`,
  :func:`checker_texture`, :func:`textured_quad` and the instanced,
  planar-batch, u32-binding, sampler, eye-straddler and ctx-fragment
  scenes.
- **Scripted scenes** (:data:`SCRIPTED`): a scene and its between-frame
  script, what changes from one frame to the next (vertex rows, binding
  words, texels, transforms, the clear colour, the window size, the
  vertex buffer an instance draws, the surfaces drawn).
  ``SCRIPTED[name](device, backend, mesh=None)`` returns a
  :class:`Scene` (in the row bands of ``mesh`` when one is given);
  ``scene.step(k)`` applies frame k's changes and renders frame k. On a
  card the frames are CUDA graph replays, so together the scripts
  change every input a replay reloads or a new plan captures.
"""

from __future__ import annotations

import struct
from typing import Callable

import numpy as np
import torch

from .. import (Binding, BindingLayout, Core, Draw, Instance, Pipeline,
                Renderer, SceneNode, Surface, VertexBuffer, VertexLayout,
                math3d)
from ..ops import sampling
from ..ops.raster_common import Triangles
from ..ops.vertex_stage import bitcast_i32, matvec4
from ..renderer.pipeline import (BUILTIN_TRANSFORM, TEXTURE_SAMPLER,
                                 TEXTURE_VIEW, UNMANAGED_BUFFER)

F32 = torch.float32

# the u32 scene's words (``test_u32_binding_roundtrip``): a NaN bit
# pattern if read as f32, and a raw-bytes word
U32_NAN_BITS = 0xFFC00123
U32_RAW = 0xDEADBEEF


def _i32(word: int) -> int:
    """A u32 word's bits as a signed int32 value."""
    return int(np.uint32(word).view(np.int32))


# --------------------------------------------------------------------------
# scene helpers (``tests/test_render_e2e.py``'s, through the port's API)
# --------------------------------------------------------------------------

def make_renderer(w=64, h=64, backend="oracle", device="cuda", mesh=None):
    """(renderer, window) of a ``w`` x ``h`` window on ``device``, in the
    row bands of ``mesh`` when one is given."""
    core = Core(fixed_timestep=1.0 / 60.0)
    window = core.create_window(w, h, "test")
    rend = Renderer(core, device=device, raster_backend=backend, mesh=mesh)
    rend.adopt_window(window)
    return rend, window


def _one(t):
    return torch.ones((), dtype=F32, device=t.device)


def flat_pipeline(rend, fragment_fn=None, **kw):
    """2D colored-vertex pipeline, like the Polygon module's
    (Polygon.zig:31-38): clip pos = world_xform @ (x, y, 1, 1)."""
    layout = VertexLayout.create([("pos", 2), ("color", 3)])

    def vertex_fn(ctx):
        p, c = ctx.attr("pos"), ctx.attr("color")
        one = _one(p)
        return (matvec4(ctx.world, torch.stack([p[0], p[1], one, one])),
                torch.stack([c[0], c[1], c[2], one]))

    return Pipeline.create(
        rend, vertex_fn=vertex_fn, fragment_fn=fragment_fn,
        bindings=[BindingLayout(0, BUILTIN_TRANSFORM)],
        vertex_layout=layout, **kw), layout


def triangle_rows(pts, color=(1.0, 0.0, 0.0)) -> np.ndarray:
    return np.array([[x, y, *color] for x, y in pts], np.float32)


def triangle_node(rend, pipeline, layout, pts, color=(1.0, 0.0, 0.0)):
    vb = VertexBuffer.new(rend, 0, len(pts) // 3, layout)
    vb.write_vertices(triangle_rows(pts, color))
    node = Instance.create_node(
        rend, pipeline=pipeline,
        bounding_box_p0=(min(p[0] for p in pts), min(p[1] for p in pts), 0.0),
        bounding_box_p1=(max(p[0] for p in pts), max(p[1] for p in pts), 1.5))
    node.get_backing().set_vertex_buffer(vb)
    return node


def ortho_unit():
    """Maps [0,1]x[0,1] (y-down UI space) onto the full frame."""
    return math3d.projection_2d(left=0.0, right=1.0, bottom=1.0, top=0.0,
                                near=0.1, far=2.0)


def window_surface(rend, window, node, perspective=None):
    surf = Surface.create_window_scene(rend, window, node)
    surf.set_perspective(ortho_unit() if perspective is None else perspective)
    return surf


def render_frame(rend, surfaces, clear=(0.0, 0.0, 0.0, 1.0)):
    """One frame through a new Draw; returns the f32 framebuffer (numpy)."""
    draw = Draw.create(rend)
    draw.begin()
    draw.clear(clear)
    for s in surfaces:
        draw.draw_surface(s)
    fb = draw.end()
    rend.update()
    return fb.cpu().numpy()


def depth_node(rend, layout, z, color):
    """``test_depth_order_and_ties``: a unit right triangle at depth
    ``z`` through its own pipeline."""
    def vfn(ctx):
        p, c = ctx.attr("pos"), ctx.attr("color")
        one = _one(p)
        return (matvec4(ctx.world, torch.stack([p[0], p[1], one * z, one])),
                torch.stack([c[0], c[1], c[2], one]))

    pipe = Pipeline.create(rend, vertex_fn=vfn,
                           bindings=[BindingLayout(0, BUILTIN_TRANSFORM)],
                           vertex_layout=layout)
    vb = VertexBuffer.new(rend, 0, 1, layout)
    vb.write_vertices(triangle_rows([(0.0, 0.0), (1.0, 0.0), (0.0, 1.0)],
                                    color))
    node = Instance.create_node(rend, pipeline=pipe,
                                bounding_box_p0=(0, 0, 0),
                                bounding_box_p1=(1, 1, 2))
    node.get_backing().set_vertex_buffer(vb)
    return node


def instanced_node(rend):
    """``test_instanced_draw``: one triangle drawn 3 times, draw
    instance i shifted right by 0.3 i in UI space."""
    layout = VertexLayout.create([("pos", 2), ("color", 3)])

    def vfn(ctx):
        p, c = ctx.attr("pos"), ctx.attr("color")
        one = _one(p)
        off = ctx.draw_instance.to(F32) * 0.3
        return (matvec4(ctx.world, torch.stack([p[0] + off, p[1], one, one])),
                torch.stack([c[0], c[1], c[2], one]))

    pipe = Pipeline.create(rend, vertex_fn=vfn,
                           bindings=[BindingLayout(0, BUILTIN_TRANSFORM)],
                           vertex_layout=layout)
    vb = VertexBuffer.new(rend, 0, 1, layout)
    vb.write_vertices(np.array([[0.05, 0.1, 1, 0, 0], [0.25, 0.1, 1, 0, 0],
                                [0.05, 0.5, 1, 0, 0]], np.float32))
    vb.instance_count = 3
    node = Instance.create_node(rend, pipeline=pipe,
                                bounding_box_p0=(0, 0, 0),
                                bounding_box_p1=(1, 1, 2))
    node.get_backing().set_vertex_buffer(vb)
    return node


def vertex_textured_node(rend):
    """``test_textured_pipeline``: a 2x2 checker attachment sampled in
    the vertex function."""
    layout = VertexLayout.create([("pos", 2), ("uv", 2)])

    def vfn(ctx):
        p = ctx.attr("pos")
        one = _one(p)
        clip = matvec4(ctx.world, torch.stack([p[0], p[1], one, one]))
        return clip, sampling.sample_nearest(ctx.binding(1), ctx.attr("uv"))

    pipe = Pipeline.create(rend, vertex_fn=vfn,
                           bindings=[BindingLayout(0, BUILTIN_TRANSFORM),
                                     BindingLayout(1, TEXTURE_VIEW)],
                           vertex_layout=layout)
    tex = np.zeros((2, 2, 4), np.float32)
    tex[0, 0] = tex[1, 1] = [1, 0, 0, 1]
    tex[0, 1] = tex[1, 0] = [0, 1, 0, 1]
    vb = VertexBuffer.new(rend, 0, 1, layout)
    vb.write_vertices(np.array([[0.0, 0.0, 0.2, 0.2], [1.0, 0.0, 0.2, 0.2],
                                [0.0, 1.0, 0.2, 0.2]], np.float32))
    node = Instance.create_node(rend, pipeline=pipe,
                                bindings=[Binding(1, attachment=tex)],
                                bounding_box_p0=(0, 0, 0),
                                bounding_box_p1=(1, 1, 2))
    node.get_backing().set_vertex_buffer(vb)
    return node


def u32_node(rend):
    """``test_u32_binding_roundtrip``: green = word 0 (f32) where word 1
    is u32 7, word 2 the NaN bit pattern and word 3 the raw-bytes word,
    else 0 (integer words compared through their int32 bits)."""
    layout = VertexLayout.create([("pos", 2)])
    want = (7, _i32(U32_NAN_BITS), _i32(U32_RAW))

    def vfn(ctx):
        p = ctx.attr("pos")
        one = _one(p)
        zero = torch.zeros((), dtype=F32, device=p.device)
        clip = matvec4(ctx.world, torch.stack([p[0], p[1], one, one]))
        buf = ctx.binding(1)
        words = bitcast_i32(buf[1:4])
        ok = ((words[0] == want[0]) & (words[1] == want[1])
              & (words[2] == want[2]))
        g = torch.where(ok, buf[0], zero)
        return clip, torch.stack([zero, g, zero, one])

    pipe = Pipeline.create(rend, vertex_fn=vfn,
                           bindings=[BindingLayout(0, BUILTIN_TRANSFORM),
                                     BindingLayout(1, UNMANAGED_BUFFER)],
                           vertex_layout=layout)
    vb = VertexBuffer.new(rend, 0, 1, layout)
    vb.write_vertices(np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]],
                               np.float32))
    node = Instance.create_node(rend, pipeline=pipe,
                                bindings=[Binding(1, size=16)],
                                bounding_box_p0=(0, 0, 0),
                                bounding_box_p1=(1, 1, 2))
    inst = node.get_backing()
    write_u32_words(inst)
    inst.set_vertex_buffer(vb)
    return node


def sampler_node(rend, use_bilinear: float):
    """``test_texture_sampler_binding_kind``: the sampler binding's word
    0 picks bilinear over nearest at the texture's centre."""
    layout = VertexLayout.create([("pos", 2), ("uv", 2)])
    tex = np.zeros((2, 2, 4), np.float32)
    tex[:, :] = [0, 0, 1, 1]
    tex[0, 0] = [1, 0, 0, 1]

    def vfn(ctx):
        p, uv = ctx.attr("pos"), ctx.attr("uv")
        one = _one(p)
        clip = matvec4(ctx.world, torch.stack([p[0], p[1], one, one]))
        bilinear = ctx.binding(2)[0] > 0.5
        col = torch.where(bilinear,
                          sampling.sample_bilinear(ctx.binding(1), uv),
                          sampling.sample_nearest(ctx.binding(1), uv))
        return clip, col

    pipe = Pipeline.create(rend, vertex_fn=vfn,
                           bindings=[BindingLayout(0, BUILTIN_TRANSFORM),
                                     BindingLayout(1, TEXTURE_VIEW),
                                     BindingLayout(2, TEXTURE_SAMPLER)],
                           vertex_layout=layout)
    vb = VertexBuffer.new(rend, 0, 1, layout)
    vb.write_vertices(np.array([[0.0, 0.0, 0.5, 0.5], [1.0, 0.0, 0.5, 0.5],
                                [0.0, 1.0, 0.5, 0.5]], np.float32))
    node = Instance.create_node(
        rend, pipeline=pipe,
        bindings=[Binding(1, attachment=tex),
                  Binding(2, attachment=np.array([use_bilinear],
                                                 np.float32))],
        bounding_box_p0=(0, 0, 0), bounding_box_p1=(1, 1, 2))
    node.get_backing().set_vertex_buffer(vb)
    return node


def straddler(zfrac=0.5):
    """``tests/test_clipping.py``'s straddler: (clip f32[1, 3, 4], vary
    f32[1, 3, 4]) of one triangle whose middle vertex lies behind the eye
    and whose visible part is front-facing (CW in y-down pixel space)."""
    clip = np.array([[[-0.8, -0.5, zfrac, 1.0], [0.0, 2.0, -zfrac, -1.0],
                      [0.8, -0.5, zfrac, 1.0]]], np.float32)
    vary = np.array([[[1, 0, 0, 1], [0, 1, 0, 1], [0, 0, 1, 1]]],
                    np.float32)
    return clip, vary


# clip positions of ``test_eye_straddling_triangle_renders``
STRADDLER_CLIP = straddler()[0][0]


def straddler_node(rend, clip_rows=None, cull_mode="back"):
    """A triangle whose clip positions are vertex attributes (the JAX
    test indexes a constant by ``vertex_index``; here a write moves
    them); colour red. Draw it under an identity perspective."""
    layout = VertexLayout.create([("clip", 4)])

    def vfn(ctx):
        c = ctx.attr("clip")
        one = _one(c)
        zero = torch.zeros((), dtype=F32, device=c.device)
        return c, torch.stack([one, zero, zero, one])

    pipe = Pipeline.create(rend, vertex_fn=vfn,
                           bindings=[BindingLayout(0, BUILTIN_TRANSFORM)],
                           vertex_layout=layout, cull_mode=cull_mode)
    rows = STRADDLER_CLIP if clip_rows is None else clip_rows
    vb = VertexBuffer.new(rend, 0, len(rows) // 3, layout)
    vb.write_vertices(rows)
    node = Instance.create_node(rend, pipeline=pipe)
    node.get_backing().set_vertex_buffer(vb)
    return node


# ``test_planar_batch_vertex_interface``: two overlapping triangles at
# distinct depths
PLANAR_PTS = np.array([[0.1, 0.1], [0.9, 0.2], [0.2, 0.9],
                       [0.5, 0.05], [0.95, 0.6], [0.6, 0.5]], np.float32)
PLANAR_Z = np.array([1.0, 0.6], np.float32)
PLANAR_COLOR = (0.2, 0.9, 0.4, 1.0)


def planar_node(rend, batch: bool):
    """The planar-batch scene: a buffer-less draw of 2 triangles whose
    positions come from constants (made once on the renderer's device),
    through the per-vertex function, or also through a whole-stream
    ``vertex_batch_fn`` (``batch``)."""
    dev = rend.device
    pts = torch.from_numpy(PLANAR_PTS).to(dev)
    zs = torch.from_numpy(PLANAR_Z).to(dev)
    color = torch.tensor(PLANAR_COLOR, dtype=F32).to(dev)

    def vertex_fn(ctx):
        vi = ctx.vertex_index
        p = pts[vi]
        one = _one(p)
        clip = matvec4(ctx.world, torch.stack([p[0], p[1], zs[vi // 3], one]))
        return clip, color

    def vertex_batch_fn(ctx):
        w = ctx.worlds[0]
        p = pts.reshape(2, 3, 2)
        hom = torch.stack([p[:, :, 0], p[:, :, 1],
                           zs[:, None].expand(2, 3),
                           torch.ones((2, 3), dtype=F32, device=dev)], -1)
        clip = matvec4(w, hom)                             # [T, 3, 4]
        return Triangles(clip, color.expand(2, 3, 4), planar=True)

    pipe = Pipeline.create(
        rend, vertex_fn=vertex_fn,
        vertex_batch_fn=vertex_batch_fn if batch else None,
        bindings=[BindingLayout(0, BUILTIN_TRANSFORM)])
    vb = VertexBuffer.new(rend, 0, 2)      # 2 tris, buffer-less
    node = Instance.create_node(rend, pipeline=pipe)
    node.get_backing().set_vertex_buffer(vb)
    return node


def inverted_fragment(c):
    """The ctx-free fragment program of the heterogeneous-programs test."""
    return torch.cat([1.0 - c[..., :3], c[..., 3:]], -1)


def hetero_root(rend):
    """``test_heterogeneous_fragment_programs_merge_into_one_pass``: two
    red triangles, the second through a pipeline with an inverting
    fragment program."""
    pipe_a, layout = flat_pipeline(rend)
    pipe_b, _ = flat_pipeline(rend, fragment_fn=inverted_fragment)
    root = SceneNode.create(rend)
    root.add_child(triangle_node(rend, pipe_a, layout,
                                 [(0.1, 0.1), (0.9, 0.1), (0.1, 0.9)],
                                 color=(1, 0, 0)))
    root.add_child(triangle_node(rend, pipe_b, layout,
                                 [(0.3, 0.9), (0.9, 0.3), (0.9, 0.9)],
                                 color=(1, 0, 0)))
    return root


def write_u32_words(inst, scale=0.75, sel=7):
    """Words 0..3 of the u32 binding: an f32, a u32, the NaN bit pattern
    and a raw-bytes write."""
    inst.update_buffer(1, np.float32(scale))
    inst.update_buffer(1, np.uint32(sel), byte_offset=4)
    inst.update_buffer(1, np.uint32(U32_NAN_BITS), byte_offset=8)
    inst.update_buffer(1, struct.pack("<I", U32_RAW), byte_offset=12)


def checker_texture(n=4):
    """n x n red/green checker."""
    tex = np.zeros((n, n, 4), np.float32)
    for y in range(n):
        for x in range(n):
            tex[y, x] = [1, 0, 0, 1] if (x + y) % 2 == 0 else [0, 1, 0, 1]
    return tex


def uv_pipeline(rend, tex_shape=None):
    """Positions plus UVs as varyings; the fragment program samples
    binding 1 at the per-pixel UV. ``tex_shape`` reads the binding as
    flat words written with ``update_buffer`` (a texture the app writes
    between frames) and reshapes them."""
    layout = VertexLayout.create([("pos", 2), ("uv", 2)])

    def vfn(ctx):
        p, uv = ctx.attr("pos"), ctx.attr("uv")
        one = _one(p)
        zero = torch.zeros((), dtype=F32, device=p.device)
        return (matvec4(ctx.world, torch.stack([p[0], p[1], one, one])),
                torch.stack([uv[0], uv[1], zero, one]))

    def ffn(vary, ctx):
        tex = ctx.binding(1)
        if tex_shape is not None:
            tex = tex.reshape(tex_shape)
        return sampling.sample_nearest(tex, vary[..., :2])

    pipe = Pipeline.create(rend, vertex_fn=vfn, fragment_fn=ffn,
                           bindings=[BindingLayout(0, BUILTIN_TRANSFORM),
                                     BindingLayout(1, TEXTURE_VIEW)],
                           vertex_layout=layout)
    assert pipe.fragment_uses_ctx
    return pipe, layout


def textured_quad(rend, tex, pipe=None, binding=None):
    """A [0.1,0.9]^2 quad (two CW triangles) whose fragment program
    samples the texture at the interpolated per-PIXEL UV."""
    if pipe is None:
        pipe, layout = uv_pipeline(rend)
    else:
        pipe, layout = pipe
    vb = VertexBuffer.new(rend, 0, 2, layout)
    lo, hi = 0.1, 0.9                      # CW in y-down UI space
    vb.write_vertices(np.array([[lo, lo, 0, 0], [hi, lo, 1, 0],
                                [lo, hi, 0, 1], [hi, lo, 1, 0],
                                [hi, hi, 1, 1], [lo, hi, 0, 1]], np.float32))
    node = Instance.create_node(
        rend, pipeline=pipe,
        bindings=[binding or Binding(1, attachment=tex)],
        bounding_box_p0=(0, 0, 0), bounding_box_p1=(1, 1, 2))
    node.get_backing().set_vertex_buffer(vb)
    return node


def ctx_instance_nodes(rend):
    """``test_fragment_ctx_instances_not_coalesced``: two instances of one
    ctx-consuming pipeline, each with its own 1x1 texture (cyan,
    magenta)."""
    pipe, layout = uv_pipeline(rend)

    def tri_at(x0, tex):
        vb = VertexBuffer.new(rend, 0, 1, layout)
        vb.write_vertices(np.array([
            [x0, 0.1, 0.5, 0.5], [x0 + 0.3, 0.1, 0.5, 0.5],
            [x0, 0.6, 0.5, 0.5]], np.float32))
        node = Instance.create_node(
            rend, pipeline=pipe, bindings=[Binding(1, attachment=tex)],
            bounding_box_p0=(0, 0, 0), bounding_box_p1=(1, 1, 2))
        node.get_backing().set_vertex_buffer(vb)
        return node

    cyan = np.array([[[0, 1, 1, 1]]], np.float32)
    magenta = np.array([[[1, 0, 1, 1]]], np.float32)
    root = SceneNode.create(rend)
    root.add_child(tri_at(0.05, cyan))
    root.add_child(tri_at(0.55, magenta))
    return root


def hierarchy_root(rend):
    """``test_hierarchical_instances_backend_parity``: a chain of nodes,
    each level offset further, a triangle at each."""
    pipe, layout = flat_pipeline(rend)
    root = SceneNode.create(rend)
    root.set_xform(math3d.translate([0.05, 0.05, 0.0]))
    colors = [(1, 0, 0), (0, 1, 0), (1, 1, 0), (0, 1, 1)]
    group = root
    for i in range(4):
        child = SceneNode.create(rend)
        child.set_xform(math3d.translate([0.18, 0.12, 0.0]))
        child.add_child(triangle_node(rend, pipe, layout,
                                      [(0.0, 0.0), (0.22, 0.0), (0.0, 0.22)],
                                      color=colors[i]))
        group.add_child(child)
        group = child
    return root


# --------------------------------------------------------------------------
# scripted scenes: a scene and what changes between its frames
# --------------------------------------------------------------------------

class Scene:
    """A scene with its between-frame script. ``script(k)`` applies the
    changes of frame k (k = 0, 1, ...) and returns the frame's draw list,
    (surface, clear colour or None) in order; :meth:`step` runs it and
    renders the frame through the scene's one Draw."""

    def __init__(self, name: str, rend, window,
                 script: Callable[[int], list]):
        self.name = name
        self.renderer = rend
        self.window = window
        self.draw = Draw.create(rend)
        self.script = script

    def step(self, k: int):
        draws = self.script(k)
        draw = self.draw
        draw.begin()
        for surface, clear in draws:
            if clear is not None:
                draw.clear(clear)
            draw.draw_surface(surface)
        fb = draw.end()
        self.renderer.update()
        return fb


def global_winners(draw) -> torch.Tensor:
    """The frame's winners as one i32[H, W] buffer of frame-wide ids, on
    the frame's device: a merged pass's own winners, or the raster
    passes' winners folded in order, each pass's ids offset by its
    batch's place in the merged layout (every batch takes its triangles
    plus 2 * CLIP_CAPACITY * big_scale straddler slots). The tile
    backend's and the oracle's frames then compare id for id. Needs
    ``Renderer.debug_winner``."""
    from ..renderer.draw import CLIP_CAPACITY
    plan = draw._get_plan(draw.renderer.window)
    winners = draw.last_winners
    if plan.merged:
        return winners[0]
    slots = 2 * CLIP_CAPACITY * plan.big_scale
    out = torch.full_like(winners[0], -1)
    base = 0
    passes = iter(winners)
    for batches in plan.surfaces:
        for b in batches:
            w = next(passes)
            out = torch.where(w >= 0, w + base, out)
            base += b.tri_count + slots
    return out


def _scene_renderer(device, backend, w=64, h=64, mesh=None):
    rend, window = make_renderer(w, h, backend=backend, device=device,
                                 mesh=mesh)
    rend.debug_winner = True
    return rend, window


def scene_writes(device="cuda", backend="auto", mesh=None) -> Scene:
    """Vertex writes, an animated clear colour and two fragment programs
    in one pass: a flat triangle whose vertex rows are rewritten every
    frame beside the heterogeneous-programs pair."""
    rend, window = _scene_renderer(device, backend, mesh=mesh)
    pipe, layout = flat_pipeline(rend)
    root = hetero_root(rend)
    moving = triangle_node(rend, pipe, layout,
                           [(0.05, 0.05), (0.45, 0.05), (0.05, 0.45)],
                           color=(0.0, 0.0, 1.0))
    root.add_child(moving)
    surf = window_surface(rend, window, root)
    vb = moving.get_backing().vertex_buffer

    def script(k):
        d = 0.04 * k
        vb.write_vertices(triangle_rows(
            [(0.05 + d, 0.05), (0.45 + d, 0.05 + d), (0.05, 0.45 - d)],
            (0.1 * k, 0.5, 1.0 - 0.1 * k)))
        return [(surf, (0.0, 0.05 * k, 0.2, 1.0))]

    return Scene("vertex writes, clear colour, two fragment programs", rend,
                 window, script)


def scene_u32(device="cuda", backend="auto", mesh=None) -> Scene:
    """u32 binding words rewritten every frame: the f32 scale changes and
    the u32 selector leaves 7 on odd frames (green off), while the node
    moves."""
    rend, window = _scene_renderer(device, backend, mesh=mesh)
    node = u32_node(rend)
    surf = window_surface(rend, window, node)
    inst = node.get_backing()

    def script(k):
        write_u32_words(inst, scale=0.25 + 0.1 * k, sel=7 if k % 2 == 0 else 8)
        node.set_xform(math3d.translate([0.02 * k, 0.0, 0.0]))
        return [(surf, (0.0, 0.0, 1.0, 1.0))]

    return Scene("u32 binding writes", rend, window, script)


TEX_N = 4


def scene_texture_writes(device="cuda", backend="auto", mesh=None) -> Scene:
    """A ctx fragment program over a texture the app rewrites every
    frame (a TEXTURE_VIEW binding written with ``update_buffer``), two
    instances of the pipeline (one batch each), the second node moving."""
    rend, window = _scene_renderer(device, backend, mesh=mesh)
    pipe = uv_pipeline(rend, tex_shape=(TEX_N, TEX_N, 4))
    size = TEX_N * TEX_N * 4 * 4
    nodes = [textured_quad(rend, None, pipe=pipe, binding=Binding(1, size=size))
             for _ in range(2)]
    nodes[1].set_xform(math3d.mat_mult([math3d.translate([0.5, 0.5, 0.0]),
                                        math3d.scale([0.4, 0.4, 1.0])]))
    root = SceneNode.create(rend)
    for n in nodes:
        root.add_child(n)
    surf = window_surface(rend, window, root)
    base = checker_texture(TEX_N)

    def script(k):
        for i, n in enumerate(nodes):
            tex = np.roll(base, k + i, axis=1).copy()
            tex[..., 2] = 0.1 * k
            n.get_backing().update_buffer(1, tex)
        nodes[1].set_xform(math3d.mat_mult([
            math3d.translate([0.5 - 0.05 * k, 0.5, 0.0]),
            math3d.scale([0.4, 0.4, 1.0])]))
        return [(surf, (0.0, 0.0, 0.0, 1.0))]

    return Scene("ctx fragment program, texture writes", rend, window, script)


def scene_buffer_swaps(device="cuda", backend="auto", mesh=None) -> Scene:
    """``set_vertex_buffer`` swaps: one instance draws one buffer of one
    triangle or another of two, alternating, and the buffers are
    rewritten (each swap is a new frame plan)."""
    rend, window = _scene_renderer(device, backend, mesh=mesh)
    pipe, layout = flat_pipeline(rend)
    node = triangle_node(rend, pipe, layout,
                         [(0.1, 0.1), (0.9, 0.1), (0.1, 0.9)])
    inst = node.get_backing()
    vbs = [inst.vertex_buffer, VertexBuffer.new(rend, 0, 2, layout)]
    # an undrawn instance holds each buffer, so a swap releases none
    # (refcounting frees a buffer its last holder lets go)
    for vb in vbs:
        Instance.create_node(rend, pipeline=pipe).get_backing() \
            .set_vertex_buffer(vb)
    surf = window_surface(rend, window, node)

    def script(k):
        vb = vbs[k % 2]
        d = 0.03 * k
        pts = [(0.1 + d, 0.1), (0.9, 0.1 + d), (0.1, 0.9)]
        if vb is vbs[1]:
            pts += [(0.5, 0.5 + d), (0.95, 0.5), (0.5, 0.95)]
        vb.write_vertices(triangle_rows(pts, (1.0, 0.2 * (k % 5), 0.0)))
        if inst.vertex_buffer is not vb:
            inst.set_vertex_buffer(vb)
        return [(surf, (0.0, 0.0, 1.0, 1.0))]

    return Scene("set_vertex_buffer swaps", rend, window, script)


RESIZES = ((64, 64), (96, 48), (48, 80), (96, 48))


def scene_resize(device="cuda", backend="auto", mesh=None) -> Scene:
    """The window resized between frames (``Surface.resize``): a new
    framebuffer and a new frame plan at each new size."""
    rend, window = _scene_renderer(device, backend, mesh=mesh)
    pipe, layout = flat_pipeline(rend)
    node = triangle_node(rend, pipe, layout,
                         [(0.1, 0.1), (0.9, 0.1), (0.1, 0.9)])
    surf = window_surface(rend, window, node)

    def script(k):
        surf.resize(RESIZES[k % len(RESIZES)])
        node.set_xform(math3d.translate([0.0, 0.02 * k, 0.0]))
        return [(surf, (0.0, 0.0, 1.0, 1.0))]

    return Scene("resize", rend, window, script)


def scene_surfaces(device="cuda", backend="auto", mesh=None) -> Scene:
    """Surfaces that appear and disappear: frame k draws the first
    surface, both, or the second alone (which then clears)."""
    rend, window = _scene_renderer(device, backend, mesh=mesh)
    pipe, layout = flat_pipeline(rend)
    s1 = window_surface(rend, window, triangle_node(
        rend, pipe, layout, [(0.0, 0.0), (1.0, 0.0), (0.0, 1.0)],
        color=(1.0, 0.0, 0.0)))
    t2 = triangle_node(rend, pipe, layout,
                       [(0.5, 0.5), (1.0, 0.5), (0.5, 1.0)],
                       color=(0.0, 1.0, 0.0))
    s2 = window_surface(rend, window, t2)
    clear = (0.0, 0.0, 1.0, 1.0)

    def script(k):
        t2.set_xform(math3d.translate([-0.05 * k, -0.05 * k, 0.0]))
        return [[(s1, clear)], [(s1, clear), (s2, None)],
                [(s2, clear)]][k % 3]

    return Scene("surfaces appear and disappear", rend, window, script)


def scene_instanced(device="cuda", backend="auto", mesh=None) -> Scene:
    """An instanced draw (3 draw instances) beside the hierarchy chain,
    the chain's root and the instance's vertex rows changing."""
    rend, window = _scene_renderer(device, backend, 96, 64, mesh=mesh)
    root = SceneNode.create(rend)
    inst_node = instanced_node(rend)
    chain = hierarchy_root(rend)
    root.add_child(chain)
    root.add_child(inst_node)
    surf = window_surface(rend, window, root)
    vb = inst_node.get_backing().vertex_buffer

    def script(k):
        chain.set_xform(math3d.translate([0.05 - 0.02 * k, 0.05, 0.0]))
        vb.write_vertices(np.array([[0.05, 0.1 + 0.03 * k, 1, 0, 0],
                                    [0.25, 0.1, 1, 0, 0],
                                    [0.05, 0.5, 1, 0.1 * k, 0]], np.float32))
        return [(surf, (0.0, 0.0, 0.0, 1.0))]

    return Scene("instanced draw and a node chain", rend, window, script)


def scene_straddler(device="cuda", backend="auto", mesh=None) -> Scene:
    """An eye-plane straddler whose vertices are rewritten every frame
    (clipped pieces on every frame) beside an in-front triangle."""
    rend, window = _scene_renderer(device, backend, mesh=mesh)
    front = np.array([[-0.9, 0.9, 0.2, 1.0], [-0.3, 0.9, 0.2, 1.0],
                      [-0.9, 0.3, 0.2, 1.0]], np.float32)
    node = straddler_node(rend, np.concatenate([STRADDLER_CLIP, front]),
                          cull_mode="none")
    surf = window_surface(rend, window, node, math3d.identity())
    vb = node.get_backing().vertex_buffer

    def script(k):
        rows = np.concatenate([STRADDLER_CLIP, front]).copy()
        rows[1, 3] = -1.0 + 0.25 * k          # the behind-eye vertex moves
        rows[0, 0] = -0.8 + 0.05 * k
        vb.write_vertices(rows)
        return [(surf, (0.0, 0.0, 1.0, 1.0))]

    return Scene("eye-plane straddler writes", rend, window, script)


def scene_sequential(device="cuda", backend="auto", mesh=None) -> Scene:
    """The sequential path: a depth_write=False pipeline and a later
    surface that clears, with moving nodes (one raster pass a batch)."""
    rend, window = _scene_renderer(device, backend, mesh=mesh)
    pipe, layout = flat_pipeline(rend)
    nodepth, _ = flat_pipeline(rend, depth_write=False, cull_mode="none")
    root = SceneNode.create(rend)
    a = triangle_node(rend, nodepth, layout,
                      [(0.0, 0.0), (0.8, 0.0), (0.0, 0.8)], (1, 0, 0))
    b = triangle_node(rend, pipe, layout,
                      [(0.2, 0.2), (1.0, 0.2), (0.2, 1.0)], (0, 1, 0))
    root.add_child(a)
    root.add_child(b)
    s1 = window_surface(rend, window, root)
    c = triangle_node(rend, pipe, layout,
                      [(0.5, 0.0), (1.0, 0.0), (0.5, 0.5)], (1, 1, 0))
    s2 = window_surface(rend, window, c)

    def script(k):
        a.set_xform(math3d.translate([0.03 * k, 0.0, 0.0]))
        c.set_xform(math3d.translate([-0.04 * k, 0.04 * k, 0.0]))
        return [(s1, (0.0, 0.0, 1.0, 1.0)), (s2, (0.1, 0.1, 0.1, 1.0))]

    return Scene("sequential passes", rend, window, script)


def scene_planar(device="cuda", backend="auto", mesh=None) -> Scene:
    """A whole-stream (planar) vertex function under a moving node."""
    rend, window = _scene_renderer(device, backend, mesh=mesh)
    node = planar_node(rend, batch=True)
    surf = window_surface(rend, window, node)

    def script(k):
        node.set_xform(math3d.translate([0.03 * k, -0.02 * k, 0.0]))
        return [(surf, (0.0, 0.0, 1.0, 1.0))]

    return Scene("planar batch vertex function", rend, window, script)


# name -> scene(device, backend, mesh=None): the behaviour scenes with
# scripts
SCRIPTED = {
    "writes": scene_writes,
    "u32": scene_u32,
    "texture": scene_texture_writes,
    "swaps": scene_buffer_swaps,
    "resize": scene_resize,
    "surfaces": scene_surfaces,
    "instanced": scene_instanced,
    "straddler": scene_straddler,
    "sequential": scene_sequential,
    "planar": scene_planar,
}
