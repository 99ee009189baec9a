"""Terrain module: heightmap PNG -> procedural terrain mesh.

Capability match for ``Terrain/Terrain.zig``: the mesh has NO vertex
buffer — the vertex function synthesizes 6 vertices per heightmap quad
from ``vertex_index`` alone (``Terrain.zig:21-50``), reading heights from
a storage binding. Here that is a vectorized index computation: the
per-vertex function under ``vmap``, or the whole-stream function the
frame uses (``ops/terrain_vertex.py``: K3 on a card).

Shader-for-shader correspondence (``Terrain.zig:21-78``):
  vertex_at  = vi % 6 ; quad_at = vi / 6
  corner     = quad_vals[vertex_at]             (two CCW-in-xz tris/quad)
  xz         = 0.2 * (corner + (quad/size, quad%size)) - 0.1 * size
  height     = heightmap[quad_lookup[vertex_at]]
  out.pos    = world_xform @ data.xform @ (xz.x, 5*height, xz.y, 1)
  out.color  = (5h, 5h, 5h, 1)                  (grayscale by height)

Bindings (``Terrain.zig:131-151``): 0 = managed uniform {mat4 xform,
size}, 1 = managed read-only storage heightmap (flat f32[size*size]),
2 = builtin transform.

Quirk reproduced as *intent* (SURVEY.md §2.5 spirit): the reference's
quad_lookup indexes up to ``quad + size + 1`` which exceeds the buffer
for the last row/column of quads; WebGPU's robust buffer access clamps.
We clamp explicitly.

Height decode matches ``Terrain.zig:120``: h = 1 - gray16/65535.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import terrain_vertex as tv
from ..ops.raster_common import fma
from ..ops.terrain_vertex import LOOKUP_COL, LOOKUP_ROW, QUAD_VALS, offset
from ..ops.vertex_stage import matvec4, per_device
from ..renderer import (Binding, BindingLayout, Instance, Pipeline,
                        SceneNode, VertexBuffer)
from ..renderer.pipeline import (BUILTIN_TRANSFORM, MANAGED_STORAGE,
                                 MANAGED_UNIFORM)
from ..utils.png import load_grayscale16


def _make_vertex_fn(size: int, device):
    """The per-vertex terrain shader. Its constants are made once per
    device (``vertex_stage.per_device``): on ``device`` (the renderer's)
    here, on another card of a mesh at its first frame there. A later
    frame uploads nothing."""
    max_idx = size * size - 1

    def make(dev):
        return (torch.from_numpy(QUAD_VALS).to(dev),
                torch.from_numpy(LOOKUP_ROW).to(dev),
                torch.from_numpy(LOOKUP_COL).to(dev),
                torch.tensor(0.2, dtype=torch.float32).to(dev),
                -offset(size, dev))

    consts = per_device(make, device)

    def vertex_fn(ctx):
        vi = ctx.vertex_index.long()
        dev = ctx.world.device
        quad_vals, lookup_row, lookup_col, c02, noff = consts(dev)
        vertex_at = vi % 6
        quad_at = vi // 6
        quad_coords = torch.stack([(quad_at // size).float(),
                                   (quad_at % size).float()])
        corner = quad_vals[vertex_at]
        xz = fma(c02, corner + quad_coords, noff)
        lookup = (quad_at + lookup_row[vertex_at] * size
                  + lookup_col[vertex_at])
        h = tv.flush_subnormals(ctx.binding(1)[torch.clamp(lookup, 0,
                                                           max_idx)])
        uniform = ctx.binding(0)                        # f32[17]
        data_xform = uniform[:16].reshape(4, 4)
        y = 5.0 * h
        one = torch.ones((), dtype=torch.float32, device=dev)
        pos = torch.stack([xz[0], y, xz[1], one])
        clip = matvec4(ctx.world, matvec4(data_xform, pos))
        color = torch.stack([y, y, y, one])
        return clip, color

    return vertex_fn


def _make_vertex_batch_fn(size: int, device):
    """Whole-stream formulation of the terrain vertex shader (the path
    the frame takes): every triangle of the batch's instances from their
    heights (binding 1), data transforms (binding 0) and world matrices,
    by :func:`ops.terrain_vertex.terrain_vertex` on the device of its
    inputs: K3 on a card, its plain version on the CPU. ``device`` (the
    renderer's) is taken for the per-vertex function's signature; the
    function makes no constants.

    Triangles go out in the JAX package's array order: per instance, the
    first triangle of every quad, then the second one. ``ids`` carries
    the submission ranks (2q and 2q+1 for quad q, ``Terrain.zig:126``),
    so winner ids and depth ties are those of submission order."""

    def vertex_batch_fn(ctx):
        return tv.terrain_vertex(ctx.binding(1), ctx.binding(0), ctx.worlds,
                                 size)

    return vertex_batch_fn


class Terrain:
    """Terrain content module (``Terrain/Terrain.zig``). One pipeline per
    heightmap size (the vertex function closes over ``size``, which also
    fixes the storage binding's shape)."""

    def __init__(self, renderer):
        self.renderer = renderer
        self._pipelines: dict[int, Pipeline] = {}

    def init(self):  # parity no-op: pipelines are created lazily per size
        return self

    def _pipeline_for(self, size: int) -> Pipeline:
        pipe = self._pipelines.get(size)
        if pipe is None:
            pipe = Pipeline.create(
                self.renderer,
                vertex_fn=_make_vertex_fn(size, self.renderer.device),
                vertex_batch_fn=_make_vertex_batch_fn(size,
                                                      self.renderer.device),
                bindings=[BindingLayout(0, MANAGED_UNIFORM),
                          BindingLayout(1, MANAGED_STORAGE),
                          BindingLayout(2, BUILTIN_TRANSFORM)],
            )
            self._pipelines[size] = pipe
        return pipe

    def create_terrain(self, source) -> SceneNode:
        """Build a terrain node (``Terrain.zig:88-129``).

        ``source``: path to a 16-bit grayscale PNG, or a numpy array —
        uint16 (decoded as 1 - v/65535, ``Terrain.zig:120``) or float32
        heights in [0, 1] used directly.
        """
        if isinstance(source, (str, bytes)):
            gray = load_grayscale16(source)
            heights = (1.0 - gray.astype(np.float32) / 65535.0)
        else:
            arr = np.asarray(source)
            if arr.dtype == np.uint16:
                heights = 1.0 - arr.astype(np.float32) / 65535.0
            else:
                heights = arr.astype(np.float32)
        if heights.ndim != 2 or heights.shape[0] != heights.shape[1]:
            raise ValueError("heightmap must be square")
        size = heights.shape[0]

        pipeline = self._pipeline_for(size)
        bound = 0.1 * size
        node = Instance.create_node(
            self.renderer, pipeline=pipeline,
            bindings=[Binding(0, size=17 * 4),
                      Binding(1, size=size * size * 4)],
            bounding_box_p0=(-bound, 0.0, -bound),
            bounding_box_p1=(bound, 5.0, bound))
        inst = node.get_backing()

        # uniform: {xform: mat4 = ident, size} (Terrain.zig:80-83,127)
        inst.update_buffer(0, np.eye(4, dtype=np.float32).reshape(-1))
        inst.update_buffer(0, np.float32(size), byte_offset=16 * 4)
        # heightmap upload (the reference streams 64-float chunks,
        # Terrain.zig:114-124; one byte-addressed write here)
        inst.update_buffer(1, heights.reshape(-1))

        inst.set_vertex_buffer(VertexBuffer.new(
            self.renderer, 0, size * size * 2))  # size^2 quads * 2 tris
        return node

    def deinit(self):
        for p in self._pipelines.values():
            p.destroy()
        self._pipelines.clear()
