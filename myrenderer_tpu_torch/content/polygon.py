"""Polygon module: 2D concave polygon -> triangulated colored mesh node.

Capability match for ``Polygon/Polygon.zig``: ear-clipped (Seidel)
triangulation at build time on the host, packed into a vertex buffer
with the 4-color palette cycling per emitted triangle
(``Polygon.zig:66-78``), drawn by a pipeline whose vertex function is
``clip = world_xform @ (x, y, 1, 1)`` (``Polygon.zig:31-38``).

Intent-not-bugs (SURVEY.md §2.5): the AABB is computed correctly
(min/max over emitted points; the reference mixes vector components at
``Polygon.zig:73-76`` and seeds with zeros) and spans z = 1, the plane
the vertex shader actually puts the polygon on.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..geometry import Triangulation, triangulate_device
from ..renderer import (Instance, Pipeline, SceneNode, VertexBuffer,
                        VertexLayout)
from ..ops.vertex_stage import matvec4
from ..renderer.pipeline import BUILTIN_TRANSFORM, BindingLayout

Point = tuple[float, float]


def _color_from_hex(hexval: int) -> tuple[float, float, float]:
    """``Polygon.zig:50-57``: low byte = red."""
    return ((hexval & 0xFF) / 255.0,
            ((hexval >> 8) & 0xFF) / 255.0,
            ((hexval >> 16) & 0xFF) / 255.0)


# palette at Polygon.zig:66-71
PALETTE = tuple(_color_from_hex(h)
                for h in (0x5E315B, 0xCFFF70, 0x3CA370, 0x4B5BAB))


def _vertex_fn(ctx):
    p = ctx.attr("pos")
    c = ctx.attr("color")
    one = torch.ones((), dtype=torch.float32, device=p.device)
    clip = matvec4(ctx.world, torch.stack([p[0], p[1], one, one]))
    return clip, torch.stack([c[0], c[1], c[2], one])


class PolygonHandle:
    """``Polygon.Handle`` (``Polygon.zig:40-48``)."""

    def __init__(self, node: SceneNode, vertex_buffer: VertexBuffer,
                 points: Sequence[Point]):
        self.node = node
        self.vertex_buffer = vertex_buffer
        self.points = tuple(points)

    def get_node(self) -> SceneNode:
        return self.node

    # reference spelling (Polygon.zig:45)
    getNode = get_node


class Polygon:
    """Polygon content module; owns the shared 2D pipeline and a
    reusable triangulator (``Polygon.zig:109-117``)."""

    GPU_VERTEX_LAYOUT = VertexLayout.create([("pos", 2), ("color", 3)])

    def __init__(self, renderer, seed: int = 0,
                 device_triangulation: bool = False):
        """``device_triangulation``: triangulate each polygon when it is
        created with the ear clipper on the renderer's device
        (``geometry/device_tri.py``) instead of the host Seidel path.
        Both cover the same pixels; the diagonals, and so the palette
        boundaries inside a polygon, generally differ, so the default
        stays Seidel (the goldens' triangulation)."""
        self.renderer = renderer
        self.pipeline = Pipeline.create(
            renderer, vertex_fn=_vertex_fn,
            bindings=[BindingLayout(0, BUILTIN_TRANSFORM)],
            vertex_layout=self.GPU_VERTEX_LAYOUT)
        self.triangulation = Triangulation(seed)
        self.device_triangulation = device_triangulation
        self.polygons: list[PolygonHandle] = []

    def init(self):  # parity no-op (pipeline built in __init__)
        return self

    def create_polygon(self, vertices: Sequence[Point]) -> PolygonHandle:
        """``Polygon.zig:81-107``: triangulate, pack vertices+palette
        colors straight into the buffer, create the instance node."""
        n = len(vertices)
        vb = VertexBuffer.new(self.renderer, 0, n - 2,
                              self.GPU_VERTEX_LAYOUT)
        rows = vb.map()
        state = {"i": 0}

        def emit(point):
            i = state["i"]
            color = PALETTE[(i // 3) % len(PALETTE)]
            rows[i, 0:2] = point
            rows[i, 2:5] = color
            state["i"] += 1

        if self.device_triangulation:
            for point in triangulate_device(vertices, capacity=max(32, n),
                                            device=self.renderer.device):
                emit(point)
        else:
            self.triangulation.create_polygon(vertices, emit)
        if state["i"] != vb.vertex_count:
            raise ValueError(
                f"triangulation emitted {state['i']} vertices, expected "
                f"{vb.vertex_count}")

        pts = np.asarray(vertices, np.float32)
        node = Instance.create_node(
            self.renderer, pipeline=self.pipeline,
            bounding_box_p0=(float(pts[:, 0].min()),
                             float(pts[:, 1].min()), 1.0),
            bounding_box_p1=(float(pts[:, 0].max()),
                             float(pts[:, 1].max()), 1.0))
        node.get_backing().set_vertex_buffer(vb)

        handle = PolygonHandle(node, vb, vertices)
        self.polygons.append(handle)
        return handle

    def deinit(self):
        self.pipeline.destroy()
