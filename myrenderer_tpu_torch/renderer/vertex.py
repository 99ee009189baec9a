"""VertexBuffer: packed triangle-list vertex storage + draw arguments.

Mirrors ``Renderer/VertexBuffer.zig``: a buffer sized for
``primitive_count * 3`` vertices with draw args (vertex_count,
instance_count, first_vertex, first_instance), supporting buffer-less
draws for procedural meshes (``VertexBuffer.zig:5-31`` — the terrain
passes no buffer and synthesizes vertices from vertex_index,
``Terrain.zig:126``).

Storage is a host-side staging array (numpy f32[verts, stride], the
analogue of a mapped GPU buffer, ``VertexBuffer.zig:33-35``); the frame
uploads it as a device tensor, again only when the version counter
moves.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .pipeline import VertexLayout


class VertexBuffer:
    def __init__(self, renderer=None, offset: int = 0,
                 primitive_count: int = 1,
                 layout: Optional[VertexLayout] = None):
        self.layout = layout
        self.vertex_count = primitive_count * 3
        self.first_vertex = offset * 3
        self.instance_count = 1
        self.first_instance = 0
        self.version = 0
        # instance refcount (Instance.zig:189-198): set_vertex_buffer
        # releases the previously-bound buffer and frees it at zero.
        # Python GC would reclaim the staging array anyway; the count
        # preserves the reference's eager-free semantics (the staging
        # + device tensors drop immediately, and a freed buffer loudly
        # fails map()).
        self.refcount = 0
        self._staging: Optional[np.ndarray] = None
        # device -> (version, tensor): one upload per device a version
        self._device: dict = {}
        if layout is not None:
            self._staging = np.zeros((self.vertex_count, layout.stride),
                                     np.float32)

    @staticmethod
    def new(renderer, offset: int, primitive_count: int,
            layout: Optional[VertexLayout] = None) -> "VertexBuffer":
        """``VertexBuffer.new`` (``VertexBuffer.zig:11-31``); pass
        ``layout=None`` for a buffer-less (procedural) draw."""
        return VertexBuffer(renderer, offset, primitive_count, layout)

    @property
    def has_buffer(self) -> bool:
        return self._staging is not None

    def map(self) -> np.ndarray:
        """Host-visible staging array (``VertexBuffer.zig:33-35``). Write
        packed f32 rows [vertex, attribute lanes]; marks dirty."""
        if self._staging is None:
            raise ValueError("buffer-less VertexBuffer cannot be mapped")
        self.version += 1
        return self._staging

    def write_vertices(self, data: np.ndarray, first: int = 0) -> None:
        buf = self.map()
        data = np.asarray(data, np.float32).reshape(-1, buf.shape[1])
        buf[first:first + len(data)] = data

    def device_array(self, device):
        """Staging as a tensor on ``device``, cached by version and
        device (a mesh reads it on each of its cards)."""
        if self._staging is None:
            return None
        version, t = self._device.get(device, (-1, None))
        if version != self.version:
            t = torch.from_numpy(self._staging.copy()).to(device)
            self._device[device] = (self.version, t)
        return t

    def retain(self) -> "VertexBuffer":
        self.refcount += 1
        return self

    def release(self) -> None:
        """Drop one instance reference; frees storage at zero
        (``Instance.zig:193-196``)."""
        self.refcount -= 1
        if self.refcount <= 0:
            self.free()

    def free(self) -> None:
        self._staging = None
        self._device = {}
