"""Instance: a drawable — pipeline + bound resources + vertex buffer.

Mirrors ``Renderer/Instance.zig``: ``create_node`` registers an Instance
and a SceneNode whose render emits its draw (:81-154); ``update_buffer``
writes into the instance's managed binding storage (:165-187);
``set_vertex_buffer`` swaps the draw source (:189-198).

Managed bindings are host staging arrays (flat 32-bit words,
byte-addressed like the reference's pooled GPU buffer) uploaded to
device tensors on demand, version-cached. The reference's x4 ring
(``MAX_COPIES``, :53) lets the CPU write frame N+1 while the GPU reads
frame N; each upload here is a fresh tensor, so one logical copy
suffices — the renderer still cycles ``current_buffer_slot`` for API
parity.

The builtin ``transform`` binding (``Pipeline.zig:47-49``) is not stored:
it is the composed node transform, computed on the device per frame and
handed to the vertex function as ``ctx.world``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from . import pipeline as pl
from .scene import SceneNode
from .vertex import VertexBuffer


@dataclass
class Binding:
    """Per-instance binding description (``Instance.zig:16-31``): a
    location and a byte size for managed storage (attachments — external
    buffers/textures — arrive as explicit arrays)."""

    location: int
    size: int = 0
    attachment: Optional[np.ndarray] = None


class _ManagedStore:
    """Flat 32-bit-word staging for one managed binding (byte-addressed
    writes, like queue.writeBuffer at Instance.zig:185).

    Words are stored as raw bit patterns (u32) so arbitrary struct
    payloads round-trip exactly, like the reference's untyped byte
    buffer (``Instance.zig:165-187``): float payloads land as their f32
    bits, integer/bytes payloads as their own bits. The device array is
    an f32 *view* of those bits — float fields read naturally; integer
    fields are recovered bit-exactly with ``vertex_stage.bitcast_u32``
    or ``bitcast_i32`` in the vertex function (no arithmetic touches
    them, so no NaN/denormal hazard).
    """

    def __init__(self, size_bytes: int):
        if size_bytes % 4:
            raise ValueError("binding size must be a multiple of 4 bytes")
        self.host = np.zeros(size_bytes // 4, np.uint32)
        self.version = 0
        # device -> (version, tensor): one upload per device a version
        self._device: dict = {}

    def write(self, byte_offset: int, value) -> None:
        if isinstance(value, (bytes, bytearray, memoryview)):
            raw = np.frombuffer(bytes(value), np.uint8)
            if raw.size % 4:
                raise ValueError(
                    "raw byte payload must be a multiple of 4 bytes")
            flat = raw.view(np.uint32)
        else:
            arr = np.asarray(value)
            if arr.dtype.kind in "ui":
                # integer payload: store the 32-bit two's-complement bits
                if arr.dtype.itemsize != 4:
                    arr = arr.astype(np.int64).astype(np.uint32)
                flat = arr.reshape(-1).view(np.uint32)
            elif arr.dtype.kind == "f":
                flat = arr.astype(np.float32).reshape(-1).view(np.uint32)
            else:
                raise TypeError(
                    f"unsupported update_buffer payload dtype {arr.dtype}")
        if byte_offset % 4:
            raise ValueError("byte offset must be 4-aligned")
        start = byte_offset // 4
        if start + flat.size > self.host.size:
            raise ValueError("update_buffer write out of bounds")
        self.host[start:start + flat.size] = flat
        self.version += 1

    def device_array(self, device):
        """The words as an f32 tensor on ``device`` (bit-exact: the
        upload copies bits, no value conversion), cached by version and
        device (a mesh reads it on each of its cards)."""
        version, t = self._device.get(device, (-1, None))
        if version != self.version:
            t = torch.from_numpy(self.host.view(np.float32).copy()).to(device)
            self._device[device] = (self.version, t)
        return t


class Instance:
    def __init__(self, renderer, pipeline: pl.Pipeline,
                 bindings: Sequence[Binding]):
        self.renderer = renderer
        self.pipeline = pipeline
        self.vertex_buffer = VertexBuffer(primitive_count=1)  # default: 3 verts, no buffer (VertexBuffer.zig:5-9)
        self.stores: dict[int, _ManagedStore] = {}
        self.attachments: dict[int, np.ndarray] = {}

        given = {b.location: b for b in bindings}
        for layout in pipeline.bindings:
            if layout.kind == pl.BUILTIN_TRANSFORM:
                continue  # synthesized per frame
            b = given.get(layout.location)
            if b is None:
                raise ValueError(
                    f"pipeline binding location {layout.location} "
                    f"({layout.kind}) has no Binding supplied")
            if b.attachment is not None:
                self.attachments[layout.location] = np.asarray(
                    b.attachment, np.float32)
            else:
                self.stores[layout.location] = _ManagedStore(b.size)
        self.id = renderer._register(renderer.instances, self)

    @staticmethod
    def create_node(renderer, *, pipeline: pl.Pipeline,
                    bindings: Sequence[Binding] = (),
                    bounding_box_p0=None,
                    bounding_box_p1=None) -> SceneNode:
        """``Instance.createNode`` (``Instance.zig:81-154``): registers
        the instance and wraps it in a SceneNode."""
        inst = Instance(renderer, pipeline, bindings)
        node = SceneNode(renderer, backing_instance=inst)
        if bounding_box_p0 is not None and bounding_box_p1 is not None:
            node.set_bounding_box(bounding_box_p0, bounding_box_p1)
        return node

    # reference spelling (Instance.zig:81)
    createNode = create_node

    # -- runtime updates (Instance.zig:165-198) ------------------------------

    def update_buffer(self, location: int, value, byte_offset: int = 0) -> None:
        """Write into a managed binding's storage, byte-addressed like
        the reference's untyped ``queue.writeBuffer``
        (``Instance.zig:165-187``). Payloads may be float arrays/scalars
        (stored as f32), integer arrays/scalars (stored as their 32-bit
        bits — read back with ``vertex_stage.bitcast_i32``), or raw
        ``bytes`` (multiple of 4)."""
        if location not in self.stores:
            raise ValueError(f"location {location} is not a managed binding")
        self.stores[location].write(byte_offset, value)

    def set_vertex_buffer(self, vertex_buffer: VertexBuffer) -> None:
        """Swap the draw source, refcounting buffer lifetimes like
        ``Instance.zig:189-198``: the incoming buffer is retained, the
        previously-bound one released (freed at refcount zero)."""
        old = self.vertex_buffer
        self.vertex_buffer = vertex_buffer.retain()
        if old is not None and old is not vertex_buffer:
            old.release()
        self.renderer.bump_scene_version()

    def binding_device_array(self, location: int, device):
        if location in self.stores:
            return self.stores[location].device_array(device)
        return torch.from_numpy(self.attachments[location]).to(device)

    def destroy(self) -> None:
        if self in self.renderer.instances:
            self.renderer.instances.remove(self)
            self.renderer.bump_scene_version()
