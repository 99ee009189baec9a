"""Renderer core: frame clock, object registries, window adoption.

Port of ``myrenderer_tpu/renderer/core.py`` (``Renderer/Renderer.zig``
module state plus the slice of ``mach.Core`` the reference uses). There
is no OS window: a Window is a headless render target, an RGBA
framebuffer tensor on the renderer's device.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device


class Window:
    """Headless render target (swap-chain analogue). Owns the color
    framebuffer f32[H, W, 4]; ``read_pixels`` quantizes to uint8 the way
    a bgra8unorm swap chain would."""

    _next_id = 0

    def __init__(self, width: int, height: int, title: str = ""):
        self.id = Window._next_id
        Window._next_id += 1
        self.width = int(width)
        self.height = int(height)
        self.title = title
        self.device = torch.device("cpu")
        self.framebuffer = self._zeros()

    def _zeros(self) -> torch.Tensor:
        return torch.zeros((self.height, self.width, 4), dtype=torch.float32,
                           device=self.device)

    @property
    def framebuffer_size(self) -> tuple[int, int]:
        return (self.width, self.height)

    def to(self, device: torch.device) -> None:
        """Move the framebuffer to ``device`` (done by the adopting
        renderer); a banded frame (parallel.Banded) is assembled there."""
        self.device = device
        self.framebuffer = self.framebuffer.to(device)

    def resize(self, width: int, height: int) -> None:
        if (int(width), int(height)) == (self.width, self.height):
            return
        self.width, self.height = int(width), int(height)
        self.framebuffer = self._zeros()

    def read_pixels(self, as_uint8: bool = True) -> np.ndarray:
        # a banded frame (parallel.Banded) assembles on the host here
        fb = self.framebuffer.cpu().numpy()
        if not as_uint8:
            return fb
        return np.clip(np.rint(fb * 255.0), 0, 255).astype(np.uint8)


class Event:
    """A ``mach.Core`` event: ``window_open``, ``close`` or
    ``framebuffer_resize``."""

    __slots__ = ("kind", "window")

    def __init__(self, kind: str, window: Optional[Window] = None):
        self.kind = kind
        self.window = window

    def __repr__(self):
        wid = None if self.window is None else self.window.id
        return f"Event({self.kind!r}, window={wid})"


class Core:
    """Frame-loop driver: creates windows, feeds the renderer's clock and
    drives the event queue (``create_window`` enqueues ``window_open``,
    so an app can build its scene in the event, like ``App.zig:54-92``).
    ``fixed_timestep`` makes frames deterministic; None uses wall-clock
    deltas."""

    def __init__(self, fixed_timestep: Optional[float] = None):
        self.windows: list[Window] = []
        self.fixed_timestep = fixed_timestep
        self._last_time = time.perf_counter()
        self._events: list[Event] = []
        self.should_close = False

    def create_window(self, width: int, height: int,
                      title: str = "") -> Window:
        w = Window(width, height, title)
        self.windows.append(w)
        self.push_event(Event("window_open", w))
        return w

    def resize_window(self, window: Window, width: int,
                      height: int) -> None:
        window.resize(width, height)
        self.push_event(Event("framebuffer_resize", window))

    def request_close(self, window: Optional[Window] = None) -> None:
        self.push_event(Event("close", window))

    def push_event(self, event: Event) -> None:
        self._events.append(event)

    def next_event(self) -> Optional[Event]:
        if not self._events:
            return None
        ev = self._events.pop(0)
        if ev.kind == "close":
            self.should_close = True
        return ev

    def next_delta_time(self) -> float:
        if self.fixed_timestep is not None:
            return self.fixed_timestep
        now = time.perf_counter()
        dt = now - self._last_time
        self._last_time = now
        return dt


class Renderer:
    """Top-level renderer state (``Renderer/Renderer.zig:21-34``): frame
    clock, adopted window, object registries, and the torch ``device``
    every frame runs on: the card unless the caller asks for the CPU
    (``device="cpu"``); without CUDA the default raises.

    ``raster_backend``: ``"auto"`` (the JAX package's ``"pallas"``)
    rasterizes with exact binning and K1, which runs as a CUDA kernel on CUDA tensors and as its plain version
    on CPU tensors; ``"oracle"`` takes the full-frame oracle
    (``ops/raster_ref.py``). Unlike the JAX package, whose ``"auto"``
    picks the oracle on the CPU, ``"auto"`` is the tile path on every
    device.

    ``mesh`` (``parallel.make_mesh``) renders each frame in row bands,
    one per mesh row on that row's device (the tile backend only), with
    the pre-kernel stage split into as many triangle shards, each on its
    band's device; the mesh's first device is the renderer's ``device``
    (``device`` must name it), and the framebuffer stays banded
    (``parallel.Banded``).

    Transform products must stay full fp32 on the card, so TF32 is
    switched off for matmuls and cuDNN when a renderer starts."""

    MAX_COPIES = 4

    def __init__(self, core: Optional[Core] = None, device="cuda",
                 raster_backend: str = "auto", mesh=None):
        self.device = resolve_device(device)
        if mesh is not None:
            first, asked = mesh.first_device, torch.device(device)
            if asked.type != first.type or (
                    asked.index not in (None, first.index)):
                raise ValueError(f"renderer device {asked} is not the "
                                 f"mesh's first device {first}")
            self.device = first
        self.mesh = mesh
        self.raster_backend = raster_backend
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.core = core or Core(fixed_timestep=1.0 / 60.0)
        self.delta_time = 0.0
        self.elapsed_time = 0.0
        self.frame_counter = 1
        self.current_buffer_slot = 0

        self.window: Optional[Window] = None

        self.pipelines: list = []
        self.instances: list = []
        self.surfaces: list = []
        self.scene_nodes: list = []
        self.draws: list = []

        # bumped on any structural scene change -> frame plan rebuild
        self.scene_version = 0
        # bumped when any node's AABB changes -> cull-input re-upload
        self.bounds_version = 0

        # When True, Draw.end keeps each raster pass's per-pixel winning
        # triangle id in Draw.last_winners (the exact decision surface
        # for parity checks).
        self.debug_winner = False

        # When True, Draw.end fills frame_stats with per-frame counters
        # (no device sync).
        self.collect_stats = False
        self.frame_stats: dict = {}

        # When True, Draw.end makes the NEXT capacity rung's frame plan
        # (big_scale x4) after each frame and, on a card, captures its
        # CUDA graph, so an overflow re-renders with a graph replay
        # instead of a warm-up and a capture. The capture runs at the end
        # of Draw.end on the calling thread, once per scene version and
        # rung (Draw._maybe_warm_next_capacity).
        self.precompile_capacity_bump = False

        # When True, Draw.end reads every frame's overflow flag
        # synchronously before publishing and re-renders a flagged frame
        # at the next capacity rung: no published frame drops
        # triangles, for one host sync a frame. Default False: the flag
        # is polled asynchronously, and a steady-state overflow can drop
        # triangles in up to Draw.OVERFLOW_WINDOW (8) published frames
        # before the bump lands (frame_stats["overflow_risk_frames"]).
        self.strict_overflow = False

    def adopt_window(self, window: Window) -> None:
        """Bind the renderer to a window; its framebuffer moves to the
        renderer's device."""
        window.to(self.device)
        self.window = window

    def update(self) -> None:
        """Advance the frame clock (``Renderer.zig:52-56``)."""
        self.current_buffer_slot = ((self.current_buffer_slot + 1)
                                    % self.MAX_COPIES)
        self.frame_counter += 1
        self.delta_time = self.core.next_delta_time()
        self.elapsed_time += self.delta_time

    def bump_scene_version(self) -> None:
        self.scene_version += 1
        self.bounds_version += 1

    def bump_bounds_version(self) -> None:
        self.bounds_version += 1

    def _register(self, pool: list, obj) -> int:
        pool.append(obj)
        self.bump_scene_version()
        return len(pool) - 1
