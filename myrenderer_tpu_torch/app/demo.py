"""The demo application: terrain + two polygons + orbiting camera.

One-to-one rebuild of ``App/App.zig``: a window
("Platypro's Thing", 1280x720, :40), a 3D terrain surface under
``perspective(90, 1.0, 0.1, 200)`` (:64-66), two polygons (a concave
heptagon and a square, :68-83) under a shared 2D root with
``projection2D(0..200 x 200..0, 0.1..200)`` (:85-89), and a per-frame
orbit camera — ``cam = (10 cos t, 6, 10 sin t)`` looking at the origin
(:98-104) applied as the *terrain root node's* transform, composing with
the surface projection at render time.

Frame sequence (:105-111): begin, clear(0.259, 0.141, 0.271), draw
surface3d, draw surface2d, end, renderer.update().

Run:  python -m myrenderer_tpu_torch.app.demo --size 1920x1080 \
          --frames 60 --time          (one CUDA card)
      python -m myrenderer_tpu_torch.app.demo --device cpu \
          --size 128x128 --out frame.png
      python -m myrenderer_tpu_torch.app.demo --device cpu \
          --backend oracle --size 96x96 --frames 3 --gif orbit.gif

``--time`` prints ms/frame beside the last timed frame's overflow flag
(``Draw.last_overflow``: the pair lane, the clip lane), as the JAX demo
does.

Row bands have no flag (nor has the JAX demo's): build
``DemoApp(..., mesh=parallel.make_mesh(...))`` from Python.
"""

from __future__ import annotations

import argparse
import math
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import math3d
from ..content import Polygon, Terrain
from ..renderer import Core, Draw, Renderer, SceneNode, Surface
from .assets import default_heightmap

CLEAR_COLOR = (0.259, 0.141, 0.271, 1.0)

POLYGON1 = [  # App.zig:68-76 (concave heptagon)
    (62.742857, 106.97143), (93.085712, 65.828571), (147.08571, 85.628572),
    (122.14285, 144.77143), (102.34286, 93.857142), (79.199998, 130.37143),
    (81.00000, 105.17143),
]
POLYGON2 = [  # App.zig:78-83 (square)
    (10.0, 10.0), (40.0, 10.0), (40.0, 40.0), (10.0, 40.0),
]


@dataclass
class DemoApp:
    """The full App.zig scene, reusable from tests and the benchmark."""

    width: int = 1280
    height: int = 720
    heightmap: Optional[object] = None      # path, array, or None=generated
    backend: str = "auto"                   # Renderer raster_backend
    fixed_timestep: Optional[float] = 1.0 / 60.0
    device: str = "cuda"
    mesh: Optional[object] = None           # row bands (parallel.make_mesh)

    def __post_init__(self):
        self.core = Core(fixed_timestep=self.fixed_timestep)
        self.window = self.core.create_window(self.width, self.height,
                                              "Platypro's Thing")
        self.renderer = Renderer(self.core, device=self.device,
                                 raster_backend=self.backend, mesh=self.mesh)
        # scene construction is DEFERRED to the window_open event, the
        # reference's lifecycle (App.zig:54-92 builds the scene inside
        # the event branch of the first tick). create_window enqueued
        # it; drain synchronously here so the scene exists before the
        # first tick (headless Core has no OS latency to wait out).
        while (ev := self.core.next_event()) is not None:
            if ev.kind == "window_open":
                self._on_window_open(ev.window)

    def _on_window_open(self, window):
        """The App.zig:54-92 event branch: adopt the window, build the
        terrain + polygon scene and the two surfaces."""
        self.renderer.adopt_window(window)

        terrain_mod = Terrain(self.renderer)
        polygon_mod = Polygon(self.renderer)

        hm = self.heightmap if self.heightmap is not None \
            else default_heightmap()
        self.terrain = terrain_mod.create_terrain(hm)
        self.surface3d = Surface.create_window_scene(
            self.renderer, self.window, self.terrain)
        self.surface3d.set_perspective(
            math3d.perspective(90, 1.0, 0.1, 200))

        self.polygon1 = polygon_mod.create_polygon(POLYGON1)
        self.polygon2 = polygon_mod.create_polygon(POLYGON2)
        self.base_2d_node = SceneNode.create(self.renderer)
        self.base_2d_node.add_child(self.polygon1.get_node())
        self.base_2d_node.add_child(self.polygon2.get_node())
        self.surface2d = Surface.create_window_scene(
            self.renderer, self.window, self.base_2d_node)
        self.surface2d.set_perspective(math3d.projection_2d(
            left=0.0, right=200.0, bottom=200.0, top=0.0,
            near=0.1, far=200.0))

        self.draw = Draw.create(self.renderer)
        self.terrain_mod = terrain_mod
        self.polygon_mod = polygon_mod

    def tick(self):
        """One frame (App.zig:97-112)."""
        rend = self.renderer
        t = rend.elapsed_time
        cam = (10.0 * math.cos(t), 6.0, 10.0 * math.sin(t))
        self.terrain.set_xform(
            math3d.look_at(cam, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0)))
        self.draw.begin()
        self.draw.clear(CLEAR_COLOR)
        self.draw.draw_surface(self.surface3d)
        self.draw.draw_surface(self.surface2d)
        fb = self.draw.end()
        rend.update()
        return fb

    def run(self, frames: int) -> np.ndarray:
        fb = None
        for _ in range(frames):
            fb = self.tick()
        return fb.cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", default="1280x720",
                    help="WxH (default 1280x720, the reference's window)")
    ap.add_argument("--frames", type=int, default=1)
    ap.add_argument("--out", default=None, help="write last frame PNG")
    ap.add_argument("--heightmap", default=None,
                    help="16-bit grayscale PNG (default: generated)")
    ap.add_argument("--backend", default="auto", choices=["auto", "oracle"])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without it)")
    ap.add_argument("--time", action="store_true",
                    help="print steady-state ms/frame")
    ap.add_argument("--dump-dir", default=None,
                    help="write every frame as frame_%%04d.png")
    ap.add_argument("--gif", default=None,
                    help="write all --frames frames as one animated GIF"
                         " — the headless stand-in for the reference's"
                         " animated window (App.zig:40,52)")
    args = ap.parse_args(argv)

    w, h = (int(v) for v in args.size.split("x"))
    app = DemoApp(width=w, height=h, heightmap=args.heightmap,
                  backend=args.backend, device=args.device)
    dev = app.renderer.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if args.dump_dir:
        import os

        from ..utils.png import save_rgba8
        os.makedirs(args.dump_dir, exist_ok=True)
        for i in range(args.frames):
            app.tick()
            save_rgba8(os.path.join(args.dump_dir, f"frame_{i:04d}.png"),
                       app.window.read_pixels())
        print(f"wrote {args.frames} frames to {args.dump_dir}")
        return

    if args.gif:
        from PIL import Image
        imgs = []
        for _ in range(args.frames):
            app.tick()
            imgs.append(Image.fromarray(
                app.window.read_pixels(), "RGBA").convert("RGB"))
        # replay at the app's fixed step (GIF durations are in ms and
        # most decoders clamp below ~20 ms)
        dur = max(20, round((app.fixed_timestep or 1 / 60) * 1000))
        imgs[0].save(args.gif, save_all=True, append_images=imgs[1:],
                     duration=dur, loop=0)
        print(f"wrote {args.gif} ({args.frames} frames)")
        return

    app.tick()  # warm-up (builds K1 on first use)
    if args.time and args.frames > 1:
        sync()
        t0 = time.perf_counter()
        n = args.frames - 1
        for _ in range(n):
            app.tick()
        sync()
        dt = time.perf_counter() - t0
        name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu")
        # a frame that dropped triangles must not pass as a faster one
        ovf = app.draw.last_overflow.cpu().numpy()
        print(f"{n} frames: {dt * 1000 / n:.3f} ms/frame "
              f"({n / dt:.1f} fps) overflow={ovf.tolist()} on {name}")
    elif args.frames > 1:
        for _ in range(args.frames - 1):
            app.tick()

    if args.out:
        from ..utils.png import save_rgba8
        save_rgba8(args.out, app.window.read_pixels())
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
