"""The stress scene: a 4K framebuffer, a ~1M-triangle terrain and 10k
instances in one draw (torch).

Port of ``myrenderer_tpu/app/stress.py``. The 10k instances are one
instanced draw (``instance_count``, ``VertexBuffer.zig:7`` generalized):
a small triangle whose vertex function places each draw instance on a
grid, with its height read from the terrain's heightmap through
``VertexCtx.binding_at``. At full width (3840x2160, terrain 708) a
frame submits 1,002,528 terrain and 10,000 marker triangles in two
batches of one surface: one merged raster pass, one K1 launch.

Run:  python -m myrenderer_tpu_torch.app.stress --frames 20 --time
      python -m myrenderer_tpu_torch.app.stress --device cpu \\
          --size 96x96 --terrain 48 --instances 16 --out stress.png

After the timed frames the CLI prints the last frame's overflow flag
(``Draw.last_overflow``: the pair lane, the clip lane) and exits through
``SystemExit`` when it is set: a frame that dropped triangles must not
pass as a faster one (the JAX stress CLI's guard).
"""

from __future__ import annotations

import argparse
import math
import subprocess
import time

import numpy as np
import torch

from .. import math3d
from ..content import Terrain
from ..ops.vertex_stage import matvec4, per_device
from ..renderer import (Binding, BindingLayout, Core, Draw, Instance,
                        Pipeline, Renderer, Surface, VertexBuffer)
from ..renderer.pipeline import BUILTIN_TRANSFORM, MANAGED_STORAGE
from .assets import default_heightmap

CLEAR_COLOR = (0.259, 0.141, 0.271, 1.0)
MARKER_COLOR = (1.0, 0.4, 0.2, 1.0)


def _instanced_marker_pipeline(rend, grid: int, terrain_size: int):
    """``grid * grid`` small markers, one per grid cell, standing on the
    heightmap (storage binding 0); each is placed from
    ``ctx.draw_instance`` alone. Constants are the reference's Python
    floats rounded once to f32, made once per device
    (``vertex_stage.per_device``: the renderer's here, another card of a
    mesh at its first frame there): a later frame uploads nothing."""
    spacing = 0.2 * terrain_size / grid
    f32 = torch.float32
    consts = per_device(lambda dev: tuple(
        torch.tensor(v, dtype=f32).to(dev)
        for v in (spacing, 0.1 * terrain_size, spacing * 0.3,
                  spacing * 0.3 * 2.0, 5.0, MARKER_COLOR)), rend.device)

    def vertex_fn(ctx):
        dev = ctx.world.device
        c_spacing, c_off, c_s, c_up, c_5, color = consts(dev)
        di = ctx.draw_instance
        gx = (di % grid).to(f32)
        gz = (di // grid).to(f32)
        # world-space cell center over the terrain footprint
        x = (gx + 0.5) * c_spacing - c_off
        z = (gz + 0.5) * c_spacing - c_off
        # the terrain height at the cell: one gather (binding_at)
        cell = (torch.clamp((gz * float(terrain_size) / float(grid))
                            .to(torch.int32), 0, terrain_size - 1)
                * terrain_size
                + torch.clamp((gx * float(terrain_size) / float(grid))
                              .to(torch.int32), 0, terrain_size - 1))
        h = ctx.binding_at(0, cell)
        vi = ctx.vertex_index % 3
        zero = torch.zeros((), dtype=f32, device=dev)
        # a small clockwise triangle standing on the terrain
        ox = torch.where(vi == 0, zero, torch.where(vi == 1, c_s, -c_s))
        oy = torch.where(vi == 0, c_up, zero)
        # ``5 * h + oy`` contracts to fma(5, h, oy)
        pos = torch.stack([x + ox, torch.addcmul(oy, c_5, h), z,
                           torch.ones((), dtype=f32, device=dev)])
        return matvec4(ctx.world, pos), color

    return Pipeline.create(
        rend, vertex_fn=vertex_fn,
        bindings=[BindingLayout(0, MANAGED_STORAGE),
                  BindingLayout(1, BUILTIN_TRANSFORM)],
        cull_mode="none")


class StressApp:
    """The stress scene on ``device``; ``backend`` is the renderer's
    ``raster_backend``, ``mesh`` its row bands."""

    def __init__(self, width: int = 3840, height: int = 2160,
                 terrain_size: int = 708, instances: int = 10000,
                 device: str = "cuda", backend: str = "auto", mesh=None):
        self.core = Core(fixed_timestep=1.0 / 60.0)
        self.window = self.core.create_window(width, height, "stress")
        self.renderer = Renderer(self.core, device=device,
                                 raster_backend=backend, mesh=mesh)
        self.renderer.adopt_window(self.window)

        hm = default_heightmap(terrain_size)
        self.terrain = Terrain(self.renderer).create_terrain(hm)
        self.triangles = terrain_size * terrain_size * 2 + instances

        grid = math.isqrt(instances)
        if grid * grid != instances:
            raise ValueError(f"instances must be a square, got {instances}")
        pipe = _instanced_marker_pipeline(self.renderer, grid, terrain_size)
        heights = (1.0 - hm.astype(np.float32) / 65535.0).reshape(-1)
        vb = VertexBuffer.new(self.renderer, 0, 1)   # 3 verts, no buffer
        vb.instance_count = instances
        bound = 0.1 * terrain_size
        markers = Instance.create_node(
            self.renderer, pipeline=pipe,
            bindings=[Binding(0, size=heights.size * 4)],
            bounding_box_p0=(-bound, 0.0, -bound),
            bounding_box_p1=(bound, 6.0, bound))
        markers.get_backing().update_buffer(0, heights)
        markers.get_backing().set_vertex_buffer(vb)

        self.terrain.add_child(markers)   # share the camera transform
        self.surface = Surface.create_window_scene(
            self.renderer, self.window, self.terrain)
        far = max(200.0, 0.6 * terrain_size)
        self.surface.set_perspective(math3d.perspective(90, 1.0, 0.1, far))
        self.draw = Draw.create(self.renderer)
        self._bound = bound

    def tick(self):
        """One frame: the camera orbits the terrain."""
        t = self.renderer.elapsed_time
        r = 1.1 * self._bound
        cam = (r * math.cos(t), 0.9 * self._bound + 6.0, r * math.sin(t))
        self.terrain.set_xform(
            math3d.look_at(cam, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0)))
        self.draw.begin()
        self.draw.clear(CLEAR_COLOR)
        self.draw.draw_surface(self.surface)
        fb = self.draw.end()
        self.renderer.update()
        return fb


def device_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them,
    or ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={device.index or 0}"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", default="3840x2160", help="WxH")
    ap.add_argument("--terrain", type=int, default=708,
                    help="heightmap side (708: 1,002,528 triangles)")
    ap.add_argument("--instances", type=int, default=10000,
                    help="markers in the instanced draw (a square)")
    ap.add_argument("--frames", type=int, default=8,
                    help="frames after one warm-up frame")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without it)")
    ap.add_argument("--backend", default="auto", choices=["auto", "oracle"])
    ap.add_argument("--out", default=None, help="write last frame PNG")
    ap.add_argument("--time", action="store_true",
                    help="print ms/frame over the frames after warm-up")
    args = ap.parse_args(argv)

    w, h = (int(v) for v in args.size.split("x"))
    app = StressApp(width=w, height=h, terrain_size=args.terrain,
                    instances=args.instances, device=args.device,
                    backend=args.backend)
    dev = app.renderer.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    print(f"triangles/frame: {app.triangles}", flush=True)
    t0 = time.perf_counter()
    app.tick()                   # warm-up (builds K1 on first use)
    sync()
    print(f"first frame: {time.perf_counter() - t0:.3f} s", flush=True)
    t0 = time.perf_counter()
    for _ in range(args.frames):
        app.tick()
    sync()
    ovf = app.draw.last_overflow.cpu().numpy()
    if args.time and args.frames:
        dt = (time.perf_counter() - t0) / args.frames
        print(f"{args.frames} frames: {dt * 1000:.3f} ms/frame "
              f"({1 / dt:.2f} fps, {app.triangles / dt / 1e6:.2f} Mtri/s) "
              f"overflow={ovf.tolist()} on {device_line(dev)}", flush=True)
    else:
        print(f"overflow={ovf.tolist()}", flush=True)
    if ovf.any():
        raise SystemExit("OVERFLOW during timed loop — the frames dropped "
                         "triangles, timing not comparable")
    if args.out:
        from ..utils.png import save_rgba8
        save_rgba8(args.out, app.window.read_pixels())
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
