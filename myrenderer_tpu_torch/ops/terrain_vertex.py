"""K3, the terrain's whole-stream vertex shader: every triangle of a
terrain batch, its clip positions, varyings and submission ranks, in one
launch.

The reference's terrain has no vertex buffer: its vertex shader
(``Terrain/Terrain.zig:21-78``) makes the six vertices of each heightmap
quad from the vertex index and reads their heights from a storage
binding. The port's frame runs it over the whole stream at once
(``content/terrain.py``): :func:`terrain_vertex` launches
``csrc/terrain_vertex.cu`` for CUDA tensors and runs
:func:`terrain_vertex_reference`, the same function in plain torch, for
CPU tensors. There is no fallback from one to the other: a build or
launch failure raises. The kernel is built at first use like K1 and K2
(``cuda_build.build_library``) and bound with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np
import torch

from . import raster_common as rc
from .cuda_build import CSRC, build_library
from .raster_common import fma
from .vertex_stage import matmul4

_SOURCE = os.path.join(CSRC, "terrain_vertex.cu")

# (x, z) corner offsets for the 6 vertices of a quad (Terrain.zig:28-35)
QUAD_VALS = np.array([[1.0, 0.0], [0.0, 0.0], [1.0, 1.0],
                      [1.0, 1.0], [0.0, 0.0], [0.0, 1.0]], np.float32)
# heightmap index offsets per corner, in units of (size, 1)
# (Terrain.zig:38-45): [quad+size, quad, quad+size+1, quad+size+1, quad,
# quad+1]
LOOKUP_ROW = np.array([1, 0, 1, 1, 0, 0], np.int32)   # multiples of size
LOOKUP_COL = np.array([0, 0, 1, 1, 0, 1], np.int32)   # +1 offsets


def flush_subnormals(h: torch.Tensor) -> torch.Tensor:
    """Heights as the JAX package reads them: a subnormal one is a zero
    of its sign (XLA's CPU runtime flushes subnormal inputs, and a TPU has
    none). The terrain's shaders apply it where they read a height."""
    tiny = torch.finfo(torch.float32).tiny
    return torch.where(h.abs() < tiny, torch.copysign(torch.zeros_like(h), h),
                       h)


def offset(size: int, device) -> torch.Tensor:
    """``0.1 * size`` rounded to f32, as the reference computes it, on
    ``device``."""
    return (torch.tensor(0.1, dtype=torch.float32) * float(size)).to(device)


class TerrainVertexKernel:
    """The built K3 library and its launch count. ``launches`` grows by
    one at each launch of the kernel and nowhere else."""

    def __init__(self):
        self.launches = 0
        self.lib: Optional[ctypes.CDLL] = None
        self.build_seconds: Optional[float] = None
        self.build_log = ""

    def build(self) -> ctypes.CDLL:
        """Compile (once per source and flag set) and load the kernel."""
        if self.lib is not None:
            return self.lib
        lib, self.build_seconds, self.build_log = build_library(_SOURCE, "K3")
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.terrain_vertex_launch.argtypes = [p, i64, i64, p, i64, i64,
                                              p, i64, i64, i64, i32, i32,
                                              p, p, p, p]
        lib.terrain_vertex_launch.restype = ctypes.c_int
        self.lib = lib
        return lib

    def __call__(self, heights, uniforms, worlds, size: int) -> rc.Triangles:
        lib = self.build()
        n_inst, s2 = heights.shape
        dev = heights.device
        T = 2 * n_inst * s2
        clip = torch.empty((T, 3, 4), dtype=torch.float32, device=dev)
        vary = torch.empty((T, 3, 4), dtype=torch.float32, device=dev)
        ids = torch.empty(T, dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            handle = torch.cuda.current_stream().cuda_stream
            err = lib.terrain_vertex_launch(
                heights.data_ptr(), *heights.stride(),
                uniforms.data_ptr(), *uniforms.stride(),
                worlds.data_ptr(), *worlds.stride(), n_inst, size,
                clip.data_ptr(), vary.data_ptr(), ids.data_ptr(), handle)
        if err != 0:
            raise RuntimeError(f"K3 launch failed: CUDA error {err}")
        self.launches += 1
        return rc.Triangles(clip, vary, ids, planar=True)


K3 = TerrainVertexKernel()


def _check(heights, uniforms, worlds, size: int):
    dev = heights.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"K3 runs on cuda or cpu tensors, not {dev}")
    if heights.dim() != 2 or heights.shape[1] != size * size or size < 1:
        raise ValueError(f"heights must be [I, {size * size}], got "
                         f"{list(heights.shape)}")
    n_inst = heights.shape[0]
    if not 1 <= n_inst < 2**16 or 2 * n_inst * size * size >= 2**31:
        raise ValueError(f"{n_inst} instances of size {size} are out of "
                         "K3's range")
    for name, t, shape in (("heights", heights, None),
                           ("uniforms", uniforms, None),
                           ("worlds", worlds, (n_inst, 4, 4))):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, heights on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got "
                             f"{list(t.shape)}")
    if uniforms.dim() != 2 or uniforms.shape[0] != n_inst \
            or uniforms.shape[1] < 16:
        raise ValueError(f"uniforms must be [{n_inst}, >= 16], got "
                         f"{list(uniforms.shape)}")


def terrain_vertex(heights: torch.Tensor, uniforms: torch.Tensor,
                   worlds: torch.Tensor, size: int) -> rc.Triangles:
    """Every triangle of ``I`` terrain instances of ``size`` x ``size``
    quads: ``heights`` f32[I, size^2] (binding 1), ``uniforms`` f32[I,
    >= 16] (binding 0: the data transform, row-major, first), ``worlds``
    f32[I, 4, 4] (any strides), each on one device. Returns
    ``Triangles`` with clip and varyings f32[2 I size^2, 3, 4] and ids
    i32[2 I size^2] in the JAX package's order: per instance, the first
    triangle of every quad q (id 2q), then the second (2q + 1), ids
    offset by 2 size^2 per instance; ``planar``. A CUDA call launches K3,
    a CPU call runs :func:`terrain_vertex_reference`."""
    _check(heights, uniforms, worlds, size)
    if heights.device.type == "cpu":
        return terrain_vertex_reference(heights, uniforms, worlds, size)
    return K3(heights, uniforms, worlds, size)


def terrain_vertex_reference(heights: torch.Tensor, uniforms: torch.Tensor,
                             worlds: torch.Tensor,
                             size: int) -> rc.Triangles:
    """The plain PyTorch version of K3, same arguments and results, on
    any device.

    The terrain is a regular grid, so the per-vertex heightmap gathers
    become four shifted views of the flat height array (extended with
    copies of its last element: the robust-buffer-access clamp of the
    reference's out-of-bounds ``quad + size + 1`` lookups). Heights are
    read through :func:`flush_subnormals`, as K3 reads them."""
    dev = worlds.device
    s2 = size * size
    c02 = torch.tensor(0.2, dtype=torch.float32).to(dev)
    noff = -offset(size, dev)
    n_inst = worlds.shape[0]
    quad = torch.arange(s2, dtype=torch.int32, device=dev)
    qx = (quad // size).float()
    qz = (quad % size).float()
    # ``0.2 * (corner + q) - 0.1 * size`` contracts to
    # fma(0.2, corner + q, -(0.1 * size))
    xs = [fma(c02, float(QUAD_VALS[s, 0]) + qx, noff) for s in range(6)]
    zs = [fma(c02, float(QUAD_VALS[s, 1]) + qz, noff) for s in range(6)]
    ones = torch.ones(s2, dtype=torch.float32, device=dev)

    clips, varys, ids = [], [], []
    for i in range(n_inst):
        hm = flush_subnormals(heights[i])
        uniform = uniforms[i]
        hm_ext = torch.cat([hm, hm[-1:].expand(size + 1)])
        c_q = hm_ext[0:s2]
        c_qs = hm_ext[size:s2 + size]
        c_qs1 = hm_ext[size + 1:s2 + size + 1]
        c_q1 = hm_ext[1:s2 + 1]
        # per the LOOKUP tables: [q+size, q, q+size+1, q+size+1, q, q+1]
        hs = (c_qs, c_q, c_qs1, c_qs1, c_q, c_q1)
        ys = [5.0 * h for h in hs]
        m = matmul4(worlds[i], uniform[:16].reshape(4, 4))
        # clip channel ch of slot s: ((m0*x + m1*y) + m2*z) + m3 with
        # y = 5*h. The reference's compiler folds m1*(5*h) into
        # (m1*5)*h and contracts the rest, giving
        # fma(m2, z, fma(m0, x, (m1*5)*h)) + m3
        slot_clip = [torch.stack(
            [fma(m[ch, 2], zs[s],
                 fma(m[ch, 0], xs[s], (m[ch, 1] * 5.0) * hs[s]))
             + m[ch, 3] for ch in range(4)], -1)
            for s in range(6)]                              # [s2, 4]
        slot_vary = [torch.stack([ys[s], ys[s], ys[s], ones], -1)
                     for s in range(6)]
        for h in (0, 3):
            clips.append(torch.stack(slot_clip[h:h + 3], 1))
            varys.append(torch.stack(slot_vary[h:h + 3], 1))
        ids.append(2 * quad + 2 * s2 * i)
        ids.append(2 * quad + 1 + 2 * s2 * i)
    return rc.Triangles(torch.cat(clips), torch.cat(varys),
                        torch.cat(ids), planar=True)
