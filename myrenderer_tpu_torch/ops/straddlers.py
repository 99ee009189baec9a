"""K4, the straddler selection: a batch's first ``cap`` eye-plane
straddlers in array order, clipped into its appendee block, in one
launch and with no sort.

``raster_common.select_straddlers`` launches it for CUDA tensors (and
runs its plain version, ``raster_common.select_straddlers_reference``,
for CPU tensors); the results are the plain version's, bit for bit. The
kernel (``csrc/straddlers.cu``) is built at first use like K1 and K2
(``cuda_build.build_library``) and bound with ``ctypes``. It reads
nothing back to the host, so a frame that runs it stays one CUDA graph
replay.

**Scratch.** The launch ranks its chunks through a ticket, a done
counter and a status word a chunk in device memory. They must be zero
when it starts, and its last block zeroes them again, so a scratch is
zeroed once, when it is made, and never by a launch or a graph node.
Two launches that run at once must not share one: a scratch belongs to
one (device, stream) for eager calls, and to one CUDA graph for the
calls captured into it (:func:`graph_scratch`, which
``renderer/compiled.py`` opens around a frame's warm-up and capture). A
graph captured outside it gets a scratch of its own a call, zeroed by a
memset node of the graph.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from .cuda_build import CSRC, ZeroedScratch, build_library

_SOURCE = os.path.join(CSRC, "straddlers.cu")


class StraddlersKernel:
    """The built K4 library, its launch count and its scratch.
    ``launches`` grows by one at each launch of the kernel and nowhere
    else."""

    def __init__(self):
        self.launches = 0
        self.lib: Optional[ctypes.CDLL] = None
        self.build_seconds: Optional[float] = None
        self.build_log = ""
        self.scratch = ZeroedScratch()

    def build(self) -> ctypes.CDLL:
        """Compile (once per source and flag set) and load the kernel."""
        if self.lib is not None:
            return self.lib
        lib, self.build_seconds, self.build_log = build_library(_SOURCE, "K4")
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.straddlers_blocks.argtypes = [i32]
        lib.straddlers_blocks.restype = i32
        lib.straddlers_max_channels.argtypes = []
        lib.straddlers_max_channels.restype = i32
        lib.straddlers_launch.argtypes = ([p, i64, i64, i64, p, i64, i64, i64,
                                           p, i64, i32, i32, i32]
                                          + [p] * 7)
        lib.straddlers_launch.restype = ctypes.c_int
        self.lib = lib
        return lib

    def __call__(self, tri_clip, tri_vary, valid, cap: int):
        """``select_straddlers``' five results for CUDA tensors of T > 0
        triangles (checked by the caller)."""
        lib = self.build()
        T, C = tri_clip.shape[0], tri_vary.shape[-1]
        if C > lib.straddlers_max_channels():
            raise ValueError(f"K4 takes at most "
                             f"{lib.straddlers_max_channels()} varying "
                             f"channels, got {C}")
        dev = tri_clip.device
        with torch.cuda.device(dev):
            scratch = self.scratch.get(dev, 2 + lib.straddlers_blocks(T))
            app_clip = torch.empty((2 * cap, 3, 4), dtype=torch.float32,
                                   device=dev)
            app_vary = torch.empty((2 * cap, 3, C), dtype=torch.float32,
                                   device=dev)
            app_valid = torch.empty(2 * cap, dtype=torch.bool, device=dev)
            sel = torch.empty(cap, dtype=torch.int32, device=dev)
            overflow = torch.empty((), dtype=torch.bool, device=dev)
            handle = torch.cuda.current_stream().cuda_stream
            err = lib.straddlers_launch(
                tri_clip.data_ptr(), *tri_clip.stride(),
                tri_vary.data_ptr(), *tri_vary.stride(),
                valid.data_ptr(), valid.stride(0), T, C, cap,
                scratch.data_ptr(), app_clip.data_ptr(), app_vary.data_ptr(),
                app_valid.data_ptr(), sel.data_ptr(), overflow.data_ptr(),
                handle)
        if err != 0:
            raise RuntimeError(f"K4 launch failed: CUDA error {err}")
        self.launches += 1
        return app_clip, app_vary, app_valid, sel, overflow


K4 = StraddlersKernel()


def graph_scratch(store: dict):
    """A context inside which K4's launches take their scratch from
    ``store`` (a dict the caller keeps as long as its CUDA graph), one a
    device: made, zeroed, by the eager warm-up before the capture, and
    reused by the capture, so the graph holds no memset of it."""
    return K4.scratch.graph(store)


def check(tri_clip, tri_vary, valid, cap: int):
    """Raise unless the arguments are ones ``select_straddlers`` takes:
    clip f32[T, 3, 4], varyings f32[T, 3, C] and valid bool[T] on one
    cuda or cpu device, T >= 1 (the slots past the straddlers read row
    T - 1) and cap >= 1."""
    dev = tri_clip.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"K4 runs on cuda or cpu tensors, not {dev}")
    T = tri_clip.shape[0]
    for name, t, dtype, ok in (
            ("tri_clip", tri_clip, torch.float32,
             tuple(tri_clip.shape) == (T, 3, 4)),
            ("tri_vary", tri_vary, torch.float32,
             tri_vary.dim() == 3 and tri_vary.shape[:2] == (T, 3)),
            ("valid", valid, torch.bool, tuple(valid.shape) == (T,))):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, tri_clip on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not ok:
            raise ValueError(f"{name} has the shape {list(t.shape)} for "
                             f"{T} triangles")
    if T == 0:
        raise IndexError("select_straddlers needs at least one triangle: "
                         "the slots past the straddlers read row T - 1")
    if not 1 <= cap < 2**30 or T >= 2**31 - 2**16:
        raise ValueError(f"cap {cap} or T {T} is out of K4's range")
