"""K2, clip + setup + pack: one batch of triangles set up, packed and
boxed into rows of a raster pass's record table.

A raster pass reads one :class:`RecordTable`: the 32-lane records
(``raster_common.pack_coeffs_full``), their valid flags and their viewport
boxes (``raster.viewport_bbox``). ``Draw`` allocates it once a pass and
each batch writes its rows, its triangles' and then its appendee block's,
with :func:`setup_pack_into`: nothing is concatenated.

:func:`setup_pack_into` launches ``csrc/setup_pack.cu`` for CUDA tensors
and runs :func:`setup_pack_reference`, the same function in plain torch
(``raster_common.triangle_setup`` with its rounding forms), for CPU
tensors. There is no fallback from one to the other: a build or launch
failure raises. The kernel is built at first use like K1
(``cuda_build.build_library``) and bound with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple, Optional

import torch

from . import raster_common as rc
from .cuda_build import CSRC, build_library
from .raster import viewport_bbox

_SOURCE = os.path.join(CSRC, "setup_pack.cu")
_CULL = {"back": 0, "front": 1, "none": 2}


class RecordTable(NamedTuple):
    """One raster pass's records: ``packed`` f32[R, FULL_LANES], ``valid``
    bool[R] and ``bbox`` f32[4, R] (min u, max u, min v, max v)."""

    packed: torch.Tensor
    valid: torch.Tensor
    bbox: torch.Tensor

    @property
    def boxes(self) -> tuple:
        """The four box vectors, as ``raster.viewport_bbox`` gives them."""
        return tuple(self.bbox)

    def rows(self, lo: int, hi: int):
        """(packed, valid, boxes) of rows [lo, hi): views of the table."""
        return (self.packed[lo:hi], self.valid[lo:hi],
                tuple(self.bbox[:, lo:hi]))


def new_table(rows: int, device) -> RecordTable:
    """An unwritten table of ``rows`` rows on ``device``."""
    return RecordTable(
        torch.empty((rows, rc.FULL_LANES), dtype=torch.float32, device=device),
        torch.empty(rows, dtype=torch.bool, device=device),
        torch.empty((4, rows), dtype=torch.float32, device=device))


def plane_form_bits(cull_mode: str, planar: bool, biased: bool) -> int:
    """``rc._plane_forms`` (setup's, not the oracle's) as K2's mask: bit
    3 * plane + column holds that column's form."""
    forms = rc._plane_forms(cull_mode, planar, biased)
    return sum(f << (3 * p + col) for p, plane in enumerate(forms)
               for col, f in enumerate(plane))


class SetupPackKernel:
    """The built K2 library and its launch count. ``launches`` grows by
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
        lib, self.build_seconds, self.build_log = build_library(_SOURCE, "K2")
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.setup_pack_launch.argtypes = (
            [p, i64, i64, i64, p, i64, i64, i64, p, i64, p, i64]
            + [i32] * 7 + [ctypes.c_float, p, p, p, i64, i64, p])
        lib.setup_pack_launch.restype = ctypes.c_int
        self.lib = lib
        return lib

    def __call__(self, table: RecordTable, row0: int, tri_clip, tri_vary,
                 valid, width: int, height: int, cull_mode: str,
                 z_bias: Optional[float], planar: bool, base: int, ids):
        lib = self.build()
        T = tri_clip.shape[0]
        forms = plane_form_bits(cull_mode, planar, z_bias is not None)
        with torch.cuda.device(tri_clip.device):
            handle = torch.cuda.current_stream().cuda_stream
            err = lib.setup_pack_launch(
                tri_clip.data_ptr(), *tri_clip.stride(),
                tri_vary.data_ptr(), *tri_vary.stride(),
                valid.data_ptr(), valid.stride(0),
                None if ids is None else ids.data_ptr(),
                0 if ids is None else ids.stride(0),
                T, base, width, height, _CULL[cull_mode], forms,
                int(z_bias is not None),
                0.0 if z_bias is None else z_bias,
                table.packed.data_ptr(), table.valid.data_ptr(),
                table.bbox.data_ptr(), table.bbox.stride(0), row0, handle)
        if err != 0:
            raise RuntimeError(f"K2 launch failed: CUDA error {err}")
        self.launches += 1


K2 = SetupPackKernel()


def _check(table: RecordTable, row0: int, tri_clip, tri_vary, valid, ids,
           cull_mode: str):
    dev = tri_clip.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"K2 runs on cuda or cpu tensors, not {dev}")
    if cull_mode not in _CULL:
        raise ValueError(f"unknown cull_mode {cull_mode!r}")
    T = tri_clip.shape[0]
    named = [("tri_clip", tri_clip, torch.float32, (T, 3, 4)),
             ("tri_vary", tri_vary, torch.float32, (T, 3, 4)),
             ("valid", valid, torch.bool, (T,)),
             ("packed", table.packed, torch.float32, None),
             ("table valid", table.valid, torch.bool, None),
             ("bbox", table.bbox, torch.float32, None)]
    if ids is not None:
        named.append(("ids", ids, torch.int32, (T,)))
    for name, t, dtype, shape in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, tri_clip on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)} (4 varying "
                             f"channels), got {list(t.shape)}")
    R = table.packed.shape[0]
    if (table.packed.shape != (R, rc.FULL_LANES)
            or table.valid.shape != (R,) or table.bbox.shape != (4, R)):
        raise ValueError("the table must be packed [R, 32], valid [R] and "
                         "bbox [4, R]")
    if not (table.packed.is_contiguous() and table.valid.is_contiguous()
            and table.bbox.stride(1) == 1):
        raise ValueError("the table's rows must be contiguous")
    if not 0 <= row0 <= row0 + T <= R:
        raise ValueError(f"rows [{row0}, {row0 + T}) are not inside a table "
                         f"of {R} rows")
    if dev.type == "cuda" and table.packed.data_ptr() % 16:
        raise ValueError("packed must be 16-byte aligned")


def setup_pack_into(table: RecordTable, row0: int, tri_clip: torch.Tensor,
                    tri_vary: torch.Tensor, valid: torch.Tensor, width: int,
                    height: int, cull_mode: str = "back",
                    z_bias: Optional[float] = None, planar: bool = False,
                    base: int = 0, ids: Optional[torch.Tensor] = None):
    """Set up, pack and box a batch into rows [row0, row0 + T) of
    ``table``: ``rc.pack_coeffs_full(rc.triangle_setup(...), base, ids)``,
    the setup's valid flags and ``raster.viewport_bbox(tri_clip, width,
    height)``, bit for bit.

    tri_clip f32[T, 3, 4] and tri_vary f32[T, 3, 4] (any strides),
    valid bool[T], ids i32[T] (the id lane's submission ranks; None:
    the array rank), each on the table's device. ``cull_mode``,
    ``z_bias`` and ``planar`` select setup's culling, depth window and
    rounding forms (``rc._plane_forms``). A CUDA batch launches K2 (once,
    when T > 0), a CPU batch runs :func:`setup_pack_reference`."""
    _check(table, row0, tri_clip, tri_vary, valid, ids, cull_mode)
    if tri_clip.device.type == "cpu":
        setup_pack_reference(table, row0, tri_clip, tri_vary, valid, width,
                             height, cull_mode, z_bias, planar, base, ids)
    elif tri_clip.shape[0]:
        K2(table, row0, tri_clip, tri_vary, valid, width, height, cull_mode,
           z_bias, planar, base, ids)


def setup_pack_reference(table: RecordTable, row0: int,
                         tri_clip: torch.Tensor, tri_vary: torch.Tensor,
                         valid: torch.Tensor, width: int, height: int,
                         cull_mode: str = "back",
                         z_bias: Optional[float] = None,
                         planar: bool = False, base: int = 0,
                         ids: Optional[torch.Tensor] = None):
    """The plain PyTorch version of K2, same arguments and effect, on any
    device: setup, pack and boxes in torch, copied into the rows."""
    rows = slice(row0, row0 + tri_clip.shape[0])
    tc = rc.triangle_setup(tri_clip, tri_vary, valid, width, height,
                           cull_mode, z_bias=z_bias, planar=planar)
    table.packed[rows] = rc.pack_coeffs_full(tc, base=base, ids=ids)
    table.valid[rows] = tc.valid
    table.bbox[:, rows] = torch.stack(viewport_bbox(tri_clip, width, height))
