"""K2, clip + setup + pack: a raster pass's batches set up, packed and
boxed into rows of its record table, in one launch.

A raster pass reads one :class:`RecordTable`: the 32-lane records
(``raster_common.pack_coeffs_full``), their valid flags and their viewport
boxes (``raster.viewport_bbox``). ``Draw`` allocates it once a pass; each
batch's rows, its triangles' and then its appendee block's, are one
:class:`Segment` each, and :func:`setup_pack_pass` writes a pass's
segments: nothing is concatenated.

:func:`setup_pack_pass` launches ``csrc/setup_pack.cu`` once for CUDA
segments (once for each :data:`MAX_SEGMENTS` of them) and runs
:func:`setup_pack_pass_reference`, each segment through
:func:`setup_pack_reference`, the same function in plain torch
(``raster_common.triangle_setup`` with its rounding forms), for CPU ones.
:func:`setup_pack_into` is the pass of one segment. There is no fallback
from one to the other: a build or launch failure raises. The kernel is
built at first use like K1 (``cuda_build.build_library``) and bound with
``ctypes``.
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
# segments one launch takes (kMaxSegments in the source: they travel by
# value in the launch's 4 KB of parameters)
MAX_SEGMENTS = 24
# mode bits of a segment (the source's kFormsShift, kBiased, kStageClip,
# kStageVary; the cull mode in bits 0-1)
_FORMS_SHIFT = 2
_BIASED = 1 << 11
_STAGE_CLIP = 1 << 12
_STAGE_VARY = 1 << 13
_I32 = 2**31


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


class Segment(NamedTuple):
    """One batch (or appendee block) of a pass: :func:`setup_pack_into`'s
    arguments, in its order. Its T triangles go to rows [row0, row0 + T)
    of ``table``."""

    table: RecordTable
    row0: int
    tri_clip: torch.Tensor
    tri_vary: torch.Tensor
    valid: torch.Tensor
    width: int
    height: int
    cull_mode: str = "back"
    z_bias: Optional[float] = None
    planar: bool = False
    base: int = 0
    ids: Optional[torch.Tensor] = None


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


class _SegmentArgs(ctypes.Structure):
    """A segment as the kernel takes it (the source's ``Segment``)."""

    _fields_ = [(name, ctypes.c_void_p) for name in
                ("clip", "vary", "valid", "ids", "packed", "out_valid",
                 "box")] + [
        ("cs", ctypes.c_int * 3), ("vs", ctypes.c_int * 3),
        ("valid_stride", ctypes.c_int), ("ids_stride", ctypes.c_int),
        ("T", ctypes.c_int), ("base", ctypes.c_int), ("row0", ctypes.c_int),
        ("box_stride", ctypes.c_int), ("first_chunk", ctypes.c_int),
        ("mode", ctypes.c_int), ("W", ctypes.c_float),
        ("H", ctypes.c_float), ("bias", ctypes.c_float)]


def _staged(t: torch.Tensor) -> bool:
    """Whether K2 copies ``t``'s rows whole: contiguous [T, 3, 4] rows,
    16-byte aligned."""
    return t.stride() == (12, 4, 1) and t.data_ptr() % 16 == 0


def _segment_args(s: Segment) -> _SegmentArgs:
    T = s.tri_clip.shape[0]
    ints = [*s.tri_clip.stride(), *s.tri_vary.stride(), s.valid.stride(0),
            T, s.base, s.row0 + T, s.table.bbox.stride(0)]
    if s.ids is not None:
        ints += [s.ids.stride(0), T + s.base]
    if not all(-_I32 < v < _I32 for v in ints):
        raise ValueError("K2 indexes with 32-bit ints: a stride, row or id "
                         "is past 2^31")
    mode = (_CULL[s.cull_mode]
            | plane_form_bits(s.cull_mode, s.planar, s.z_bias is not None)
            << _FORMS_SHIFT
            | (_BIASED if s.z_bias is not None else 0)
            | (_STAGE_CLIP if _staged(s.tri_clip) else 0)
            | (_STAGE_VARY if _staged(s.tri_vary) else 0))
    return _SegmentArgs(
        s.tri_clip.data_ptr(), s.tri_vary.data_ptr(), s.valid.data_ptr(),
        None if s.ids is None else s.ids.data_ptr(),
        s.table.packed.data_ptr(), s.table.valid.data_ptr(),
        s.table.bbox.data_ptr(), (ctypes.c_int * 3)(*s.tri_clip.stride()),
        (ctypes.c_int * 3)(*s.tri_vary.stride()), s.valid.stride(0),
        0 if s.ids is None else s.ids.stride(0), T, s.base, s.row0,
        s.table.bbox.stride(0), 0, mode, s.width, s.height,
        0.0 if s.z_bias is None else s.z_bias)


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
        for name in ("setup_pack_segment_bytes", "setup_pack_max_segments"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        lib.setup_pack_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_void_p]
        lib.setup_pack_launch.restype = ctypes.c_int
        if (lib.setup_pack_segment_bytes() != ctypes.sizeof(_SegmentArgs)
                or lib.setup_pack_max_segments() != MAX_SEGMENTS):
            raise RuntimeError("K2's source and its wrapper disagree on a "
                               "segment's layout or a launch's segments")
        self.lib = lib
        return lib

    def __call__(self, segments: list):
        """One launch over ``segments`` (1 to MAX_SEGMENTS CUDA segments on
        one device, at least one with triangles, checked by the caller): a
        block for each 64 triangles."""
        lib = self.build()
        if not 0 < len(segments) <= MAX_SEGMENTS:
            raise ValueError(f"a K2 launch takes 1 to {MAX_SEGMENTS} "
                             f"segments, not {len(segments)}")
        args = (_SegmentArgs * len(segments))(
            *(_segment_args(s) for s in segments))
        with torch.cuda.device(segments[0].tri_clip.device):
            handle = torch.cuda.current_stream().cuda_stream
            err = lib.setup_pack_launch(args, len(segments), handle)
        if err != 0:
            raise RuntimeError(f"K2 launch failed: CUDA error {err}")
        self.launches += 1


K2 = SetupPackKernel()


def _check(s: Segment):
    table, row0, tri_clip, tri_vary, valid = s[:5]
    dev = tri_clip.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"K2 runs on cuda or cpu tensors, not {dev}")
    if s.cull_mode not in _CULL:
        raise ValueError(f"unknown cull_mode {s.cull_mode!r}")
    T = tri_clip.shape[0]
    named = [("tri_clip", tri_clip, torch.float32, (T, 3, 4)),
             ("tri_vary", tri_vary, torch.float32, (T, 3, 4)),
             ("valid", valid, torch.bool, (T,)),
             ("packed", table.packed, torch.float32, None),
             ("table valid", table.valid, torch.bool, None),
             ("bbox", table.bbox, torch.float32, None)]
    if s.ids is not None:
        named.append(("ids", s.ids, torch.int32, (T,)))
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


def launch_groups(segments: list) -> list:
    """The launches of a pass: its segments with triangles, in order, at
    most :data:`MAX_SEGMENTS` a launch."""
    live = [s for s in segments if s.tri_clip.shape[0]]
    return [live[i:i + MAX_SEGMENTS]
            for i in range(0, len(live), MAX_SEGMENTS)]


def setup_pack_pass(segments):
    """Set up, pack and box every :class:`Segment` of a raster pass, each
    as :func:`setup_pack_into` does. The segments lie on one device and
    may write to different tables. CUDA segments take one K2 launch (one
    for each MAX_SEGMENTS segments with triangles; none when no segment
    has any); CPU segments run :func:`setup_pack_pass_reference`."""
    segments = [Segment(*s) for s in segments]
    for s in segments:
        _check(s)
    devices = {s.tri_clip.device for s in segments}
    if len(devices) > 1:
        raise ValueError(f"a pass's segments lie on one device, not on "
                         f"{sorted(map(str, devices))}")
    if not segments:
        return
    if segments[0].tri_clip.device.type == "cpu":
        setup_pack_pass_reference(segments)
        return
    for group in launch_groups(segments):
        K2(group)


def setup_pack_pass_reference(segments):
    """The plain PyTorch version of a K2 pass, on any device: each segment
    through :func:`setup_pack_reference`, in order."""
    for s in segments:
        setup_pack_reference(*s)


def setup_pack_into(table: RecordTable, row0: int, tri_clip: torch.Tensor,
                    tri_vary: torch.Tensor, valid: torch.Tensor, width: int,
                    height: int, cull_mode: str = "back",
                    z_bias: Optional[float] = None, planar: bool = False,
                    base: int = 0, ids: Optional[torch.Tensor] = None):
    """Set up, pack and box a batch into rows [row0, row0 + T) of
    ``table``: ``rc.pack_coeffs_full(rc.triangle_setup(...), base, ids)``,
    the setup's valid flags and ``raster.viewport_bbox(tri_clip, width,
    height)``, bit for bit: the pass of this one segment.

    tri_clip f32[T, 3, 4] and tri_vary f32[T, 3, 4] (any strides),
    valid bool[T], ids i32[T] (the id lane's submission ranks; None:
    the array rank), each on the table's device. ``cull_mode``,
    ``z_bias`` and ``planar`` select setup's culling, depth window and
    rounding forms (``rc._plane_forms``). A CUDA batch launches K2 (once,
    when T > 0), a CPU batch runs :func:`setup_pack_reference`."""
    setup_pack_pass([Segment(table, row0, tri_clip, tri_vary, valid, width,
                             height, cull_mode, z_bias, planar, base, ids)])


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
