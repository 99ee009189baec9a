"""K5, binning: a raster pass's records into the CSR bin order of its
16x16 tiles, over a static capacity of pair slots, with no sort.

:func:`bin_tiles` gives ``(index i32[C], starts i32[NT], counts i32[NT],
overflow bool[])``: tile t's records are ``index[starts[t]:starts[t] +
counts[t]]`` in ascending row order, the segments follow each other in
tile order, the slots past the live pairs hold R - 1, and ``overflow`` is
set when the pairs outgrow the C slots (the pairs past the C-th, in
record order, are left out). A record's pairs are the tiles of its box's
rect; a rect empty on an axis (a box whose min passes its max, which a
viewport box never does) has none. It launches ``csrc/bin_tiles.cu`` for CUDA
tensors and runs :func:`bin_tiles_reference`, the same function in plain
torch (an expansion of every slot and a stable sort by tile), for CPU
tensors; the results are the plain version's, bit for bit. There is no
fallback from one to the other. The kernel is built at first use like K1
(``cuda_build.build_library``) and bound with ``ctypes``. It reads nothing
back to the host, so a frame that bins stays one CUDA graph replay.

**Launches.** A call on the card is one cooperative launch of one kernel:
a persistent grid (:meth:`BinTilesKernel.blocks`, every block resident
at once)
walks the records, the pairs and the tiles in seven phases with grid-wide
barriers between them; ``K5.launches`` counts launches. A pass of no
records launches nothing: its results are zeros, as the plain version's
are.

**Scratch.** The launch counts pairs into a word a tile, sums each
block's records and tiles and waits at its barriers through counters in
device memory. They must be zero when it starts, and it leaves them
zeroed, so a scratch is zeroed once, when it is made, and never by a
launch or a graph node. Two launches that run at once must not share
one: a scratch belongs to one (device, stream) for eager calls, and to
one CUDA graph for the calls captured into it (:func:`graph_scratch`,
which ``renderer/compiled.py`` opens around a frame's warm-up and
capture). A graph captured outside it gets a scratch of its own a call,
zeroed by a memset node of the graph. The list of live records
(``int32[R, 4]``) is a workspace the launch writes before it reads it,
made with the outputs.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from .cuda_build import CSRC, ZeroedScratch, build_library
from .raster_cuda import TILE_H, TILE_W

_SOURCE = os.path.join(CSRC, "bin_tiles.cu")
# tiles a band may have
MAX_TILES = 2**20


def tile_grid(height: int, width: int):
    """(tile rows, tile columns) of an H x W band."""
    return -(-height // TILE_H), -(-width // TILE_W)


def _spans(valid, bbox, height: int, width: int, y0: int):
    """Per-record tile rects of one band: (span i64[R], sx, tx0, ty0,
    ntx, NT); span is the record's tile count, 0 when culled."""
    nty, ntx = tile_grid(height, width)
    # the reference bins on the tile-padded band height
    ph = nty * TILE_H
    # band-local cull: a record whose box misses rows [y0, y0 + ph) (or
    # the frame's columns) covers no pixel of this band
    valid = (valid & (bbox[3] >= y0) & (bbox[2] < y0 + ph)
             & (bbox[1] >= 0.0) & (bbox[0] < width))
    minx = torch.clamp(torch.floor(bbox[0]), 0, width - 1)
    maxx = torch.clamp(torch.ceil(bbox[1]), 0, width - 1)
    miny = torch.clamp(torch.floor(bbox[2]) - y0, 0, ph - 1)
    maxy = torch.clamp(torch.ceil(bbox[3]) - y0, 0, ph - 1)
    zero = torch.zeros((), dtype=torch.int32, device=valid.device)
    tx0 = torch.where(valid, (minx / TILE_W).to(torch.int32), zero)
    tx1 = torch.where(valid, (maxx / TILE_W).to(torch.int32), zero)
    ty0 = torch.where(valid, (miny / TILE_H).to(torch.int32), zero)
    ty1 = torch.where(valid, (maxy / TILE_H).to(torch.int32), zero)
    sx = (tx1 - tx0 + 1).long()
    sy = (ty1 - ty0 + 1).long()
    # a rect empty on an axis (a box whose min passes its max) covers no
    # tile; sx stays positive, since the slots divide by it
    span = torch.where(valid & (sx > 0) & (sy > 0), sx * sy,
                       torch.zeros_like(sx))
    return span, torch.clamp(sx, min=1), tx0, ty0, ntx, nty * ntx


def _slot_tiles(spans, capacity: int):
    """(record i64[C], tile i64[C], total pairs) of the C slots: slot p
    holds the pair of the record whose span covers it; slots past the
    live total hold the last record and the tile id NT, past every
    tile."""
    span, sx, tx0, ty0, ntx, NT = spans
    ends = torch.cumsum(span, 0)
    total = ends[-1]
    slot = torch.arange(capacity, device=span.device)
    tri = torch.clamp(torch.searchsorted(ends, slot, right=True),
                      max=span.shape[0] - 1)
    k = slot - (ends - span)[tri]
    ey = k // sx[tri]
    ex = k - ey * sx[tri]
    tile = torch.where(slot < total,
                       (ty0[tri].long() + ey) * ntx + tx0[tri].long() + ex,
                       NT)
    return tri, tile, total


def _expand(spans, capacity: int):
    """:func:`bin_tiles`' results from :func:`_spans` over ``capacity``
    pair slots: the slots' tiles sorted stably."""
    span, NT = spans[0], spans[-1]
    dev = span.device
    if span.shape[0] == 0:
        zeros = torch.zeros(NT, dtype=torch.int32, device=dev)
        return (torch.zeros(capacity, dtype=torch.int32, device=dev), zeros,
                zeros.clone(), torch.zeros((), dtype=torch.bool, device=dev))
    tri, tile, total = _slot_tiles(spans, capacity)
    tile_sorted, order = torch.sort(tile, stable=True)
    # each tile's segment of the sorted pairs (bincount would read the
    # largest tile id back to the host); dead slots sort past tile NT - 1,
    # so every segment lies in [0, C]
    bounds = torch.searchsorted(tile_sorted,
                                torch.arange(NT + 1, device=dev))
    starts = bounds[:-1]
    counts = bounds[1:] - starts
    index = tri[order].to(torch.int32)
    return (index, starts.to(torch.int32), counts.to(torch.int32),
            total > capacity)


def bin_tiles_reference(valid, bbox, height: int, width: int, y0: int,
                        capacity: int):
    """The plain PyTorch version of K5: same arguments and results as
    :func:`bin_tiles`, on any device."""
    return _expand(_spans(valid, bbox, height, width, y0), capacity)


# the seven phases of a launch, as K5.phase_times names their times
PHASES = ("records", "compaction", "count", "tile sums", "tile scan",
          "place", "order")


class BinTilesKernel:
    """The built K5 library, its launch count and its scratch.
    ``launches`` grows by one at each launch of the kernel and nowhere
    else."""

    def __init__(self):
        self.launches = 0
        self.lib: Optional[ctypes.CDLL] = None
        self.build_seconds: Optional[float] = None
        self.build_log = ""
        self.scratch = ZeroedScratch()
        self._occupancy = {}

    def occupancy(self, device):
        """(blocks an SM of ``device`` holds at once, its SMs)."""
        index = torch.device(device).index or 0
        if index not in self._occupancy:
            lib = self.build()
            out = [ctypes.c_int(0) for _ in range(2)]
            with torch.cuda.device(index):
                err = lib.bin_tiles_occupancy(*(ctypes.byref(v) for v in out))
            if err != 0 or out[0].value < 1:
                raise RuntimeError(f"K5's occupancy query failed: CUDA "
                                   f"error {err}, {out[0].value} blocks an "
                                   "SM")
            self._occupancy[index] = tuple(v.value for v in out)
        return self._occupancy[index]

    def resident_blocks(self, device) -> int:
        """The kernel's blocks that ``device`` holds at once: the largest
        grid its cooperative launch accepts."""
        per_sm, sms = self.occupancy(device)
        return per_sm * sms

    def blocks(self, device, records: int) -> int:
        """The grid a launch over ``records`` records on ``device`` takes
        (``bin_tiles_grid``: a block for each 512 records, one to four an
        SM, never more than the SMs hold at once)."""
        return self.build().bin_tiles_grid(records, *self.occupancy(device))

    def build(self) -> ctypes.CDLL:
        """Compile (once per source and flag set) and load the kernel."""
        if self.lib is not None:
            return self.lib
        lib, self.build_seconds, self.build_log = build_library(_SOURCE, "K5")
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.bin_tiles_scratch_words.argtypes = [i32, i32]
        lib.bin_tiles_scratch_words.restype = i64
        lib.bin_tiles_launch.argtypes = ([p] * 4 + [i64] * 4 + [p, i64]
                                         + [i32] * 6 + [i64, i32] + [p] * 8)
        lib.bin_tiles_launch.restype = ctypes.c_int
        lib.bin_tiles_occupancy.argtypes = [p] * 2
        lib.bin_tiles_occupancy.restype = ctypes.c_int
        lib.bin_tiles_grid.argtypes = [i64, i32, i32]
        lib.bin_tiles_grid.restype = ctypes.c_int
        lib.bin_tiles_setup.argtypes = []
        lib.bin_tiles_setup.restype = ctypes.c_int
        err = lib.bin_tiles_setup()
        if err != 0:
            raise RuntimeError(f"K5 set-up failed: CUDA error {err}")
        self.lib = lib
        return lib

    def __call__(self, valid, bbox, height: int, width: int, y0: int,
                 capacity: int, blocks: Optional[int] = None):
        """:func:`bin_tiles`' results for CUDA tensors (checked by the
        caller). ``blocks`` overrides the grid (a cooperative launch: the
        runtime refuses more blocks than the card holds at once)."""
        return self._launch(valid, bbox, height, width, y0, capacity, blocks,
                            None)

    def _launch(self, valid, bbox, height, width, y0, capacity, blocks,
                times):
        """One launch; ``times``, a CUDA int64 tensor of 7 + blocks or
        None, takes its globaltimer stamps (:meth:`phase_times`)."""
        R = valid.shape[0]
        nty, ntx = tile_grid(height, width)
        NT = nty * ntx
        dev = valid.device
        with torch.cuda.device(dev):
            if R == 0:
                zeros = torch.zeros(NT, dtype=torch.int32, device=dev)
                return (torch.zeros(capacity, dtype=torch.int32, device=dev),
                        zeros, zeros.clone(),
                        torch.zeros((), dtype=torch.bool, device=dev))
            lib = self.build()
            if blocks is None:
                blocks = self.blocks(dev, R)
            scratch = self.scratch.get(
                dev, lib.bin_tiles_scratch_words(blocks, NT))
            live = torch.empty((R, 4), dtype=torch.int32, device=dev)
            index = torch.empty(capacity, dtype=torch.int32, device=dev)
            starts = torch.empty(NT, dtype=torch.int32, device=dev)
            counts = torch.empty(NT, dtype=torch.int32, device=dev)
            overflow = torch.empty((), dtype=torch.bool, device=dev)
            handle = torch.cuda.current_stream().cuda_stream
            err = lib.bin_tiles_launch(
                *(b.data_ptr() for b in bbox), *(b.stride(0) for b in bbox),
                valid.data_ptr(), valid.stride(0), R, width, y0,
                nty * TILE_H, ntx, NT, capacity, blocks, scratch.data_ptr(),
                live.data_ptr(), index.data_ptr(), starts.data_ptr(),
                counts.data_ptr(), overflow.data_ptr(),
                None if times is None else times.data_ptr(), handle)
        if err != 0:
            raise RuntimeError(f"K5 launch of {blocks} blocks failed: CUDA "
                               f"error {err}")
        self.launches += 1
        return index, starts, counts, overflow

    def phase_times(self, valid, bbox, height: int, width: int, y0: int,
                    capacity: int, launches: int = 5):
        """The phases (:data:`PHASES`) of ``launches`` launches: {name: ms},
        the median over the launches of each, from the globaltimer stamps
        block 0 takes at the start and after each barrier, the last phase up
        to the latest block's end. The launches count."""
        blocks = self.blocks(valid.device, valid.shape[0])
        runs = []
        for _ in range(launches):
            times = torch.zeros(7 + blocks, dtype=torch.int64,
                                device=valid.device)
            self._launch(valid, bbox, height, width, y0, capacity, blocks,
                         times)
            stamps = times.tolist()
            runs.append(stamps[:7] + [max(stamps[7:])])
        return {name: sorted((r[k + 1] - r[k]) / 1e6 for r in runs)[
            launches // 2] for k, name in enumerate(PHASES)}


K5 = BinTilesKernel()


def graph_scratch(store: dict):
    """A context inside which K5's launches take their scratch from
    ``store`` (a dict the caller keeps as long as its CUDA graph), one a
    device: made, zeroed, by the eager warm-up before the capture, and
    reused by the capture, so the graph holds no memset of it."""
    return K5.scratch.graph(store)


def check(valid, bbox, height: int, width: int, y0: int, capacity: int):
    """Raise unless the arguments are ones :func:`bin_tiles` takes: valid
    bool[R] and four f32[R] box vectors (min u, max u, min v, max v) on
    one cuda or cpu device, a band of at least one row and column from
    row y0 >= 0 and of at most MAX_TILES tiles, and 0 <= capacity <
    2^31."""
    dev = valid.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"K5 runs on cuda or cpu tensors, not {dev}")
    if valid.dtype != torch.bool or valid.dim() != 1:
        raise TypeError(f"valid must be bool[R], got {valid.dtype}"
                        f"{list(valid.shape)}")
    R = valid.shape[0]
    if len(bbox) != 4:
        raise ValueError(f"bbox holds {len(bbox)} vectors, not 4")
    for k, b in enumerate(bbox):
        if b.device != dev:
            raise ValueError(f"bbox[{k}] is on {b.device}, valid on {dev}")
        if b.dtype != torch.float32:
            raise TypeError(f"bbox[{k}] must be float32, got {b.dtype}")
        if tuple(b.shape) != (R,):
            raise ValueError(f"bbox[{k}] has the shape {list(b.shape)} for "
                             f"{R} records")
    if height < 1 or width < 1 or y0 < 0 or height + y0 >= 2**24 \
            or width >= 2**24 or tile_grid(height, width)[0] * tile_grid(
                height, width)[1] > MAX_TILES:
        raise ValueError(f"a {height} x {width} band from row {y0} is out "
                         "of K5's range")
    if not 0 <= capacity < 2**31 or R >= 2**31 - 2**12:
        raise ValueError(f"capacity {capacity} or {R} records are out of "
                         "K5's range")


def bin_tiles(valid, bbox, height: int, width: int, y0: int,
              capacity: int):
    """CSR binning of R records to the tiles of the band of ``height``
    rows from row ``y0`` (``bbox`` in the frame's coordinates) over
    ``capacity`` pair slots: K5 for CUDA tensors, its plain version for
    CPU ones (see the module docstring for the results)."""
    bbox = tuple(bbox)
    check(valid, bbox, height, width, y0, capacity)
    if valid.device.type == "cuda":
        return K5(valid, bbox, height, width, y0, capacity)
    return bin_tiles_reference(valid, bbox, height, width, y0, capacity)
