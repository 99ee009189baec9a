"""K1, the tile rasterizer: its CUDA kernel's loader and wrapper, and
its plain PyTorch version.

``rasterize_tiles`` takes the packed records, the bin order (``index``:
record rows, tile after tile) with per-tile CSR offsets, and the incoming
depth, and returns ``(fused f32[6, H, W], winner i32[H, W])``: depth,
the varying denominator plane and four varying numerator planes of the
front-most record at each pixel, and its id (-1 where nothing covers).
The tiles may cover a band of a taller frame (``y0``, the band's first
row): the tests run at the frame's pixel centres, so a band equals the
same rows of the frame rendered whole.
For CUDA tensors it launches ``csrc/raster_tile.cu``; for CPU tensors
it runs :func:`rasterize_tiles_reference`, the same function in plain
torch. There is no fallback from one to the other.

The kernel is built at first use with ``nvcc`` for ``sm_90a`` into
``build/`` at the repository root (``cuda_build.build_library``, shared
with K2), and bound with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from . import raster_common as rc
from .cuda_build import CSRC, build_library

_SOURCE = os.path.join(CSRC, "raster_tile.cu")

TILE_H = 16
TILE_W = 16

# (tile, record) pairs the plain version expands at once: 2048 pairs of
# 256 pixels bound its temporaries to some tens of MiB
_REFERENCE_BLOCK = 2048


class RasterTileKernel:
    """The built K1 library and its launch count. ``launches`` grows by
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
        lib, self.build_seconds, self.build_log = build_library(_SOURCE, "K1")
        p = ctypes.c_void_p
        i32 = ctypes.c_int
        lib.raster_tile_launch.argtypes = [p, p, p, p, p, p, p,
                                           i32, i32, i32, i32, p]
        lib.raster_tile_launch.restype = ctypes.c_int
        lib.raster_tile_tile_h.restype = ctypes.c_int
        lib.raster_tile_tile_w.restype = ctypes.c_int
        if (lib.raster_tile_tile_h(), lib.raster_tile_tile_w()) != \
                (TILE_H, TILE_W):
            raise RuntimeError("K1 was built for another tile size")
        self.lib = lib
        return lib

    def __call__(self, packed, index, starts, counts, depth, y0: int = 0):
        lib = self.build()
        H, W = depth.shape
        # the largest frame row the band evaluates: its reject's bound
        ymax = y0 + -(-H // TILE_H) * TILE_H
        fused = torch.empty((6, H, W), dtype=torch.float32,
                            device=depth.device)
        winner = torch.empty((H, W), dtype=torch.int32,
                             device=depth.device)
        with torch.cuda.device(depth.device):
            handle = torch.cuda.current_stream().cuda_stream
            err = lib.raster_tile_launch(
                packed.data_ptr(), index.data_ptr(), starts.data_ptr(),
                counts.data_ptr(), depth.data_ptr(), fused.data_ptr(),
                winner.data_ptr(), H, W, y0, ymax, handle)
        if err != 0:
            raise RuntimeError(f"K1 launch failed: CUDA error {err}")
        self.launches += 1
        return fused, winner


K1 = RasterTileKernel()


def _check_layout(packed, index, starts, counts, depth, y0, vp_height):
    dev = depth.device
    for name, t, dtype in (("packed", packed, torch.float32),
                           ("index", index, torch.int32),
                           ("starts", starts, torch.int32),
                           ("counts", counts, torch.int32),
                           ("depth", depth, torch.float32)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, depth on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    H, W = depth.shape
    if not 0 <= y0 <= y0 + H <= vp_height:
        raise ValueError(f"rows [{y0}, {y0 + H}) are not inside a frame of "
                         f"{vp_height} rows")
    nt = -(-H // TILE_H) * -(-W // TILE_W)
    if packed.dim() != 2 or packed.shape[1] != rc.FULL_LANES:
        raise ValueError(f"packed must be [R, {rc.FULL_LANES}], got "
                         f"{tuple(packed.shape)}")
    if index.dim() != 1:
        raise ValueError(f"index must be [S], got {tuple(index.shape)}")
    if starts.shape != (nt,) or counts.shape != (nt,):
        raise ValueError(f"starts/counts must be [{nt}] for a {H}x{W} "
                         f"frame of {TILE_H}x{TILE_W} tiles")
    if dev.type == "cuda" and packed.data_ptr() % 16:
        raise ValueError("packed must be 16-byte aligned")


def _check_segments(packed, index, starts, counts):
    # the kernel reads index[starts, starts + counts) and the packed rows
    # they name unchecked
    if not starts.shape[0]:
        return
    ok = ((starts >= 0).all() & (counts >= 0).all()
          & ((starts.long() + counts).max() <= index.shape[0]))
    if index.shape[0]:
        ok &= (index.min() >= 0) & (index.max() < packed.shape[0])
    if not bool(ok):
        raise ValueError("a tile's segment lies outside the index, or an "
                         "index lies outside the packed records")


def rasterize_tiles(packed: torch.Tensor, index: torch.Tensor,
                    starts: torch.Tensor, counts: torch.Tensor,
                    depth: torch.Tensor, *, y0: int = 0,
                    vp_height: Optional[int] = None,
                    check_segments: bool = True):
    """K1 over a frame, or a band of one, in TILE_H x TILE_W tiles,
    tiles row-major.

    packed f32[R, 32] records; index i32[S] record rows in bin order;
    starts/counts i32[NT] each tile's segment of ``index``; depth
    f32[H, W] the incoming depth of rows [y0, y0 + H) of a frame of
    ``vp_height`` rows (default y0 + H). Returns (fused f32[6, H, W],
    winner i32[H, W]). Uncovered pixels keep depth_in, winner -1, den 1
    and nums 0. Device, dtype, shape and contiguity are always checked; that
    every segment lies inside ``index`` and every index inside
    ``packed`` costs a host sync and is skipped with
    ``check_segments=False`` for the bin order that ``raster.bin_packed``
    made, which holds both by construction."""
    if depth.device.type not in ("cuda", "cpu"):
        raise ValueError(f"K1 runs on cuda or cpu tensors, not "
                         f"{depth.device}")
    y0 = int(y0)
    vp_height = y0 + depth.shape[0] if vp_height is None else int(vp_height)
    _check_layout(packed, index, starts, counts, depth, y0, vp_height)
    if check_segments:
        _check_segments(packed, index, starts, counts)
    if depth.device.type == "cuda":
        return K1(packed, index, starts, counts, depth, y0=y0)
    return rasterize_tiles_reference(packed, index, starts, counts, depth,
                                     y0=y0, vp_height=vp_height)


def rasterize_tiles_reference(packed: torch.Tensor, index: torch.Tensor,
                              starts: torch.Tensor, counts: torch.Tensor,
                              depth: torch.Tensor, *, y0: int = 0,
                              vp_height: Optional[int] = None):
    """The plain PyTorch version of K1, same arguments and results
    (``vp_height`` only bounds the band; the pixel rows are y0 + y).

    Expands every (tile, record) pair of the CSR segments over the
    tile's pixels, ``_REFERENCE_BLOCK`` pairs at a time, and keeps the
    lexicographic min of (z, id) per pixel, starting from
    (depth_in, -1), with the packed row that holds it. The winner's
    planes are evaluated once at the end."""
    dev = depth.device
    H, W = depth.shape
    ntx = -(-W // TILE_W)
    P = TILE_H * TILE_W
    counts_l = counts.long()
    total = int(counts_l.sum())
    tile_of = torch.repeat_interleave(
        torch.arange(counts.shape[0], device=dev), counts_l,
        output_size=total)
    first = torch.cumsum(counts_l, 0) - counts_l
    rows = index.long()[starts.long()[tile_of]
                        + (torch.arange(total, device=dev) - first[tile_of])]
    lx = torch.arange(P, device=dev) % TILE_W
    ly = torch.arange(P, device=dev) // TILE_W

    best_z = depth.reshape(-1).clone()
    best_id = torch.full((H * W,), -1, dtype=torch.int32, device=dev)
    best_row = torch.full((H * W,), -1, dtype=torch.long, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    big = torch.iinfo(torch.int32).max
    for b0 in range(0, total, _REFERENCE_BLOCK):
        r = rows[b0:b0 + _REFERENCE_BLOCK]
        t = tile_of[b0:b0 + _REFERENCE_BLOCK]
        x = (t % ntx * TILE_W)[:, None] + lx[None, :]          # [n, P]
        y = (t // ntx * TILE_H)[:, None] + ly[None, :]
        inside = (x < W) & (y < H)
        px = (x.to(torch.float32) + 0.5)
        py = ((y + y0).to(torch.float32) + 0.5)
        rec = packed[r][:, None, :]                            # [n, 1, 32]
        cov, z = rc.coverage_depth(rec, px, py)
        cov = cov & inside
        pix = (y * W + x)[cov]
        zc = z[cov]
        idc = rec[..., 16].expand(cov.shape)[cov].to(torch.int32)
        rc_rows = r[:, None].expand(cov.shape)[cov]
        # per pixel in this block: min z, then min id at that z
        zmin = torch.full((H * W,), float("inf"), device=dev)
        zmin = zmin.scatter_reduce(0, pix, zc, "amin")
        at_min = zc == zmin[pix]
        idmin = torch.full((H * W,), big, dtype=torch.int32, device=dev)
        idmin = idmin.scatter_reduce(0, pix[at_min], idc[at_min], "amin")
        is_win = at_min & (idc == idmin[pix])
        rowmin = torch.full((H * W,), -1, dtype=torch.long, device=dev)
        rowmin = rowmin.scatter_reduce(0, pix[is_win], rc_rows[is_win],
                                       "amax")
        better = (zmin < inf) & ((zmin < best_z) | ((zmin == best_z)
                                                    & (idmin < best_id)))
        best_z = torch.where(better, zmin, best_z)
        best_id = torch.where(better, idmin, best_id)
        best_row = torch.where(better, rowmin, best_row)

    yy = torch.arange(H, device=dev)[:, None].expand(H, W).reshape(-1)
    xx = torch.arange(W, device=dev)[None, :].expand(H, W).reshape(-1)
    px = xx.to(torch.float32) + 0.5
    py = (yy + y0).to(torch.float32) + 0.5
    covered = best_row >= 0
    wrec = packed[best_row.clamp(min=0)] if packed.shape[0] else \
        torch.zeros((H * W, rc.FULL_LANES), device=dev)

    def plane(k):
        return rc.edge_eval(wrec[:, k], wrec[:, k + 1], wrec[:, k + 2], px,
                            py)

    den = torch.where(covered, plane(17), torch.ones_like(px))
    nums = [torch.where(covered, plane(20 + 3 * ch), torch.zeros_like(px))
            for ch in range(4)]
    fused = torch.stack([best_z, den] + nums).reshape(6, H, W)
    return fused, best_id.reshape(H, W)
