"""Tiled rasterization around K1: viewport bounding boxes, exact CSR
binning, the raster pass and shading (torch).

Port of the host side of ``myrenderer_tpu/ops/raster_pallas.py``. Per
raster pass:

1. **Binning** (plain torch): each valid triangle's pixel bounding box
   becomes a rect of TILE_H x TILE_W tiles; every live (tile, record)
   pair is enumerated with ``repeat_interleave``, sorted by tile
   (stable, so records stay in ascending order within a tile) and
   counted with ``bincount`` into CSR ``starts/counts``. The bin order
   is an index of record rows (4 bytes a pair); the records themselves
   are not copied. The sizes are exact (one host sync for the pair
   count), so there is no stream capacity, no span budget and no shared
   "big" list. The resolve is order-free, so routing cannot change a
   pixel.
2. **K1** (``raster_cuda.rasterize_tiles``): one CTA per tile, reading
   the records through the index.
3. **Shading** (plain torch): one divide and the fragment programs over
   the dense planes.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import raster_common as rc
from .raster_cuda import TILE_H, TILE_W, rasterize_tiles


def viewport_bbox(tri_clip: torch.Tensor, width: int, vp_height: int):
    """Per-triangle pixel bounding box (min_u, max_u, min_v, max_v), four
    f32[T] vectors in full-viewport coordinates (unfloored and
    unclipped)."""
    w = torch.clamp(tri_clip[..., 3], min=rc.W_EPS)          # [T, 3]
    u = (0.5 * tri_clip[..., 0] / w + 0.5) * float(width)
    v = (0.5 - 0.5 * tri_clip[..., 1] / w) * float(vp_height)
    return (u.amin(1), u.amax(1), v.amin(1), v.amax(1))


def bin_packed(packed: torch.Tensor, valid: torch.Tensor, bbox,
               height: int, width: int):
    """Exact CSR binning of records to the tiles of an H x W frame.

    Returns (index i32[S], starts i32[NT], counts i32[NT]) with
    NT = ceil(H / TILE_H) * ceil(W / TILE_W), tiles row-major: tile t's
    records are ``packed[index[starts[t]:starts[t] + counts[t]]]``, in
    ascending row order. A triangle goes to every tile its clipped
    bounding box touches, as in the reference; triangles whose box
    misses the frame are dropped."""
    dev = packed.device
    nty = -(-height // TILE_H)
    ntx = -(-width // TILE_W)
    NT = nty * ntx
    # the reference bins on the tile-padded frame height
    ph = nty * TILE_H
    valid = (valid & (bbox[3] >= 0.0) & (bbox[2] < ph)
             & (bbox[1] >= 0.0) & (bbox[0] < width))
    minx = torch.clamp(torch.floor(bbox[0]), 0, width - 1)
    maxx = torch.clamp(torch.ceil(bbox[1]), 0, width - 1)
    miny = torch.clamp(torch.floor(bbox[2]), 0, ph - 1)
    maxy = torch.clamp(torch.ceil(bbox[3]), 0, ph - 1)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    tx0 = torch.where(valid, (minx / TILE_W).to(torch.int32), zero)
    tx1 = torch.where(valid, (maxx / TILE_W).to(torch.int32), zero)
    ty0 = torch.where(valid, (miny / TILE_H).to(torch.int32), zero)
    ty1 = torch.where(valid, (maxy / TILE_H).to(torch.int32), zero)
    sx = (tx1 - tx0 + 1).long()
    span = torch.where(valid, sx * (ty1 - ty0 + 1).long(),
                       torch.zeros_like(sx))

    total = int(span.sum())                       # the one host sync
    tri = torch.repeat_interleave(torch.arange(span.shape[0], device=dev),
                                  span, output_size=total)
    first = torch.cumsum(span, 0) - span
    k = torch.arange(total, device=dev) - first[tri]
    ey = k // sx[tri]
    ex = k - ey * sx[tri]
    tile = (ty0[tri].long() + ey) * ntx + tx0[tri].long() + ex
    tile_sorted, order = torch.sort(tile, stable=True)
    counts = torch.bincount(tile_sorted, minlength=NT)
    starts = torch.cumsum(counts, 0) - counts
    index = tri[order].to(torch.int32)
    return index, starts.to(torch.int32), counts.to(torch.int32)


def rasterize_packed(packed: torch.Tensor, valid: torch.Tensor, bbox,
                     height: int, width: int,
                     depth: Optional[torch.Tensor] = None):
    """One raster pass over packed records (``rc.pack_coeffs_full``, id
    lane already holding global ranks).

    Returns (depth f32[H, W], winner i32[H, W], vary_num f32[4, H, W],
    vary_den f32[H, W]): the reference's contract without its overflow
    flags, which exact sizing makes moot. The perspective-correct
    varyings at pixel p are ``vary_num[:, p] / vary_den[p]`` (den is 1
    where nothing covers)."""
    if depth is None:
        depth = torch.ones((height, width), dtype=torch.float32,
                           device=packed.device)
    index, starts, counts = bin_packed(packed, valid, bbox, height, width)
    fused, winner = rasterize_tiles(packed.contiguous(), index, starts,
                                    counts, depth.contiguous(),
                                    check_segments=False)
    return fused[0], winner, fused[2:6], fused[1]


def shade_from_planes_ranges(winner, num, den, fb, ranges):
    """Dense shading with per-id-range fragment programs: each range
    (start, end, fragment_fn, ctx) writes the pixels whose winning id
    lies in [start, end) (no blending, ``Pipeline.zig:137-140``).
    Uncovered pixels (winner -1) match no range."""
    varp = torch.movedim(num, 0, -1) / den[..., None]
    for start, end, fn, ctx in ranges:
        rgba = fn(varp) if ctx is None else fn(varp, ctx)
        mask = (winner >= start) & (winner < end)
        fb = torch.where(mask[..., None], rgba, fb)
    return fb
