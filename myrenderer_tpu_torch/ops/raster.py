"""Tiled rasterization around K1: viewport bounding boxes, CSR binning
at a static pair capacity, the raster pass and shading (torch).

Port of the host side of ``myrenderer_tpu/ops/raster_pallas.py``. Per
raster pass:

1. **Binning** (K5, ``binning.bin_tiles``): each valid triangle's pixel
   bounding box becomes a rect of TILE_H x TILE_W tiles, and its (tile,
   record) pairs go into a static capacity of C slots (the reference's
   stream capacity, :func:`pair_capacity`) as CSR ``index`` / ``starts``
   / ``counts``, records in ascending order within a tile. On the card
   that is one launch of a hand-written kernel with no sort; on the CPU its
   plain version (every slot expanded, a stable sort by tile). Shapes
   depend only on the record count, nothing is read back to the host,
   and a pass of N row bands has N binnings and no sync. When the pairs
   outgrow C, the pass's overflow flag is set on the device, the last
   records' pairs are left out (every segment stays inside the index)
   and ``Draw`` raises its capacity and renders again. The bin order is
   an index of record rows (4 bytes a pair); the records are not copied.
   The resolve is order-free, so routing cannot change a pixel.
2. **K1** (``raster_cuda.rasterize_tiles``): one CTA per tile, reading
   the records through the index.
3. **Shading** (plain torch): one divide and the fragment programs over
   the dense planes.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import binning
from . import raster_common as rc
from .raster_cuda import rasterize_tiles


def viewport_bbox(tri_clip: torch.Tensor, width: int, vp_height: int):
    """Per-triangle pixel bounding box (min_u, max_u, min_v, max_v), four
    f32[T] vectors in full-viewport coordinates (unfloored and
    unclipped)."""
    w = torch.clamp(tri_clip[..., 3], min=rc.W_EPS)          # [T, 3]
    u = (0.5 * tri_clip[..., 0] / w + 0.5) * float(width)
    v = (0.5 - 0.5 * tri_clip[..., 1] / w) * float(vp_height)
    return (u.amin(1), u.amax(1), v.amin(1), v.amax(1))


# pair slots per packed record at big scale 1, and their floor: frame 1
# of the 4K stress scene binds 1.4 pairs a record, the 8K demo 19.4
# (398,991 pairs) under the floor
PAIRS_PER_RECORD = 2
PAIR_FLOOR = 2**19
# slot counts round up to this
_PAIR_ROUND = 2**12

# test hook: pin the pair capacity at big scale 1 (scaled by big_scale,
# so the overflow -> bump -> re-render ladder can recover); the floor
# above keeps real small scenes from ever overflowing
_FORCE_PAIR_CAPACITY = None


def pair_capacity(records: int, big_scale: int = 1) -> int:
    """Static (tile, record) pair slots of a pass over ``records``
    packed records: ``max(2 * records, 2^19) * big_scale``, rounded up
    to a multiple of 4096."""
    if _FORCE_PAIR_CAPACITY:
        return _FORCE_PAIR_CAPACITY * big_scale
    c = max(PAIRS_PER_RECORD * records, PAIR_FLOOR) * big_scale
    return -(-c // _PAIR_ROUND) * _PAIR_ROUND


def bin_packed(packed: torch.Tensor, valid: torch.Tensor, bbox,
               height: int, width: int, y0: int = 0, big_scale: int = 1):
    """CSR binning of records to the tiles of an H x W frame, or of the
    band of H rows whose first row is row ``y0`` of a taller frame
    (``bbox`` in the frame's coordinates), over
    ``pair_capacity(R, big_scale)`` pair slots.

    Returns (index i32[C], starts i32[NT], counts i32[NT], overflow
    bool[]) with NT = ceil(H / TILE_H) * ceil(W / TILE_W), tiles
    row-major: tile t's records are
    ``packed[index[starts[t]:starts[t] + counts[t]]]``, in ascending row
    order. A triangle goes to every tile its clipped bounding box
    touches, as in the reference; triangles whose box misses the band
    are dropped. Without overflow, ``index[:counts.sum()]``, ``starts``
    and ``counts`` are those of exact binning; with it, the pairs past
    the C-th (in record order) are left out."""
    return binning.bin_tiles(valid, bbox, height, width, y0,
                             pair_capacity(packed.shape[0], big_scale))


def bin_bands(bands, width: int, big_scale: int = 1):
    """:func:`bin_packed` of several bands of one pass: ``bands`` holds
    (valid, bbox, height, y0) per band, each on its own device."""
    return [binning.bin_tiles(v, b, h, width, y0,
                              pair_capacity(v.shape[0], big_scale))
            for v, b, h, y0 in bands]


def _k1_pass(packed, index, starts, counts, depth, y0, vp_height):
    fused, winner = rasterize_tiles(packed.contiguous(), index, starts,
                                    counts, depth.contiguous(), y0=y0,
                                    vp_height=vp_height,
                                    check_segments=False)
    return fused[0], winner, fused[2:6], fused[1]


def rasterize_packed(packed: torch.Tensor, valid: torch.Tensor, bbox,
                     height: int, width: int,
                     depth: Optional[torch.Tensor] = None, y0: int = 0,
                     vp_height: Optional[int] = None, big_scale: int = 1):
    """One raster pass over packed records (``rc.pack_coeffs_full``, id
    lane already holding global ranks), over the frame or over the band
    of ``height`` rows from row ``y0`` of a ``vp_height``-row frame
    (records set up and boxed at the full height). A band is bit-equal
    to the same rows of the whole frame.

    Returns (depth f32[H, W], winner i32[H, W], vary_num f32[4, H, W],
    vary_den f32[H, W], overflow bool[]): the reference's contract, its
    flag set when the pass's pairs outgrow the pair capacity at
    ``big_scale`` (the port has no big-triangle list, the reference's
    other flag). The perspective-correct varyings at pixel p are
    ``vary_num[:, p] / vary_den[p]`` (den is 1 where nothing covers)."""
    if depth is None:
        depth = torch.ones((height, width), dtype=torch.float32,
                           device=packed.device)
    index, starts, counts, overflow = bin_packed(
        packed, valid, bbox, height, width, y0=y0, big_scale=big_scale)
    return (*_k1_pass(packed, index, starts, counts, depth, y0, vp_height),
            overflow)


def rasterize_bands(packed: torch.Tensor, valid: torch.Tensor, bbox,
                    width: int, vp_height: int, bands, big_scale: int = 1):
    """:func:`rasterize_packed` over row bands of one frame, each on its
    own device: ``bands`` holds (y0, depth f32[h, W]) per band, the
    band's device being its depth's. The records go to each device
    (``non_blocking``; a no-op where they already are), then binning,
    K1 and shading run band by band on each device's current stream, with
    no host sync. Returns one (depth, winner, num, den, overflow) per
    band."""
    moved = []
    for _y0, depth in bands:
        dev = depth.device
        moved.append((packed.to(dev, non_blocking=True),
                      valid.to(dev, non_blocking=True),
                      tuple(c.to(dev, non_blocking=True) for c in bbox)))
    bins = bin_bands([(v, b, depth.shape[0], y0) for (y0, depth), (_p, v, b)
                      in zip(bands, moved)], width, big_scale)
    return [(*_k1_pass(p, index, starts, counts, depth, y0, vp_height),
             overflow)
            for (y0, depth), (p, _v, _b), (index, starts, counts, overflow)
            in zip(bands, moved, bins)]


def rasterize(tc: rc.TriCoeffs, height: int, width: int,
              depth: Optional[torch.Tensor] = None, base_index: int = 0,
              tri_clip: Optional[torch.Tensor] = None, y0: int = 0,
              vp_height: Optional[int] = None):
    """Binning and K1 over set-up triangles (``tc`` from
    ``rc.triangle_setup`` at the full frame height ``vp_height``,
    default ``height``), ids from ``base_index``; ``tri_clip`` (clip
    positions) gives the boxes binning needs. Same results as
    :func:`rasterize_packed`."""
    if tri_clip is None:
        raise ValueError("the tile path needs tri_clip for binning")
    vp_height = height if vp_height is None else vp_height
    return rasterize_packed(
        rc.pack_coeffs_full(tc, base=base_index), tc.valid,
        viewport_bbox(tri_clip, width, vp_height), height, width,
        depth=depth, y0=y0, vp_height=vp_height)


def rasterize_visibility(tc: rc.TriCoeffs, height: int, width: int,
                         depth: Optional[torch.Tensor] = None,
                         base_index: int = 0,
                         tri_clip: Optional[torch.Tensor] = None):
    """Visibility only, (depth f32[H, W], winner i32[H, W]): the oracle's
    signature (``raster_ref.rasterize_visibility``) over the tile path."""
    d, w, _num, _den, _ovf = rasterize(tc, height, width, depth=depth,
                                       base_index=base_index,
                                       tri_clip=tri_clip)
    return d, w


def shade_from_planes(winner, num, den, fb, fragment_fn):
    """Dense shading from K1's planes: the fragment program over every
    pixel, written where something covers (no blending,
    ``Pipeline.zig:137-140``)."""
    varp = torch.movedim(num, 0, -1) / den[..., None]
    return torch.where((winner >= 0)[..., None], fragment_fn(varp), fb)


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
