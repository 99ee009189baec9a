"""The oracle rasterizer: full-frame, slow, plainly right (torch).

Port of ``myrenderer_tpu/ops/raster_ref.py``. The reference loops over
triangles in submission order with a strict 'less' depth test, so each
pixel ends with the minimum z among the covering triangles whose
z < depth_in, and among those at that z the lowest index. Here the loop
runs over chunks of triangles: a chunk's [chunk, H, W] coverage and
depth planes give its per-pixel minimum and the first index at that
minimum, and a later chunk wins a pixel only with a strictly smaller z.
That is the reference's result, bit for bit, without a Python loop over
triangles. It is the ``oracle`` backend and a test oracle, not a kernel.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import raster_common as rc

# elements of one [chunk, h, w] temporary (16 MiB of f32)
CHUNK_ELEMENTS = 1 << 22

# pixels added around a triangle's bounding box: the box's rounding error
# is far below a pixel, so the window holds every pixel it covers
_WINDOW_PAD = 2


def _chunks(n: int, height: int, width: int, bbox, valid):
    """Consecutive triangle chunks [(c0, c1, y0, y1, x0, x1)] and the
    pixel window each evaluates: the union of its valid triangles'
    padded boxes (the whole frame without ``bbox``), a chunk growing
    while ``chunk * window`` stays within CHUNK_ELEMENTS. A chunk of
    invalid triangles only has no window (they cover nothing)."""
    if bbox is None:
        step = max(1, CHUNK_ELEMENTS // max(1, height * width))
        return [(c0, min(c0 + step, n), 0, height, 0, width)
                for c0 in range(0, n, step)]
    b = torch.stack([c.float() for c in bbox], 1).cpu().numpy()
    ok = valid.cpu().numpy()
    full = ~np.isfinite(b).all(1)
    lo_x = np.where(full, 0, np.clip(np.floor(b[:, 0]) - _WINDOW_PAD, 0,
                                     width))
    hi_x = np.where(full, width, np.clip(np.ceil(b[:, 1]) + _WINDOW_PAD + 1,
                                         0, width))
    lo_y = np.where(full, 0, np.clip(np.floor(b[:, 2]) - _WINDOW_PAD, 0,
                                     height))
    hi_y = np.where(full, height, np.clip(np.ceil(b[:, 3]) + _WINDOW_PAD
                                          + 1, 0, height))
    ok &= (hi_x > lo_x) & (hi_y > lo_y)
    out = []
    c0, win = 0, None
    for i in np.nonzero(ok)[0]:
        box = (int(lo_y[i]), int(hi_y[i]), int(lo_x[i]), int(hi_x[i]))
        grown = box if win is None else (
            min(win[0], box[0]), max(win[1], box[1]),
            min(win[2], box[2]), max(win[3], box[3]))
        area = (grown[1] - grown[0]) * (grown[3] - grown[2])
        if win is not None and (i + 1 - c0) * area > CHUNK_ELEMENTS:
            out.append((c0, int(i), *win))
            c0, grown = int(i), box
        win = grown
    if win is not None:
        out.append((c0, n, *win))
    return out


def rasterize_visibility(tc: rc.TriCoeffs, height: int, width: int,
                         depth: Optional[torch.Tensor] = None,
                         winner: Optional[torch.Tensor] = None,
                         base_index: int = 0, bbox=None):
    """Visibility over the full frame: returns (depth f32[H, W], winner
    i32[H, W]), winner being the front-most triangle's index plus
    ``base_index`` (-1 where nothing covers).

    ``bbox`` (``raster.viewport_bbox`` of the triangles' clip positions)
    lets each chunk evaluate only the pixels its triangles' boxes reach,
    padded by ``_WINDOW_PAD``; the result is the same bit for bit (each
    pixel's tests are its own), read from the boxes once on the host."""
    dev = tc.en_abc.device
    if depth is None:
        depth = torch.ones((height, width), dtype=torch.float32, device=dev)
    if winner is None:
        winner = torch.full((height, width), -1, dtype=torch.int32,
                            device=dev)
    depth, winner = depth.clone(), winner.clone()
    packed = rc.pack_coeffs(tc)                           # [T, 16]
    inf = torch.tensor(float("inf"), device=dev)
    for c0, c1, y0, y1, x0, x1 in _chunks(packed.shape[0], height, width,
                                          bbox, tc.valid):
        px, py = rc.pixel_grids(y1 - y0, x1 - x0, y0, x0, device=dev)
        rec = packed[c0:c1][:, None, None, :]             # [n, 1, 1, 16]
        cov, z = rc.coverage_depth(rec, px, py)           # [n, h, w]
        d_in = depth[y0:y1, x0:x1]
        hit = cov & (z < d_in)
        zc = torch.where(hit, z, inf)
        zmin = zc.amin(0)
        at_min = hit & (zc == zmin)
        first = at_min.to(torch.int8).argmax(0)           # lowest index
        depth[y0:y1, x0:x1], winner[y0:y1, x0:x1] = rc.depth_test_update(
            at_min.any(0), z.gather(0, first[None])[0], d_in,
            winner[y0:y1, x0:x1], first + (base_index + c0))
    return depth, winner


def planes(tc: rc.TriCoeffs, winner: torch.Tensor):
    """The winners' varying planes at the frame's pixel centres:
    (num f32[C, H, W], den f32[H, W]), each plane
    evaluated as ``a*px + b*py + c`` on its coefficient bits (numerator
    0, denominator 1 where nothing covers), the convention of K1's
    fused planes. The check of K1 against the oracle on the card reads
    them (the JAX package's ``tools/tpu_checks.py`` ``oracle_planes``)."""
    height, width = winner.shape
    px, py = rc.pixel_grids(height, width, device=winner.device)
    covered = winner >= 0
    t = torch.clamp(winner, min=0).long()
    en = tc.en_abc[t]                                     # [H, W, 3]
    col = tc.col_abc[t]                                   # [H, W, 3, C]
    den = rc.edge_eval(en[..., 0], en[..., 1], en[..., 2], px, py)
    num = rc.edge_eval(col[..., 0, :], col[..., 1, :], col[..., 2, :],
                       px[..., None], py[..., None])
    num = torch.where(covered[..., None], num, torch.zeros_like(num))
    den = torch.where(covered, den, torch.ones_like(den))
    return torch.movedim(num, -1, 0), den


def shade(tc: rc.TriCoeffs, winner: torch.Tensor, fb: torch.Tensor,
          fragment_fn, base_index: int = 0, ctx=None) -> torch.Tensor:
    """Run the fragment program on the pixels whose winner lies in this
    batch's id range and write them (no blending,
    ``Pipeline.zig:137-140``). ``ctx`` goes to two-parameter fragment
    programs."""
    height, width = winner.shape
    px, py = rc.pixel_grids(height, width, device=winner.device)
    local = winner - base_index
    in_range = (local >= 0) & (local < tc.en_abc.shape[0])
    varp, _ = rc.resolve_varyings(
        tc, torch.where(in_range, local, torch.zeros_like(local)), px, py)
    rgba = fragment_fn(varp) if ctx is None else fragment_fn(varp, ctx)
    return torch.where(in_range[..., None], rgba, fb)


def rasterize(tri_clip: torch.Tensor, tri_vary: torch.Tensor,
              valid: torch.Tensor, fb: torch.Tensor, depth: torch.Tensor,
              fragment_fn, cull_mode: str = "back"):
    """One batch: visibility, then shading. Returns (fb, depth)."""
    height, width = depth.shape
    tc = rc.triangle_setup(tri_clip, tri_vary, valid, width, height,
                           cull_mode, oracle=True)
    depth, winner = rasterize_visibility(tc, height, width, depth=depth)
    return shade(tc, winner, fb, fragment_fn), depth
