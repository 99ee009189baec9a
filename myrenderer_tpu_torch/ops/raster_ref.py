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

import torch

from . import raster_common as rc

# elements of one [chunk, H, W] temporary (16 MiB of f32)
CHUNK_ELEMENTS = 1 << 22


def rasterize_visibility(tc: rc.TriCoeffs, height: int, width: int,
                         depth: Optional[torch.Tensor] = None,
                         winner: Optional[torch.Tensor] = None,
                         base_index: int = 0):
    """Visibility over the full frame: returns (depth f32[H, W], winner
    i32[H, W]), winner being the front-most triangle's index plus
    ``base_index`` (-1 where nothing covers)."""
    dev = tc.en_abc.device
    px, py = rc.pixel_grids(height, width, device=dev)
    if depth is None:
        depth = torch.ones((height, width), dtype=torch.float32, device=dev)
    if winner is None:
        winner = torch.full((height, width), -1, dtype=torch.int32,
                            device=dev)
    packed = rc.pack_coeffs(tc)                           # [T, 16]
    chunk = max(1, CHUNK_ELEMENTS // max(1, height * width))
    inf = torch.tensor(float("inf"), device=dev)
    for c0 in range(0, packed.shape[0], chunk):
        rec = packed[c0:c0 + chunk][:, None, None, :]     # [n, 1, 1, 16]
        cov, z = rc.coverage_depth(rec, px, py)           # [n, H, W]
        hit = cov & (z < depth)
        zc = torch.where(hit, z, inf)
        zmin = zc.amin(0)
        at_min = hit & (zc == zmin)
        first = at_min.to(torch.int8).argmax(0)           # lowest index
        depth, winner = rc.depth_test_update(
            at_min.any(0), z.gather(0, first[None])[0], depth, winner,
            first + (base_index + c0))
    return depth, winner


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
