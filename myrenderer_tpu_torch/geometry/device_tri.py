"""Polygon triangulation on the device: a mask-based ear clipper (torch).

Port of ``myrenderer_tpu/geometry/device_tri.py``. Each of the n - 2
clip steps tests every candidate ear at once, convexity as an [N]
vector and emptiness as an [N, N] matrix, and clips the lowest-index
ear; the steps are a Python loop over a linked list kept in small index
vectors on the points' device. The loop reads nothing back to the host.
O(n^3) work, which is the right trade at polygon scale (the demo's n = 7
and 4): the host Seidel path (``triangulation.py``) wins asymptotically
but chases pointers.

Contract (the host path's, ``Triangulation.zig:442-445``): vertices
clockwise in y-down screen coordinates, implicit closing edge, no
self-intersection; a simple n-gon yields n - 2 triangles. With the
lowest-index-ear rule the indices equal the JAX package's. The triangle
set generally differs from Seidel's; the rasterized coverage does not.
Where collinear vertices leave no strictly convex empty ear, the
clipper takes a non-reflex one (a zero-area triangle).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops.raster_common import fma


def _cross(ax, ay, bx, by, cx, cy):
    """(b - a) x (c - a), positive for a clockwise (y-down) turn, in the
    reference's contracted form ``fma(p, q, -(r*s))``."""
    return fma(bx - ax, cy - ay, -((by - ay) * (cx - ax)))


def triangulate_indices(points: torch.Tensor, n: int,
                        capacity: int = 32) -> torch.Tensor:
    """Ear-clip a clockwise simple polygon on the device of ``points``.

    points f32[N, 2] (N == ``capacity``; slots from ``n`` on are padding
    and ignored); n the live vertex count (2 < n <= N). Returns
    i32[N - 2, 3] triangle vertex indices (polygon indices, clockwise);
    rows from n - 2 on are (0, 0, 0)."""
    N = capacity
    if points.shape != (N, 2):
        raise ValueError(f"points must be [{N}, 2], got "
                         f"{tuple(points.shape)}")
    if not 2 < n <= N:
        raise ValueError(f"need 2 < n <= {N}, got {n}")
    dev = points.device
    px = points[:, 0].to(torch.float32)
    py = points[:, 1].to(torch.float32)
    idx = torch.arange(N, dtype=torch.long, device=dev)

    # circular linked list over the first n slots
    nxt = torch.where(idx + 1 >= n, torch.zeros_like(idx), idx + 1)
    prv = torch.where(idx == 0, torch.full_like(idx, n - 1), idx - 1)
    alive = idx < n
    out = torch.zeros((N - 2, 3), dtype=torch.int32, device=dev)
    jx, jy = px[None, :], py[None, :]
    for k in range(n - 2):
        a, b, c = prv, idx, nxt                        # candidate ears
        cr = _cross(px[a], py[a], px[b], py[b], px[c], py[c])    # [N]
        # emptiness: no OTHER alive vertex strictly inside ear i
        # (row = ear i, column = tested vertex j)
        d0 = _cross(px[a][:, None], py[a][:, None],
                    px[b][:, None], py[b][:, None], jx, jy)
        d1 = _cross(px[b][:, None], py[b][:, None],
                    px[c][:, None], py[c][:, None], jx, jy)
        d2 = _cross(px[c][:, None], py[c][:, None],
                    px[a][:, None], py[a][:, None], jx, jy)
        inside = (d0 > 0) & (d1 > 0) & (d2 > 0)
        other = (alive[None, :] & (idx[None, :] != a[:, None])
                 & (idx[None, :] != b[:, None])
                 & (idx[None, :] != c[:, None]))
        empty = ~(inside & other).any(1)
        # prefer strictly convex empty ears; fall back to collinear
        # ones (zero-area) so degenerate inputs cannot deadlock
        strict = alive & (cr > 0.0) & empty
        loose = alive & (cr >= 0.0) & empty
        cand = torch.where(strict.any(), strict, loose)
        ear = cand.to(torch.int8).argmax()             # lowest index
        ea, ec = prv[ear], nxt[ear]
        out[k] = torch.stack([ea, ear, ec]).to(torch.int32)
        # unlink the ear's tip
        nxt[ea] = ec
        prv[ec] = ea
        alive[ear] = False
    return out


def triangulate_device(points, capacity: int = 32, device="cuda"):
    """List of (x, y) -> flat list of triangle corner points in
    clockwise emit order (``triangulation.triangulate``'s convention),
    triangulated on ``device`` (the card unless the caller asks for the
    CPU; raises without CUDA, as ``Renderer`` does)."""
    device = resolve_device(device)
    pts = np.asarray(points, np.float32)
    n = pts.shape[0]
    if n < 3:
        raise ValueError("polygon needs at least 3 points")
    if n > capacity:
        raise ValueError(f"polygon has {n} points > capacity {capacity}")
    buf = np.zeros((capacity, 2), np.float32)
    buf[:n] = pts
    tris = triangulate_indices(torch.from_numpy(buf).to(device), n,
                               capacity).cpu().numpy()
    return [tuple(pts[i]) for t in tris[:n - 2] for i in t]
