"""Shared rasterization math (torch): triangle setup, eye-plane clipping,
the 32-lane record pack and the per-pixel coverage rule.

Port of ``myrenderer_tpu/ops/raster_common.py``. The method is the same
clipless 2D-homogeneous rasterization (Olano & Greer 1997): edge
functions are built from clip-space coordinates lifted to pixel space,

    u_i = (0.5*x_i + 0.5*w_i) * W,   v_i = (0.5*w_i - 0.5*y_i) * H
    e_k(p) = det[P_i, P_j, p],       p = (px, py, 1)   (k, i, j cyclic)

so e_k = a_k*px + b_k*py + c_k, coverage is all e_k > 0 (top-left rule
on zeros), depth is sum e_k z_k / sum e_k w_k and varyings are
perspective-correct ratios of planes. Pixel centers sample at
(px + 0.5, py + 0.5).

Rounding form. The reference's numbers are those of XLA on the CPU,
which contracts ``a*x + b*y`` into ``fma(a, x, b*y)`` inside a fusion.
Every expression here spells the form the reference computes: ``fma``
(``torch.addcmul``, one rounding) where the reference fuses, separate
operations elsewhere. The CUDA kernel (``csrc/raster_tile.cu``) spells
the same forms with ``__fmaf_rn`` and is built with ``-fmad=false``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import straddlers

# Minimum clip-space w for a triangle to be rasterized.
W_EPS = 1e-6

# Target w of vertices emitted by the eye-plane clipper: safely above
# W_EPS so clipped triangles always pass triangle_setup's w test.
W_CLIP = 8e-6

# Number of visibility lanes of a record: a0,b0,c0, a1,b1,c1, a2,b2,c2,
# zna,znb,znc, wna,wnb,wnc, zhi.
COEFF_LANES = 16

# Full record: [0:16] visibility lanes, [16] triangle id, [17:20] the
# varying denominator plane (sum e), [20:32] four varying numerator
# planes, (a, b, c) per channel.
FULL_LANES = 32

# Top-left fill-rule threshold: the smallest NORMAL f32. A top-left edge
# passes coverage at e == 0 via e > -eps; other edges stay strict
# (e > -0.0). Subnormals must not be flushed anywhere this is compared.
TL_EPS = 1.17549435e-38


def fma(a, b, c):
    """``a*b + c`` with one rounding (the reference's contracted form)."""
    return torch.addcmul(c, a, b)


def mul_add2(a, x, b, y):
    """``a*x + b*y`` as XLA contracts it: ``fma(a, x, b*y)``."""
    return fma(a, x, b * y)


class Triangles(NamedTuple):
    """A batch of assembled triangles.

    ``clip`` f32[T, 3, 4] clip positions, ``vary`` f32[T, 3, C]
    varyings. ``ids`` (optional i32[T]) holds each array slot's
    SUBMISSION rank when a producer emits triangles out of submission
    order (the terrain emits all first-half-quad triangles, then all
    second-half ones); the pack puts ``ids`` into the record's id lane,
    so depth ties and winner indices are those of submission order.
    None means array order is submission order.

    ``planar`` marks the output of a whole-stream vertex function, which
    the JAX package carries in its planar layout; it selects the
    reference's rounding form of some setup lanes (``_plane_forms``)."""

    clip: torch.Tensor
    vary: torch.Tensor
    ids: Optional[torch.Tensor] = None
    planar: bool = False


class TriCoeffs(NamedTuple):
    """Per-triangle linear coefficients, all shaped [T, ...]."""

    edge_a: torch.Tensor   # [T, 3]
    edge_b: torch.Tensor   # [T, 3]
    edge_c: torch.Tensor   # [T, 3]
    z_abc: torch.Tensor    # [T, 3]  depth numerator plane
    w_abc: torch.Tensor    # [T, 3]  depth denominator plane
    col_abc: torch.Tensor  # [T, 3, C] varying numerator planes
    en_abc: torch.Tensor   # [T, 3]  varying denominator plane (sum e)
    valid: torch.Tensor    # [T] bool
    zhi: torch.Tensor      # [T] f32: 0 = invalid; else the z window
                           # is [zhi - 1, zhi]


def _plane(aa, bb, cc, vals, forms):
    """``sum_k e_k * vals_k`` as (a, b, c) columns, [T, 3].

    The reference's ``x0*v0 + x1*v1 + x2*v2`` contracts to
    ``fma(x2, v2, fma(x0, v0, x1*v1))`` (form 0) or
    ``fma(x2, v2, fma(x1, v1, x0*v0))`` (form 1); which product the
    compiler fuses first differs per column. ``forms`` gives the form of
    the a, b and c columns (see ``_plane_forms``)."""
    def dot3(x, form):
        inner = (mul_add2(x[0], vals[0], x[1], vals[1]) if form == 0
                 else mul_add2(x[1], vals[1], x[0], vals[0]))
        return fma(x[2], vals[2], inner)
    return torch.stack([dot3(aa, forms[0]), dot3(bb, forms[1]),
                        dot3(cc, forms[2])], dim=1)


def _plane_forms(cull_mode: str, planar: bool, biased: bool,
                 oracle: bool = False):
    """Rounding forms of the (z, w, varying) planes' (a, b, c) columns,
    pinned bit for bit against the JAX package on the CPU, whose
    compiler picks the product it fuses first by the shape of each
    column's expression graph: the cull mode's sign flip, the JAX
    package's planar layout (whole-stream vertex functions) and, for
    the depth plane, whether a z bias is set all change it. The oracle
    backend's graph (setup compiled with the full-frame rasterizer)
    has forms of its own, the same for both layouts."""
    if cull_mode == "front":
        return ((1, 1, 1),) * 3
    if cull_mode == "none":
        return ((0, 0, 0),) * 3
    if oracle:
        return (1, 0, 0), (1, 0, 0), (0, 0, 0)
    if not planar:
        return ((1, 0, 0),) * 3
    return ((1, 0, 0) if biased else (1, 0, 1)), (1, 0, 0), (1, 0, 1)


def triangle_setup(tri_clip: torch.Tensor, tri_vary: torch.Tensor,
                   valid: torch.Tensor, width: int, height: int,
                   cull_mode: str = "back",
                   z_bias: Optional[float] = None,
                   planar: bool = False, oracle: bool = False) -> TriCoeffs:
    """Assemble per-triangle plane coefficients.

    tri_clip f32[T, 3, 4], tri_vary f32[T, 3, C], valid bool[T].
    Culling: front faces are clockwise in framebuffer space;
    ``cull_mode='back'`` keeps det > 0 only (which also drops
    degenerates). ``z_bias`` shifts each triangle's NDC depth by a
    constant (z_clip += bias * w); the merged multi-surface pass gives
    surface s the bias 2*(S-1-s), and the record's z window becomes
    [bias, bias + 1]. ``planar`` marks triangles from a whole-stream
    vertex function (:attr:`Triangles.planar`); ``oracle`` takes the
    oracle backend's rounding forms (``_plane_forms``)."""
    f32 = torch.float32
    cpl = tri_clip.to(f32).permute(1, 2, 0)          # [3, 4, T]
    vpl = tri_vary.to(f32).permute(1, 2, 0)          # [3, C, T]
    C = vpl.shape[1]
    xs = [cpl[k, 0] for k in range(3)]
    ys = [cpl[k, 1] for k in range(3)]
    zs = [cpl[k, 2] for k in range(3)]
    ws = [cpl[k, 3] for k in range(3)]

    # 0.5*x and 0.5*w are exact, so the contracted and the separately
    # rounded forms agree here
    us = [(0.5 * x + 0.5 * w) * float(width) for x, w in zip(xs, ws)]
    vs = [(0.5 * w - 0.5 * y) * float(height) for y, w in zip(ys, ws)]

    # edge k spans vertices (k+1, k+2) mod 3; ``p*q - r*s`` contracts to
    # fma(p, q, -(r*s))
    aa, bb, cc = [], [], []
    for k in range(3):
        i, j = (k + 1) % 3, (k + 2) % 3
        aa.append(fma(vs[i], ws[j], -(vs[j] * ws[i])))
        bb.append(fma(us[j], ws[i], -(us[i] * ws[j])))
        cc.append(fma(us[i], vs[j], -(us[j] * vs[i])))

    # det = e_0 evaluated at P_0 (homogeneous)
    det = fma(cc[0], ws[0], mul_add2(aa[0], us[0], bb[0], vs[0]))

    if cull_mode == "back":
        facing_ok = det > 0
        sign = None
    elif cull_mode == "front":
        facing_ok = det < 0
        sign = -torch.ones_like(det)
    elif cull_mode == "none":
        facing_ok = det != 0
        sign = torch.sign(det)
    else:
        raise ValueError(f"unknown cull_mode {cull_mode!r}")
    # orient edges so the interior is always e > 0
    if sign is not None:
        aa = [a * sign for a in aa]
        bb = [b * sign for b in bb]
        cc = [c * sign for c in cc]

    w_ok = (ws[0] > W_EPS) & (ws[1] > W_EPS) & (ws[2] > W_EPS)
    valid = valid & facing_ok & w_ok
    if z_bias is not None:
        bias = torch.full((), z_bias, dtype=f32, device=det.device)
        zs = [fma(bias, w, z) for z, w in zip(zs, ws)]
        zhi = torch.where(valid, bias + 1.0, torch.zeros((), dtype=f32,
                                                         device=det.device))
    else:
        zhi = valid.to(f32)   # window [0, 1]

    z_form, w_form, col_form = _plane_forms(cull_mode, planar,
                                            z_bias is not None, oracle)
    z_abc = _plane(aa, bb, cc, zs, z_form)
    w_abc = _plane(aa, bb, cc, ws, w_form)
    en_a0, en_c0 = aa[0], cc[0]
    if oracle and cull_mode == "none":
        # The JAX oracle recomputes the varying denominator plane per
        # pixel, inside the fusion that gathers it for the winners. There
        # the products vs[1]*ws[2] and us[1]*vs[2] are each shared with
        # another expression (one node, two uses), so the compiler fuses
        # the other product of a_0 and of c_0 into the FMA. Only this sum
        # sees those forms; the edges keep the setup's.
        en_a0 = fma(-vs[2], ws[1], vs[1] * ws[2]) * sign
        en_c0 = fma(-us[2], vs[1], us[1] * vs[2]) * sign
    en_abc = torch.stack([en_a0 + aa[1] + aa[2], bb[0] + bb[1] + bb[2],
                          en_c0 + cc[1] + cc[2]], dim=1)
    col_abc = torch.stack(
        [_plane(aa, bb, cc, [vpl[k, ch] for k in range(3)], col_form)
         for ch in range(C)], dim=-1)                # [T, 3, C]
    return TriCoeffs(edge_a=torch.stack(aa, 1), edge_b=torch.stack(bb, 1),
                     edge_c=torch.stack(cc, 1), z_abc=z_abc, w_abc=w_abc,
                     col_abc=col_abc, en_abc=en_abc, valid=valid, zhi=zhi)


def _clip_straddlers(tri_clip: torch.Tensor, tri_vary: torch.Tensor):
    """Clip triangles that straddle the eye plane (some w > W_EPS, some
    <= W_EPS) against w = W_CLIP, Sutherland-Hodgman style. Input
    [N, 3, 4] / [N, 3, C]; returns two candidate triangles per input
    (tri1_clip, tri1_vary, tri2_clip, tri2_vary, valid1, valid2): one
    inside vertex yields one triangle, two yield a fan of two. The
    cyclic vertex order, and so the facing, is the input's."""
    w = tri_clip[..., 3]
    inside = w > W_EPS                               # [N, 3]
    n_in = inside.sum(-1)                            # [N]
    # rotate so the pattern is (in, out, out) or (out, in, in); argmax
    # of a bool row is its first True
    r = torch.where(n_in == 1, inside.to(torch.int8).argmax(-1),
                    (~inside).to(torch.int8).argmax(-1))
    idx = (r[:, None] + torch.arange(3, device=w.device)) % 3
    v = torch.gather(tri_clip, 1, idx[..., None].expand(-1, -1, 4))
    a = torch.gather(tri_vary, 1,
                     idx[..., None].expand(-1, -1, tri_vary.shape[-1]))

    def intersect(i, j):
        wi, wj = v[:, i, 3], v[:, j, 3]
        t = (W_CLIP - wi) / (wj - wi)
        t = t.clamp(0.0, 1.0)[:, None]
        # v_i + t*(v_j - v_i) contracts to fma(t, v_j - v_i, v_i)
        return (fma(t, v[:, j] - v[:, i], v[:, i]),
                fma(t, a[:, j] - a[:, i], a[:, i]))

    i01c, i01v = intersect(0, 1)
    i20c, i20v = intersect(2, 0)

    one_in = (n_in == 1)[:, None, None]
    tri1_clip = torch.where(one_in, torch.stack([v[:, 0], i01c, i20c], 1),
                            torch.stack([i01c, v[:, 1], v[:, 2]], 1))
    tri1_vary = torch.where(one_in, torch.stack([a[:, 0], i01v, i20v], 1),
                            torch.stack([i01v, a[:, 1], a[:, 2]], 1))
    tri2_clip = torch.stack([i01c, v[:, 2], i20c], 1)
    tri2_vary = torch.stack([i01v, a[:, 2], i20v], 1)
    valid1 = (n_in == 1) | (n_in == 2)
    valid2 = n_in == 2
    return tri1_clip, tri1_vary, tri2_clip, tri2_vary, valid1, valid2


def select_straddlers(tri_clip: torch.Tensor, tri_vary: torch.Tensor,
                      valid: torch.Tensor, cap: int):
    """Extract up to ``cap`` eye-plane straddlers (a vertex at
    w <= W_EPS while another is in front: the set triangle_setup's w
    test drops), in array order, and clip each into <= 2 triangles.
    Shapes are fixed and nothing is read back to the host. Returns
    (app_clip [2cap, 3, 4], app_vary [2cap, 3, C], app_valid bool[2cap],
    sel i32[cap], overflow bool[]), as
    :func:`select_straddlers_reference` describes them, bit for bit.

    CUDA tensors launch K4 (``ops/straddlers.py``, one launch, no
    sort); CPU tensors run :func:`select_straddlers_reference`. T must be
    at least 1."""
    straddlers.check(tri_clip, tri_vary, valid, cap)
    if tri_clip.device.type == "cpu":
        return select_straddlers_reference(tri_clip, tri_vary, valid, cap)
    return straddlers.K4(tri_clip, tri_vary, valid, cap)


def select_straddlers_reference(tri_clip: torch.Tensor,
                                tri_vary: torch.Tensor, valid: torch.Tensor,
                                cap: int):
    """The plain PyTorch version of K4, same arguments and results, on
    any device.

    The selection is the reference's static one: sort
    ``where(straddle, arange(T), T)`` and keep the first ``cap``. Returns
    (app_clip [2cap, 3, 4], app_vary [2cap, 3, C], app_valid bool[2cap],
    sel i32[cap], overflow bool[]): the appendee block, laid out as the
    reference lays it out (first triangles of all slots, then second
    triangles), so each batch reserves ``2*cap`` ids after its own.
    ``overflow`` is set on the device when more than ``cap`` triangles
    straddle (the first ``cap`` are clipped; ``Draw`` raises its
    capacity and renders the frame again)."""
    T = tri_clip.shape[0]
    w = tri_clip[..., 3]
    straddle = valid & (w > W_EPS).any(-1) & (w <= W_EPS).any(-1)
    tri_idx = torch.arange(T, dtype=torch.int32, device=w.device)
    sel = torch.sort(torch.where(straddle, tri_idx, T)).values
    if T < cap:
        sel = torch.cat([sel, torch.full((cap - T,), T, dtype=torch.int32,
                                         device=w.device)])
    sel = sel[:cap]
    sel_live = sel < T
    sel = torch.clamp(sel, max=max(T - 1, 0))
    overflow = straddle.sum() > cap
    sel_l = sel.long()
    t1c, t1v, t2c, t2v, v1, v2 = _clip_straddlers(tri_clip[sel_l],
                                                  tri_vary[sel_l])
    app_clip = torch.cat([t1c, t2c])
    app_vary = torch.cat([t1v, t2v])
    app_valid = torch.cat([v1 & sel_live, v2 & sel_live])
    return app_clip, app_vary, app_valid, sel, overflow


def straddler_candidates(tri_clip: torch.Tensor, tri_vary: torch.Tensor,
                         valid: torch.Tensor, cap: int, offset: int,
                         total: int):
    """One shard's part of :func:`select_straddlers`: the shard holds
    rows [offset, offset + T) of a batch of ``total`` triangles. Returns
    (keys i32[cap]: the batch indices of its first ``cap`` straddlers in
    ascending order, ``total`` past them; their clip rows [cap, 3, 4]
    and varying rows [cap, 3, C]; its straddler count i64[]), for
    :func:`merge_straddlers`. Shapes are static; nothing is read
    back."""
    T = tri_clip.shape[0]
    dev = tri_clip.device
    w = tri_clip[..., 3]
    straddle = valid & (w > W_EPS).any(-1) & (w <= W_EPS).any(-1)
    tri_idx = torch.arange(offset, offset + T, dtype=torch.int32, device=dev)
    keys = torch.sort(torch.where(straddle, tri_idx, total)).values
    if T < cap:
        keys = torch.cat([keys, torch.full((cap - T,), total,
                                           dtype=torch.int32, device=dev)])
    keys = keys[:cap]
    if T == 0:
        return (keys, tri_clip.new_zeros((cap, 3, 4)),
                tri_vary.new_zeros((cap, 3, tri_vary.shape[-1])),
                straddle.sum())
    local = torch.clamp(keys - offset, max=T - 1).long()
    return keys, tri_clip[local], tri_vary[local], straddle.sum()


def merge_straddlers(candidates: list, last_clip: torch.Tensor,
                     last_vary: torch.Tensor, cap: int, total: int):
    """:func:`select_straddlers` of a batch of ``total`` triangles from
    its shards' :func:`straddler_candidates` (in shard order, on one
    device) and the batch's last triangle (``last_clip`` [1, 3, 4],
    ``last_vary`` [1, 3, C]: the row select_straddlers' dead slots read).
    One sort of the candidates' indices keeps the batch's first ``cap``
    straddlers; the flag is the shards' summed count against ``cap``.
    Returns select_straddlers' five results, bit for bit."""
    keys = torch.cat([c[0] for c in candidates])
    sel, pick = torch.sort(keys)
    sel, pick = sel[:cap], pick[:cap]
    live = sel < total
    dead = ~live[:, None, None]
    clip = torch.where(dead, last_clip,
                       torch.cat([c[1] for c in candidates])[pick])
    vary = torch.where(dead, last_vary,
                       torch.cat([c[2] for c in candidates])[pick])
    overflow = torch.stack([c[3] for c in candidates]).sum() > cap
    sel = torch.clamp(sel, max=max(total - 1, 0))
    t1c, t1v, t2c, t2v, v1, v2 = _clip_straddlers(clip, vary)
    return (torch.cat([t1c, t2c]), torch.cat([t1v, t2v]),
            torch.cat([v1 & live, v2 & live]), sel, overflow)


def clip_near_capacity(tris: Triangles, valid: torch.Tensor, cap: int):
    """The oracle's eye-plane clipping stage: the appendee block of
    :func:`select_straddlers` concatenated after the batch. Returns
    (Triangles [T + 2cap], valid bool[T + 2cap], overflow bool[]).

    As in the reference, the result is in array order: a permuted
    producer's ``ids`` do not survive (the appendees have no submission
    ranks), so the oracle's winner ids and depth ties follow the array
    order; ``planar`` does, since it selects the setup's rounding
    forms."""
    app_clip, app_vary, app_valid, _sel, overflow = select_straddlers(
        tris.clip, tris.vary, valid, cap)
    return (Triangles(torch.cat([tris.clip, app_clip]),
                      torch.cat([tris.vary, app_vary]), None, tris.planar),
            torch.cat([valid, app_valid]), overflow)


def pack_coeffs(tc: TriCoeffs) -> torch.Tensor:
    """The 16 visibility lanes, f32[T, COEFF_LANES]."""
    a, b, c = tc.edge_a, tc.edge_b, tc.edge_c
    return torch.cat([
        torch.stack([a[:, 0], b[:, 0], c[:, 0], a[:, 1], b[:, 1], c[:, 1],
                     a[:, 2], b[:, 2], c[:, 2]], dim=1),
        tc.z_abc, tc.w_abc, tc.zhi[:, None]], dim=1)


def pack_coeffs_full(tc: TriCoeffs, base: int = 0,
                     ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """f32[T, FULL_LANES] records: visibility lanes, triangle id and the
    varying planes (exactly 4 channels, the FragPass color contract).
    The id lane holds ``base`` plus the array rank, or plus ``ids``
    when given; it is exact below 2^24."""
    T = tc.en_abc.shape[0]
    if tc.col_abc.shape[-1] != 4:
        raise ValueError("full pack requires exactly 4 varying channels")
    dev = tc.en_abc.device
    rank = (torch.arange(T, dtype=torch.float32, device=dev) if ids is None
            else ids.to(torch.float32))
    idl = rank[:, None] + float(base)
    col = tc.col_abc                                   # [T, 3, 4]
    col_flat = torch.cat([col[:, :, ch] for ch in range(4)], dim=1)
    return torch.cat([pack_coeffs(tc), idl, tc.en_abc, col_flat], dim=1)


def edge_is_top_left(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Top-left fill rule for interior-positive edges in y-down pixel
    space: a zero edge value is covered iff the edge is a 'left' edge
    (a > 0) or a 'top' edge (a == 0, b > 0)."""
    return (a > 0) | ((a == 0) & (b > 0))


def edge_eval(a, b, c, px, py):
    """``a*px + b*py + c`` in the reference's form
    ``fma(a, px, b*py) + c``: edges, the depth planes and the varying
    planes all use it."""
    return mul_add2(a, px, b, py) + c


def coverage_depth(rec: torch.Tensor, px, py):
    """One record's coverage and depth at pixel centers (px, py).

    ``rec`` is [..., >= 16] records (lanes broadcast against the pixel
    arrays after indexing). Returns (covered bool, z f32). The rule:
    each edge value against its top-left threshold (edge 0's threshold
    is +inf for invalid records, zhi == 0), then z = zn / wn inside the
    record's window [zhi - 1, zhi]."""
    lane = [rec[..., k] for k in range(COEFF_LANES)]
    (a0, b0, c0, a1, b1, c1, a2, b2, c2,
     zna, znb, znc, wna, wnb, wnc, zhi) = lane
    neg_eps = torch.full((), -TL_EPS, dtype=torch.float32, device=rec.device)
    inf = torch.full((), float("inf"), dtype=torch.float32, device=rec.device)
    th0 = torch.where(zhi > 0, edge_is_top_left(a0, b0).float() * neg_eps,
                      inf)
    th1 = edge_is_top_left(a1, b1).float() * neg_eps
    th2 = edge_is_top_left(a2, b2).float() * neg_eps
    cov = ((edge_eval(a0, b0, c0, px, py) > th0)
           & (edge_eval(a1, b1, c1, px, py) > th1)
           & (edge_eval(a2, b2, c2, px, py) > th2))
    z = edge_eval(zna, znb, znc, px, py) / edge_eval(wna, wnb, wnc, px, py)
    cov = cov & (z >= zhi - 1.0) & (z <= zhi)
    return cov, z


def depth_test_update(cov, z, depth, winner, tri_index):
    """Depth 'less' test against the running depth buffer
    (``Pipeline.zig:150-154``): covered pixels with z < depth take z and
    ``tri_index`` (an int, or one index per pixel). Ties keep the
    earlier triangle."""
    win = cov & (z < depth)
    return (torch.where(win, z, depth),
            torch.where(win, torch.as_tensor(tri_index, dtype=winner.dtype,
                                             device=winner.device), winner))


def resolve_varyings(tc: TriCoeffs, winner: torch.Tensor, px, py):
    """Perspective-correct varyings of each pixel's winning triangle.
    Returns (varyings f32[H, W, C], covered bool[H, W]); uncovered
    pixels read triangle 0."""
    covered = winner >= 0
    t = torch.clamp(winner, min=0).long()
    en_abc = tc.en_abc[t]                                 # [H, W, 3]
    col_abc = tc.col_abc[t]                               # [H, W, 3, C]
    en = edge_eval(en_abc[..., 0], en_abc[..., 1], en_abc[..., 2], px, py)
    cn = edge_eval(col_abc[..., 0, :], col_abc[..., 1, :],
                   col_abc[..., 2, :], px[..., None], py[..., None])
    return cn / en[..., None], covered


def pixel_grids(height: int, width: int, y0: int = 0, x0: int = 0,
                device=None):
    """Pixel-center coordinate grids (px, py), f32[height, width], of the
    region whose top-left pixel is (x0, y0): ``iota + y0 + 0.5``, two
    roundings, as in the reference."""
    f32 = torch.float32
    py = (torch.arange(height, dtype=f32, device=device)[:, None]
          + float(y0) + 0.5).expand(height, width)
    px = (torch.arange(width, dtype=f32, device=device)[None, :]
          + float(x0) + 0.5).expand(height, width)
    return px, py
