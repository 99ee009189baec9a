"""Texture sampling for vertex and fragment functions (torch).

Port of ``myrenderer_tpu/ops/sampling.py``. A texture is an f32[H, W, C]
binding attachment and sampling is explicit math inside the pipeline's
functions (``Pipeline.zig:34-55`` declares texture_view and
texture_sampler bindings). Coordinates are WebGPU-style normalized UV
(u right, v down, [0, 1]); addressing is clamp-to-edge.

Rounding forms are those of the JAX package's compiled sampler on the
CPU: ``fma`` where its compiler contracts a multiply into an add.
"""

from __future__ import annotations

import torch

from .raster_common import fma


def sample_nearest(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour sample. tex f32[H, W, C], uv f32[..., 2];
    returns f32[..., C]."""
    h, w = tex.shape[0], tex.shape[1]
    x = torch.clamp((uv[..., 0] * float(w)).to(torch.int32), 0, w - 1)
    y = torch.clamp((uv[..., 1] * float(h)).to(torch.int32), 0, h - 1)
    return tex[y.long(), x.long()]


def sample_bilinear(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear sample (a 'filtering' sampler, ``Pipeline.zig:111``).
    tex f32[H, W, C], uv f32[..., 2]; returns f32[..., C]."""
    h, w = tex.shape[0], tex.shape[1]
    # ``uv * w - 0.5`` contracts to fma(uv, w, -0.5)
    # the constants are filled on the device: a frame uploads nothing
    half = torch.full((), -0.5, device=uv.device)
    fx = fma(uv[..., 0], torch.full((), float(w), device=uv.device), half)
    fy = fma(uv[..., 1], torch.full((), float(h), device=uv.device), half)
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    # clamp-to-edge: x1 comes from the UNCLAMPED floor (clamping first
    # would blend texels 0 and 1 at the left/top borders: at u=0 the
    # result is texel 0 exactly, tx weighting a duplicate of it)
    x0i = x0.to(torch.int32)
    y0i = y0.to(torch.int32)
    x1 = torch.clamp(x0i + 1, 0, w - 1).long()
    y1 = torch.clamp(y0i + 1, 0, h - 1).long()
    x0c = torch.clamp(x0i, 0, w - 1).long()
    y0c = torch.clamp(y0i, 0, h - 1).long()
    t00 = tex[y0c, x0c]
    t01 = tex[y0c, x1]
    t10 = tex[y1, x0c]
    t11 = tex[y1, x1]
    # ``p*(1 - t) + q*t`` contracts to fma(p, 1 - t, q*t); for a
    # one-channel texture the reference's compiler fuses the rows' other
    # product first, fma(q, t, p*(1 - t))
    if tex.shape[-1] == 1:
        top = fma(t01, tx, t00 * (1 - tx))
        bot = fma(t11, tx, t10 * (1 - tx))
    else:
        top = fma(t00, 1 - tx, t01 * tx)
        bot = fma(t10, 1 - tx, t11 * tx)
    return fma(top, 1 - ty, bot * ty)
