"""Scene math on the device: transform composition, conservative
culling and the vertex stage (torch).

Port of ``myrenderer_tpu/ops/vertex_stage.py``. The reference's
pointer-chasing scene recursion (``Renderer/SceneNode.zig:91-132``)
becomes level-scheduled batched 4x4 products over a node table, and its
per-vertex shader (``Pipeline.zig:95-98``) a batched call of the
pipeline's Python vertex function (``torch.func.vmap``), or a
whole-stream function where the pipeline gives one.

4x4 products are spelled out as FMA chains (``matmul4``) instead of
``torch.matmul``: the order of a library product is not promised, and
the reference's XLA product on the CPU accumulates k = 0..3 in order
with one rounding per step.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .raster_common import Triangles, fma


def matmul4(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` over the last two dims (k = 4), accumulated in k order
    as ``fma(a[..., k], b[k, ...], acc)`` from ``a[..., 0] * b[0]``."""
    acc = a[..., :, 0:1] * b[..., 0:1, :]
    for k in range(1, a.shape[-1]):
        acc = fma(a[..., :, k:k + 1], b[..., k:k + 1, :], acc)
    return acc


def matvec4(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``m @ v`` for m [..., 4, 4] and v [..., 4], in matmul4's order."""
    return matmul4(m, v[..., None])[..., 0]


def per_device(make: Callable, device) -> Callable:
    """``get(dev)``: the constants ``make(dev)`` makes, made once per
    device, first on ``device`` (the renderer's) here. A vertex function
    reads them on the device its triangles run on (``ctx.world.device``):
    on a mesh each card makes its own at its first, eager, frame, so no
    captured frame uploads and no card reads another's memory."""
    cache = {}

    def get(dev):
        c = cache.get(dev)
        if c is None:
            c = cache[dev] = make(dev)
        return c

    get(torch.device(device))
    return get


def level_indices(levels: Sequence[np.ndarray], parents: np.ndarray,
                  device) -> list:
    """The (nodes, their parents) long index pairs of each level, depth
    1, 2, ... (``levels`` lists the node indices at each depth), for
    :func:`compose_world_transforms`; made once on ``device`` (a frame
    plan keeps them, so a frame uploads nothing)."""
    return [(torch.as_tensor(idxs, dtype=torch.long, device=device),
             torch.as_tensor(parents[idxs], dtype=torch.long, device=device))
            for idxs in levels if len(idxs)]


def compose_world_transforms(locals_: torch.Tensor,
                             levels: Sequence[tuple]) -> torch.Tensor:
    """world[n] = world[parent[n]] @ local[n] (``SceneNode.zig:96``),
    level by level over the (nodes, parents) index pairs of
    :func:`level_indices` (roots keep their local transform)."""
    world = locals_.clone()
    for i, p in levels:
        world[i] = matmul4(world[p], locals_[i])
    return world


def cull_aabb(clip_mats: torch.Tensor, aabb_min: torch.Tensor,
              aabb_max: torch.Tensor, finite: torch.Tensor) -> torch.Tensor:
    """Conservative frustum culling: a box is culled only when all 8
    corners lie outside one clip half-space (x, y in [-w, w], z in
    [0, w]). clip_mats f32[I, 4, 4], aabb_min/max f32[I, 3], finite
    bool[I] (False = infinite box, always visible)."""
    # corner k takes the max of axis a where bit a of k is set
    k = torch.arange(8, device=clip_mats.device)
    sel = ((k[:, None] >> torch.arange(3, device=k.device)) & 1).bool()
    corners = torch.where(sel[None], aabb_max[:, None], aabb_min[:, None])
    hom = torch.cat([corners, torch.ones_like(corners[..., :1])], -1)
    cc = matvec4(clip_mats[:, None], hom)                     # [I, 8, 4]
    x, y, z, w = cc[..., 0], cc[..., 1], cc[..., 2], cc[..., 3]
    outside = ((x < -w).all(1) | (x > w).all(1) | (y < -w).all(1)
               | (y > w).all(1) | (z < 0).all(1) | (z > w).all(1))
    return torch.where(finite, ~outside, torch.ones_like(outside))


def _view_bits(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x.view(dtype)`` between 32-bit dtypes, also on a tensor batched
    by ``torch.func.vmap`` (a vertex function's binding words): some
    torch releases have no batching rule for ``view.dtype``, so the
    batched wrapper is taken off, its tensor viewed and wrapped again
    (the shape, and so the batch dim, is unchanged)."""
    from torch._C import _functorch as ft
    if ft.is_batchedtensor(x):
        inner = _view_bits(ft.get_unwrapped(x), dtype)
        return ft._add_batch_dim(inner, ft.maybe_get_bdim(x),
                                 ft.maybe_get_level(x))
    return x.view(dtype)


def bitcast_u32(x) -> torch.Tensor:
    """Reinterpret f32 bits as u32: how vertex and fragment functions
    read integer fields of managed bindings (a WGSL ``u32`` uniform
    member, e.g. ``Terrain.zig:56`` ``size: u32``). Bit-exact: managed
    stores keep integer payloads as raw bits."""
    return _view_bits(torch.as_tensor(x, dtype=torch.float32), torch.uint32)


def bitcast_i32(x) -> torch.Tensor:
    """f32 bits as int32: :func:`bitcast_u32`'s words, signed, for
    comparisons with integer constants (u32 tensors support few
    operations)."""
    return _view_bits(torch.as_tensor(x, dtype=torch.float32), torch.int32)


def bitcast_f32(x) -> torch.Tensor:
    """Inverse of :func:`bitcast_u32`: 32-bit integer bits read as f32."""
    x = torch.as_tensor(x)
    if x.element_size() != 4:
        raise TypeError(f"bitcast_f32 needs 32-bit elements, got {x.dtype}")
    return _view_bits(x, torch.float32)


class VertexCtx:
    """Per-vertex inputs of a vertex function (WGSL @builtin/@location
    inputs plus bind groups). Under ``vmap``: ``vertex_index`` is a
    scalar, ``attrs`` maps names to f32[k], ``world`` is the composed
    f32[4, 4] transform, and ``binding(loc)`` is this instance's value
    (``instance_id`` indexes the stacked [I, ...] binding arrays)."""

    def __init__(self, vertex_index, attrs, world, instance_id, bindings,
                 draw_instance=None):
        self.vertex_index = vertex_index
        self.attrs = attrs
        self.world = world
        self.instance_id = instance_id
        self.draw_instance = draw_instance
        self._bindings = bindings

    def attr(self, name):
        return self.attrs[name]

    def binding(self, location: int):
        return self._bindings[location][self.instance_id]

    def binding_at(self, location: int, index):
        """``binding(location)[index]`` as ONE gather from the stacked
        array. Under vmap, ``binding(location)[index]`` would first
        gather this instance's whole row for every vertex."""
        return self._bindings[location][self.instance_id, index]

    def binding_stacked(self, location: int):
        """The stacked [I, ...] array of binding ``location``."""
        return self._bindings[location]


class FragmentCtx:
    """Fragment-stage resources for two-parameter fragment functions,
    ``fragment_fn(varyings, ctx)``: ``binding(loc)`` is the drawn
    instance's value for that slot."""

    def __init__(self, bindings):
        self._bindings = bindings

    def binding(self, location: int):
        return self._bindings[location]

    def to(self, device) -> "FragmentCtx":
        """The same bindings on ``device`` (a row band's device)."""
        return FragmentCtx({loc: t.to(device, non_blocking=True)
                            for loc, t in self._bindings.items()})


class BatchVertexCtx:
    """Whole-stream inputs of a batched vertex function: ``vertex_index``
    i32[V], ``attrs`` name -> f32[V, k], ``worlds`` f32[I, 4, 4],
    ``iids`` i32[V], ``binding(loc)`` the stacked [I, ...] array."""

    def __init__(self, vertex_index, attrs, worlds, iids, bindings,
                 draw_instances=None):
        self.vertex_index = vertex_index
        self.attrs = attrs
        self.worlds = worlds
        self.iids = iids
        self.draw_instances = draw_instances
        self._bindings = bindings

    def attr(self, name):
        return self.attrs[name]

    def binding(self, location: int):
        return self._bindings[location]


def run_vertex_stage(vertex_fn: Callable, vertex_index: torch.Tensor,
                     attrs: dict, worlds: torch.Tensor, iids: torch.Tensor,
                     bindings: dict,
                     vertex_batch_fn: Optional[Callable] = None,
                     draw_instances: Optional[torch.Tensor] = None
                     ) -> Triangles:
    """Run the vertex stage over a packed vertex stream and assemble
    triangles. vertex_index i32[V]; attrs name -> f32[V, k]; worlds
    f32[I, 4, 4]; iids i32[V]; bindings loc -> stacked [I, ...].

    A ``vertex_batch_fn`` receives the whole stream and returns
    :class:`Triangles` itself (it may emit a permuted array order with
    ``ids``); otherwise ``vertex_fn`` runs per vertex under vmap and
    returns (clip f32[4], varyings f32[C])."""
    if draw_instances is None:
        draw_instances = torch.zeros_like(vertex_index)
    if vertex_batch_fn is not None:
        ctx = BatchVertexCtx(vertex_index, attrs, worlds, iids, bindings,
                             draw_instances)
        return vertex_batch_fn(ctx)

    def one(vi, attr_row, iid, di):
        ctx = VertexCtx(vi, attr_row, worlds[iid], iid, bindings, di)
        return vertex_fn(ctx)

    clip, vary = torch.func.vmap(one)(vertex_index, attrs, iids.long(),
                                      draw_instances)
    T = clip.shape[0] // 3
    return Triangles(clip.to(torch.float32).reshape(T, 3, 4),
                     vary.to(torch.float32).reshape(T, 3, vary.shape[-1]))
