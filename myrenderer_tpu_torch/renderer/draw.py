"""Draw: frame composition and the frame program (torch).

Port of ``myrenderer_tpu/renderer/draw.py``. Mirrors
``Renderer/Draw.zig``'s API (begin / clear / draw_surface / end). A
frame is a function of its arguments (:func:`_frame`): scene transform
composition, culling, the vertex stage, per-batch eye-plane clip +
setup + pack (on the card K4 a batch, then one K2 launch a raster pass
into its record table), raster passes (K1 on the card) and shading. Its
shapes are static and it reads nothing back to the host; it returns the
framebuffer, the winners and an overflow flag ``bool[2]`` (the pair
capacity's lane, the clip capacity's lane). ``end`` runs it, on a card
as one CUDA graph replay (``renderer/compiled.py``), and swaps the
window's framebuffer.

The scene graph is flattened to a node table with per-depth level lists,
and each surface's draw items (pre-order walk, ``SceneNode.zig:119-128``)
are grouped into batches of consecutive items sharing a pipeline. The
plan is cached per scene version and capacity rung; transforms and
bindings are read anew every frame.

Merged pass (tile backend, no surface after the first clears, every
pipeline writes depth): ONE raster pass over every surface. Surface s of
S gets the depth bias 2*(S-1-s), so a covered later surface beats every
earlier one at each pixel (the clear-then-load composition of
``Draw.zig:23-27``) while depth order within a surface is unchanged.
Ids are global submission ranks: each batch takes its T triangles plus
``2 * CLIP_CAPACITY * big_scale`` slots for clipped eye-plane
straddlers, the reference's layout, so winner ids compare equal. Unlike
the reference, a frame of one batch takes this path too; with S = 1 it
gives the reference's sequential ids and depths.

Sequential path (any other frame, and every frame of the oracle
backend): per surface, clear if flagged and start depth at 1.0; per
batch, one raster pass with batch-local ids against the surface's
running depth, kept only when the pipeline writes depth.

Row bands (``Renderer(mesh=...)``): the frame is cut into equal bands of
rows, one per mesh row, each on its device, and each batch's triangles
into as many shards (``parallel.shard_ranges``), shard k on band k's
device, as the JAX frame pins its pre-kernel stage to ``P("rows")``.
Each shard runs its vertex stage (a per-vertex function on the shard's
vertices; a whole-stream function once on each distinct device, each
shard taking its rows of the result), its eye-plane straddler
candidates, setup, pack and boxes (:func:`_shard_stage`). One
all-gather a frame (``parallel.all_gather``) then brings every shard's
pieces to each band's device, where each pass merges the straddlers
(``raster_common.merge_straddlers``), sets up the appendee block,
assembles the table and runs binning, K1 and shading band by band
(:func:`_band_stage`). A band is bit-identical to the same rows of a
single-device frame. The framebuffer and ``last_winners`` stay banded
(``parallel.Banded``); a frame with no clear loads the previous frame's
bands.

Capacity ladder (the reference's ``draw.py:615-788``): one scale,
``Draw.big_scale``, multiplies the clip capacity (``CLIP_CAPACITY`` per
batch) and the pair capacity of binning (``raster.pair_capacity``).
When a frame's flag is set the scale grows x4, up to ``BIG_SCALE_MAX``,
and the frame is rendered again before it publishes. The flag is read
synchronously in the first 3 frames after a (re)build and every frame
under ``Renderer.strict_overflow``; otherwise it rides an asynchronous
copy to pinned host memory and is polled, the queue force-drained
beyond ``OVERFLOW_WINDOW`` frames. At the top of the ladder flags go
unchecked.

The CUDA graph (``compiled.CompiledFrame``): one per plan and rung on
one card. A mesh frame on cards (``compiled.CompiledMeshFrame``) is cut
at its all-gather into the shards' and the bands' stage, each captured
once per distinct card; a replay runs them with the gather's peer
copies between, without a host sync, on one card or several. The oracle
backend runs the same frame eagerly, as the CPU does, and so does any
frame under the private ``Draw._eager_frames``. A vertex or fragment
function runs once, at capture,
and is replayed after that: Python-side values it reads are baked in,
as ``jax.jit`` bakes them into the JAX frame. Published frames are
copies of the graph's outputs.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..ops import raster, raster_ref
from ..ops import raster_common as rc
from ..ops import setup_pack as sp
from ..ops import vertex_stage as vs
from ..parallel.sharding import Banded, all_gather, shard_ranges, split_bands
from .compiled import CompiledFrame, CompiledMeshFrame, device_args
from .pipeline import Pipeline

# eye-plane straddlers clipped per batch at big scale 1 (the demo orbit
# peaks at 72)
CLIP_CAPACITY = 128

# Draw.big_scale grows x4 from 1 up to this, as the reference's does
BIG_SCALE_MAX = 256

# Renderer.raster_backend -> the backend a frame runs: "tile" (binning
# + K1 on the card, its plain version on the CPU) or "oracle"
BACKENDS = {"auto": "tile", "oracle": "oracle"}

# frame plans kept per Draw (one per surface set / window size /
# capacity rung of the current scene version), each with its CUDA graph
# on a card
PLAN_CACHE_SIZE = 8


@dataclass
class _BatchPlan:
    pipeline: Pipeline
    instances: list
    node_indices: np.ndarray        # [I]
    iids: np.ndarray                # [V] i32
    vertex_index: np.ndarray        # [V] i32
    draw_instance: np.ndarray       # [V] i32 (@builtin(instance_index))
    tri_count: int
    attr_offsets: dict              # name -> (offset, width)
    binding_locs: tuple             # managed/attachment locations
    rowspec: list                   # per draw: (vb ordinal, first, count)
    use_batch_fn: bool
    # device -> the index arrays on it (_batch_device_arrays)
    device_arrays: Optional[dict] = None
    # on a mesh, [lo, hi) of each shard's triangles (shard k on band k's
    # device)
    shards: Optional[list] = None


@dataclass
class _FramePlan:
    surfaces: list                  # per surface: its list of _BatchPlan
    clear_flags: tuple
    width: int
    height: int
    backend: str = "tile"
    merged: bool = True
    debug_winner: bool = False
    mesh: Optional[object] = None
    big_scale: int = 1
    # the distinct devices the frame runs on: the renderer's, or the
    # mesh's band devices in band order
    devices: Optional[list] = None
    # device -> the scene's levels as index pairs on it (vs.level_indices)
    level_index: Optional[dict] = None
    # the frame's CUDA graph(s) on a card: CompiledFrame, or
    # CompiledMeshFrame on a mesh
    compiled: Optional[object] = None


def _build_levels(nodes):
    """(parents i32[N], [node indices at depth 1, 2, ...]), walking up
    parent links iteratively with memoized depths."""
    n_nodes = len(nodes)
    parents = np.full(n_nodes, -1, np.int32)
    depth = np.full(n_nodes, -1, np.int32)
    for n in nodes:
        if n.parent is not None:
            parents[n.index] = n.parent.index
    for n in nodes:
        chain = []
        cur = n
        while cur is not None and depth[cur.index] < 0:
            chain.append(cur)
            if len(chain) > n_nodes:
                raise ValueError("scene graph has a parent cycle")
            cur = cur.parent
        d = -1 if cur is None else int(depth[cur.index])
        for c in reversed(chain):
            d += 1
            depth[c.index] = d
    levels = []
    for d in range(1, int(depth.max()) + 1 if n_nodes else 1):
        idxs = np.nonzero(depth == d)[0].astype(np.int32)
        if len(idxs):
            levels.append(idxs)
    return parents, levels


def _build_batches(surface):
    items = [(node, node.backing_instance) for node in surface.base_node.walk()
             if node.backing_instance is not None]
    batches = []
    for node, inst in items:
        # a ctx-consuming fragment program gets ONE batch per instance:
        # its shading range is a batch's id range
        if (batches and batches[-1].pipeline is inst.pipeline
                and not inst.pipeline.fragment_uses_ctx):
            b = batches[-1]
            b.instances.append(inst)
            b.node_indices = np.append(b.node_indices, node.index)
        else:
            batches.append(_BatchPlan(
                pipeline=inst.pipeline, instances=[inst],
                node_indices=np.array([node.index], np.int32),
                iids=None, vertex_index=None, draw_instance=None,
                tri_count=0, attr_offsets={}, binding_locs=(),
                rowspec=[], use_batch_fn=False))

    for b in batches:
        iids, vidx, dinst, rowspec = [], [], [], []
        instanced = False
        for i, inst in enumerate(b.instances):
            vb = inst.vertex_buffer
            if b.pipeline.vertex_layout is not None and not vb.has_buffer:
                raise ValueError(
                    "pipeline declares a vertex layout but instance has a "
                    "buffer-less VertexBuffer (set one via "
                    "set_vertex_buffer)")
            count = vb.vertex_count
            first = vb.first_vertex
            instanced |= vb.instance_count != 1
            for rep in range(vb.instance_count):
                iids.append(np.full(count, i, np.int32))
                dinst.append(np.full(count, vb.first_instance + rep,
                                     np.int32))
                vidx.append(np.arange(first, first + count, dtype=np.int32))
                rowspec.append((i, first, count))
        b.iids = np.concatenate(iids) if iids else np.zeros(0, np.int32)
        b.vertex_index = (np.concatenate(vidx) if vidx
                          else np.zeros(0, np.int32))
        b.draw_instance = (np.concatenate(dinst) if dinst
                           else np.zeros(0, np.int32))
        total = int(b.iids.shape[0])
        if total % 3:
            raise ValueError("vertex stream not a multiple of 3")
        b.tri_count = total // 3
        b.rowspec = rowspec
        layout = b.pipeline.vertex_layout
        b.attr_offsets = layout.offsets() if layout is not None else {}
        b.binding_locs = tuple(
            bl.location for bl in b.pipeline.bindings
            if bl.kind != "builtin_transform")
        # whole-stream vertex fns assume the plain un-instanced stream
        b.use_batch_fn = (b.pipeline.vertex_batch_fn is not None
                          and not instanced)
    return batches


def _mergeable(plan: _FramePlan) -> bool:
    """The reference's rule for one raster pass over every surface: the
    tile backend, no surface after the first clears, and every pipeline
    writes depth (cull modes and fragment programs may differ)."""
    return (plan.backend == "tile" and not any(plan.clear_flags[1:])
            and all(b.pipeline.depth_write
                    for batches in plan.surfaces for b in batches))


# --------------------------------------------------------------------------
# the frame
# --------------------------------------------------------------------------

def _batch_device_arrays(b: _BatchPlan, device) -> dict:
    """The batch's index arrays on ``device``, made when its plan is."""
    return {
        "vidx": torch.from_numpy(b.vertex_index).to(device),
        "iids": torch.from_numpy(b.iids).to(device),
        "dinst": torch.from_numpy(b.draw_instance).to(device),
        "tri_iid": torch.from_numpy(b.iids[::3].astype(np.int64)).to(device),
        "nodes": torch.from_numpy(b.node_indices.astype(np.int64)).to(device),
    }


def _stream_rows(b: _BatchPlan, bargs: dict, lo: int, hi: int):
    """Rows [lo, hi) of the batch's vertex stream (its draws'
    vertex-buffer rows, concatenated), cut from each draw's rows."""
    rows, at = [], 0
    for ordinal, first, count in b.rowspec:
        a, z = max(lo, at), min(hi, at + count)
        if a < z:
            rows.append(bargs["vbs"][ordinal][first + a - at:first + z - at])
        at += count
    return torch.cat(rows, 0) if len(rows) > 1 else rows[0]


def _fragment_ctx(b: _BatchPlan, bargs: dict):
    if not b.pipeline.fragment_uses_ctx:
        return None
    return vs.FragmentCtx({loc: arrs[0] for loc, arrs
                           in bargs["bindings"].items()})


def _vertex_stage(b: _BatchPlan, bargs: dict, dev: dict, clip_mats, inst_vis,
                  rng=None):
    """The vertex stage of batch ``b`` on the device of its index arrays
    ``dev``: (Triangles, visibility bool[T]). ``rng`` = (lo, hi) runs a
    per-vertex function over triangles [lo, hi) alone (vertices
    [3 lo, 3 hi)); a whole-stream function runs over every vertex (it
    may permute its triangles: the caller cuts the range)."""
    lo, hi = (0, b.tri_count) if rng is None or b.use_batch_fn else rng
    whole = (lo, hi) == (0, b.tri_count)
    v = slice(None) if whole else slice(3 * lo, 3 * hi)
    attrs = {}
    if b.attr_offsets:
        packed = _stream_rows(b, bargs, 3 * lo, 3 * hi)
        attrs = {name: packed[:, off:off + wdt]
                 for name, (off, wdt) in b.attr_offsets.items()}
    bindings = {loc: torch.stack(arrs) if len(arrs) > 1 else arrs[0][None]
                for loc, arrs in bargs["bindings"].items()}
    tris = vs.run_vertex_stage(
        b.pipeline.vertex_fn, dev["vidx"][v], attrs, clip_mats,
        dev["iids"][v], bindings,
        vertex_batch_fn=(b.pipeline.vertex_batch_fn
                         if b.use_batch_fn else None),
        draw_instances=dev["dinst"][v])
    if tris.vary.shape[-1] != 4:
        raise ValueError(
            f"vertex function "
            f"{getattr(b.pipeline.vertex_fn, '__name__', '?')!r}"
            f" emitted {tris.vary.shape[-1]} varying channels; the "
            "fragment contract is exactly 4 (the reference's "
            "FragPass vec4, Pipeline.zig:12-32) — pack unused "
            "channels with zeros")
    tri_vis = inst_vis[dev["tri_iid"][slice(None) if whole
                                      else slice(lo, hi)]]
    if tris.ids is not None:
        # permuted producers: slot k holds submission rank ids[k]
        tri_vis = tri_vis[tris.ids.long()]
    return tris, tri_vis


def _surface_visibility(args: dict, world, s_i: int):
    """Per-node clip matrices and conservative visibility of surface
    ``s_i``, each node against its OWN box under its own composed
    transform."""
    clip_all = vs.matmul4(args["surfaces"][s_i]["persp"][None], world)
    return clip_all, vs.cull_aabb(clip_all, args["aabb_min"],
                                  args["aabb_max"], args["finite"])


def _batch_vertex_products(plan: _FramePlan, args: dict, world, device):
    """Run every surface's vertex stage; returns
    [(surface index, batch, Triangles, valid bool[T], FragmentCtx|None)]
    in submission order."""
    out = []
    for s_i, batches in enumerate(plan.surfaces):
        clip_all, vis = _surface_visibility(args, world, s_i)
        for b_i, b in enumerate(batches):
            bargs = args["surfaces"][s_i]["batches"][b_i]
            dev = b.device_arrays[device]
            tris, tri_vis = _vertex_stage(b, bargs, dev,
                                          clip_all[dev["nodes"]],
                                          vis[dev["nodes"]])
            out.append((s_i, b, tris, tri_vis, _fragment_ctx(b, bargs)))
    return out


def _batch_segments(plan: _FramePlan, tris: rc.Triangles, valid, cull_mode,
                    table: sp.RecordTable, z_bias=None, base_index: int = 0,
                    cap: int = CLIP_CAPACITY):
    """Per-batch eye-plane clip (K4's straddler selection) and the K2
    segments of rows [base_index, base_index + T + 2*cap) of the pass's
    ``table``: the batch's records, then its appendee block; the id lane
    holds global submission ranks from ``base_index``, a record's row.
    Returns ([batch segment, appendee segment], clip overflow bool[])."""
    W, H = plan.width, plan.height
    T = tris.clip.shape[0]
    app_clip, app_vary, app_valid, _sel, overflow = rc.select_straddlers(
        tris.clip, tris.vary, valid, cap)
    return [sp.Segment(table, base_index, tris.clip, tris.vary, valid, W, H,
                       cull_mode, z_bias, tris.planar, base_index, tris.ids),
            sp.Segment(table, base_index + T, app_clip, app_vary, app_valid,
                       W, H, cull_mode, z_bias, False, base_index + T)
            ], overflow


def _batch_ids(plan: _FramePlan, cap: int) -> list:
    """(z bias, first id) of each batch in submission order: in the
    merged pass surface s of S takes the bias 2*(S-1-s) and each batch
    T + 2*cap global ranks; a sequential pass has no bias and ids from
    0."""
    S = len(plan.surfaces)
    out, base = [], 0
    for s_i, batches in enumerate(plan.surfaces):
        for b in batches:
            if not plan.merged:
                out.append((None, 0))
                continue
            out.append((2.0 * (S - 1 - s_i) if S > 1 else None, base))
            base += b.tri_count + 2 * cap
    return out


def _band_layout(plan: _FramePlan, device):
    """(y0, device) of each row band: one band on ``device`` without a
    mesh, else one per mesh row."""
    if plan.mesh is None:
        return [(0, device)]
    return [(k * _band_height(plan), d)
            for k, d in enumerate(plan.mesh.band_devices())]


def _band_height(plan: _FramePlan) -> int:
    return plan.height // (1 if plan.mesh is None else plan.mesh.shape["rows"])


def _band_fill(plan: _FramePlan, layout, value):
    """One [band, W] depth buffer of ``value`` per band of ``layout``."""
    return [torch.full((_band_height(plan), plan.width), value,
                       dtype=torch.float32, device=d) for _y0, d in layout]


def _band_clear(plan: _FramePlan, layout, color):
    band = _band_height(plan)
    return [color.to(d, non_blocking=True).expand(band, plan.width, 4)
            .clone() for _y0, d in layout]


def _raster_pass(plan: _FramePlan, layout, packed, valid, bbox, depth, fb,
                 ranges, flags):
    """Binning, K1 and shading of one raster pass over every band of
    ``layout`` (``depth`` and ``fb`` hold one tensor per band); each
    band's pair overflow flag goes to ``flags["pairs"]``. Returns (depth,
    fb, winner), one tensor per band each."""
    outs = raster.rasterize_bands(
        packed, valid, bbox, plan.width, plan.height,
        [(y0, d) for (y0, _dev), d in zip(layout, depth)],
        big_scale=plan.big_scale)
    fbs = []
    for (_d, w, num, den, ovf), f in zip(outs, fb):
        on_dev = [(s, e, fn, None if ctx is None else ctx.to(w.device))
                  for s, e, fn, ctx in ranges]
        fbs.append(raster.shade_from_planes_ranges(w, num, den, f, on_dev))
        flags["pairs"].append(ovf.to(packed.device, non_blocking=True))
    return [o[0] for o in outs], fbs, [o[1] for o in outs]


def _merged_pass(plan: _FramePlan, args: dict, products, layout, fb, cap,
                 flags, setup):
    """Every surface in one raster pass. ``products`` holds (surface
    index, batch, setup input, FragmentCtx|None) per batch, and
    ``setup(input, batch, z bias, first id, table)`` gives the K2
    segments of its T + 2*cap rows of the pass's record table, from the
    row of its first id, and its clip overflow; every batch's segments
    are then written by one :func:`sp.setup_pack_pass`. Returns (fb,
    winner), one tensor per band each (winner None without products)."""
    if plan.clear_flags and plan.clear_flags[0]:
        fb = _band_clear(plan, layout, args["surfaces"][0]["clear"])
    if not products:
        return fb, None
    S = len(plan.surfaces)
    # one table for the pass: a batch's rows start at its first id
    table = sp.new_table(sum(b.tri_count + 2 * cap for _s, b, _d, _c
                             in products), layout[0][1])
    ranges, segments = [], []
    for (s_i, b, data, fctx), (bias, base) in zip(products,
                                                   _batch_ids(plan, cap)):
        segs, overflow = setup(data, b, bias, base, table)
        segments += segs
        flags["clip"].append(overflow)
        end = base + b.tri_count + 2 * cap
        # adjacent batches sharing a ctx-free fragment program coalesce
        # into one shading range
        fn = b.pipeline.fragment_fn
        if (fctx is None and ranges and ranges[-1][2] is fn
                and ranges[-1][3] is None and ranges[-1][1] == base):
            ranges[-1] = (ranges[-1][0], end, fn, None)
        else:
            ranges.append((base, end, fn, fctx))
    sp.setup_pack_pass(segments)
    depth = _band_fill(plan, layout, 2.0 * (S - 1) + 1.0)
    _depth, fb, winner = _raster_pass(plan, layout, table.packed,
                                      table.valid, table.boxes, depth, fb,
                                      ranges, flags)
    return fb, winner


def _sequential_passes(plan: _FramePlan, args: dict, products, layout, fb,
                       cap, flags, setup):
    """One raster pass per batch, surface by surface (the reference's
    ``draw.py:509-547``), every band in each; ``products`` and ``setup``
    as in :func:`_merged_pass` (the oracle takes (Triangles, valid) as a
    batch's setup input). Returns (fb, [winner per pass]), one tensor per
    band each."""
    H, W = plan.height, plan.width
    products = iter(products)
    winners = []
    for s_i, batches in enumerate(plan.surfaces):
        if plan.clear_flags[s_i]:
            fb = _band_clear(plan, layout, args["surfaces"][s_i]["clear"])
        depth = _band_fill(plan, layout, 1.0)
        for b in batches:
            _s, _b, data, fctx = next(products)
            fn, cull = b.pipeline.fragment_fn, b.pipeline.cull_mode
            if plan.backend == "tile":
                rows = b.tri_count + 2 * cap
                table = sp.new_table(rows, layout[0][1])
                segments, ovf = setup(data, b, None, 0, table)
                sp.setup_pack_pass(segments)
                depth2, fb, winner = _raster_pass(
                    plan, layout, table.packed, table.valid, table.boxes,
                    depth, fb, [(0, rows, fn, fctx)], flags)
            else:
                # the oracle renders whole frames (a mesh needs the tile
                # backend): one band
                tris, v, ovf = rc.clip_near_capacity(*data, cap)
                tc = rc.triangle_setup(tris.clip, tris.vary, v, W, H, cull,
                                       planar=tris.planar, oracle=True)
                d, w = raster_ref.rasterize_visibility(
                    tc, H, W, depth=depth[0],
                    bbox=raster.viewport_bbox(tris.clip, W, H))
                fb = [raster_ref.shade(tc, w, fb[0], fn, ctx=fctx)]
                depth2, winner = [d], [w]
            flags["clip"].append(ovf)
            winners.append(winner)
            # a depth_write=False batch still tests its triangles against
            # each other (the documented deviation, pipeline.py)
            if b.pipeline.depth_write:
                depth = depth2
    return fb, winners


def _any(flags: list, device) -> torch.Tensor:
    if not flags:
        return torch.zeros((), dtype=torch.bool, device=device)
    return torch.stack(flags).any()


def _passes(plan: _FramePlan, args: dict, products, layout, cap, setup,
            device):
    """Every raster pass of a frame over the bands of ``layout``, on
    ``device``. Returns (fb, [winner per pass], overflow bool[2]), fb and
    each winner one tensor per band."""
    fb = args["fb"]           # one tensor a band; None when it clears
    flags = {"pairs": [], "clip": []}
    if plan.merged:
        fb, winner = _merged_pass(plan, args, products, layout, fb, cap,
                                  flags, setup)
        winners = [] if winner is None else [winner]
    else:
        fb, winners = _sequential_passes(plan, args, products, layout, fb,
                                         cap, flags, setup)
    overflow = torch.stack([_any(flags["pairs"], device),
                            _any(flags["clip"], device)])
    return fb, winners, overflow


def _frame(plan: _FramePlan, args: dict, device):
    """One frame without a mesh over device ``args``
    (:meth:`Draw._gather_args` with its host leaves on the device).
    Returns (fb f32[H, W, 4], winners tuple: one winner buffer per raster
    pass when ``plan.debug_winner``; overflow bool[2]: the pair
    capacity's lane and the clip capacity's, OR-ed over batches and
    passes). Reads nothing back to the host."""
    world = vs.compose_world_transforms(args["locals"],
                                        plan.level_index[device])
    products = [(s_i, b, (tris, valid), fctx) for s_i, b, tris, valid, fctx
                in _batch_vertex_products(plan, args, world, device)]
    cap = CLIP_CAPACITY * plan.big_scale

    def setup(data, b, bias, base, table):
        return _batch_segments(plan, *data, b.pipeline.cull_mode, table,
                               z_bias=bias, base_index=base, cap=cap)

    fb, winners, overflow = _passes(plan, args, products,
                                    _band_layout(plan, device), cap, setup,
                                    device)
    return (fb[0], tuple(w[0] for w in winners) if plan.debug_winner
            else (), overflow)


# --------------------------------------------------------------------------
# the frame on a mesh: the shards' pre-kernel stage, one all-gather a
# frame, the bands' raster stage
# --------------------------------------------------------------------------

def _shard_vertex_products(plan: _FramePlan, args: dict, world, device):
    """The vertex stage of every shard on ``device``: [(surface index,
    batch, [(shard k, Triangles, valid)])] in submission order. A
    per-vertex function runs on each shard's vertices; a whole-stream
    function runs once on the device over the batch's whole stream (it
    emits a permuted order), and each shard takes its rows of the result
    with their global ``ids``."""
    shards = [k for k, d in enumerate(plan.mesh.band_devices())
              if d == device]
    out = []
    for s_i, batches in enumerate(plan.surfaces):
        clip_all, vis = _surface_visibility(args, world, s_i)
        for b_i, b in enumerate(batches):
            bargs = args["surfaces"][s_i]["batches"][b_i]
            dev = b.device_arrays[device]
            clip_mats, inst_vis = clip_all[dev["nodes"]], vis[dev["nodes"]]
            whole = None
            pieces = []
            for k in shards:
                lo, hi = b.shards[k]
                if b.use_batch_fn:
                    if whole is None:
                        whole = _vertex_stage(b, bargs, dev, clip_mats,
                                              inst_vis)
                    t, v = whole
                    tris = rc.Triangles(t.clip[lo:hi], t.vary[lo:hi],
                                        t.ids[lo:hi], t.planar)
                    valid = v[lo:hi]
                elif lo == hi:
                    z = torch.zeros((0, 3, 4), device=device)
                    tris = rc.Triangles(z, z)
                    valid = torch.zeros(0, dtype=torch.bool, device=device)
                else:
                    tris, valid = _vertex_stage(b, bargs, dev, clip_mats,
                                                inst_vis, (lo, hi))
                pieces.append((k, tris, valid))
            out.append((s_i, b, pieces))
    return out


def _shard_setup(plan: _FramePlan, b: _BatchPlan, tris: rc.Triangles, valid,
                 lo: int, bias, base: int, cap: int):
    """A shard's part of :func:`_batch_segments`: its straddler
    candidates, and the K2 segment of its triangles (ids from ``base``; a
    permuted producer's ``ids`` are global) into a table of its own rows.
    Returns (piece, segment): the piece holds the candidates and the
    table's tensors, written once the segment's pass has run; the shard
    holding the batch's last triangle also gives its row."""
    table = sp.new_table(tris.clip.shape[0], tris.clip.device)
    segment = sp.Segment(table, 0, tris.clip, tris.vary, valid, plan.width,
                         plan.height, b.pipeline.cull_mode, bias, tris.planar,
                         base + (lo if tris.ids is None else 0), tris.ids)
    piece = {
        "cand": rc.straddler_candidates(tris.clip, tris.vary, valid, cap, lo,
                                        b.tri_count),
        "packed": table.packed, "valid": table.valid, "bbox": table.bbox,
    }
    if lo < b.tri_count == lo + tris.clip.shape[0]:
        piece["last"] = (tris.clip[-1:], tris.vary[-1:])
    return piece, segment


def _shard_stage(plan: _FramePlan, args: dict, device) -> dict:
    """The pre-kernel stage of a mesh frame on one of its devices: for
    every batch, the vertex stage, straddler candidates, setup, pack and
    boxes of each shard on ``device``, every shard's rows written by one
    :func:`sp.setup_pack_pass`. Returns {(batch, shard): piece}. Reads
    nothing back to the host and touches no other device."""
    world = vs.compose_world_transforms(args["locals"],
                                        plan.level_index[device])
    cap = CLIP_CAPACITY * plan.big_scale
    out, segments = {}, []
    products = _shard_vertex_products(plan, args, world, device)
    for g, ((_s, b, pieces), (bias, base)) in enumerate(
            zip(products, _batch_ids(plan, cap))):
        for k, tris, valid in pieces:
            out[g, k], segment = _shard_setup(plan, b, tris, valid,
                                              b.shards[k][0], bias, base, cap)
            segments.append(segment)
    sp.setup_pack_pass(segments)
    return out


def _mesh_setup(plan: _FramePlan, pieces: dict, g: int, b: _BatchPlan,
                bias, base: int, cap: int, table: sp.RecordTable):
    """:func:`_batch_segments` for batch ``g`` from its shards' pieces,
    all on one device, into rows [base, base + T + 2*cap) of ``table``:
    the shards' rows copied in shard order, then the straddlers merged
    (``rc.merge_straddlers``) and clipped into the appendee block's K2
    segment. Bit for bit the table of one device once the pass's segments
    are written. Returns ([appendee segment], clip overflow)."""
    parts = [pieces[g, k] for k in range(len(b.shards))]
    for (lo, hi), p in zip(b.shards, parts):
        table.packed[base + lo:base + hi] = p["packed"]
        table.valid[base + lo:base + hi] = p["valid"]
        table.bbox[:, base + lo:base + hi] = p["bbox"]
    last = next(p["last"] for p in parts if "last" in p)
    app_clip, app_vary, app_valid, _sel, overflow = rc.merge_straddlers(
        [p["cand"] for p in parts], *last, cap, b.tri_count)
    return [sp.Segment(table, base + b.tri_count, app_clip, app_vary,
                       app_valid, plan.width, plan.height,
                       b.pipeline.cull_mode, bias, False,
                       base + b.tri_count)], overflow


def _band_stage(plan: _FramePlan, args: dict, pieces: dict, device):
    """The raster stage of a mesh frame on one of its devices: every
    raster pass over the bands on ``device``, each from the records of
    every shard (``pieces``, gathered to ``device``). Returns (fb,
    [winner per pass], overflow bool[2]), fb and each winner one tensor
    per band on ``device``."""
    cap = CLIP_CAPACITY * plan.big_scale
    products = []
    for s_i, batches in enumerate(plan.surfaces):
        for b_i, b in enumerate(batches):
            products.append((s_i, b, len(products), _fragment_ctx(
                b, args["surfaces"][s_i]["batches"][b_i])))

    def setup(g, b, bias, base, table):
        return _mesh_setup(plan, pieces, g, b, bias, base, cap, table)

    layout = [(y0, d) for y0, d in _band_layout(plan, device) if d == device]
    return _passes(plan, args, products, layout, cap, setup, device)


def _mesh_outputs(plan: _FramePlan, outs: list):
    """The frame from each device's :func:`_band_stage` result (in
    ``plan.devices`` order): (fb :class:`Banded`, winners tuple of
    :class:`Banded` when ``plan.debug_winner``, overflow bool[2] on the
    first band's device)."""
    by_dev = dict(zip(plan.devices, outs))
    seen = dict.fromkeys(plan.devices, 0)
    order = []
    for d in plan.mesh.band_devices():
        order.append((d, seen[d]))
        seen[d] += 1
    fb = Banded(by_dev[d][0][i] for d, i in order)
    winners = ()
    if plan.debug_winner:
        winners = tuple(Banded(by_dev[d][1][p][i] for d, i in order)
                        for p in range(len(outs[0][1])))
    first = plan.devices[0]
    overflow = torch.stack([o[2].to(first, non_blocking=True)
                            for o in outs]).any(0)
    return fb, winners, overflow


def _mesh_stages(plan: _FramePlan):
    """(shard stage, band stage, outputs) of a mesh frame, as
    ``compiled.CompiledMeshFrame`` captures them."""
    return (functools.partial(_shard_stage, plan),
            functools.partial(_band_stage, plan),
            functools.partial(_mesh_outputs, plan))


def _mesh_frame(plan: _FramePlan, views: list):
    """One mesh frame, eagerly: ``views`` holds each distinct device's
    arguments (``plan.devices`` order, host leaves on the device). The
    shards' stage on every device, the all-gather, the bands' stage on
    every device; same results as :func:`_frame` on one device, bands
    and all. Reads nothing back to the host."""
    pieces = [_shard_stage(plan, v, d) for v, d in zip(views, plan.devices)]
    return _mesh_outputs(plan, [
        _band_stage(plan, v, all_gather(pieces, d), d)
        for v, d in zip(views, plan.devices)])


class _QueuedFlag:
    """A frame's overflow flag on its way to the host: on a card, an
    asynchronous copy to pinned memory and an event after it."""

    def __init__(self, flag: torch.Tensor):
        self.event = None
        self.host = flag
        if flag.device.type == "cuda":
            self.host = torch.empty(flag.shape, dtype=flag.dtype,
                                    pin_memory=True)
            self.host.copy_(flag, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(flag.device))

    def is_ready(self) -> bool:
        return self.event is None or self.event.query()

    def __array__(self, dtype=None, copy=None):
        if self.event is not None:
            self.event.synchronize()
        a = self.host.numpy()
        return a if dtype is None else a.astype(dtype)


# --------------------------------------------------------------------------
# Draw object (public API)
# --------------------------------------------------------------------------

class Draw:
    # Worst-case number of published frames that can drop triangles
    # after a capacity overflow in the default (asynchronously polled)
    # mode: the queue of flags is force-drained (a blocking read) beyond
    # this many. The synchronous window after a (re)build and
    # Renderer.strict_overflow give the zero-dropped-frames guarantee.
    # frame_stats reports it as "overflow_risk_frames".
    OVERFLOW_WINDOW = 8

    def __init__(self, renderer):
        self.renderer = renderer
        self._items: list = []
        self._clear: Optional[np.ndarray] = None
        self._plans: dict = {}
        self._bounds_cache = {}           # device -> bounds tensors
        self._bounds_cache_key = None
        self._last_end_time = None
        # multiplier of the clip and pair capacities, raised x4 when a
        # frame outgrows them and never lowered (the reference's sticky
        # big_scale)
        self.big_scale = 1
        self._frames_since_rebuild = 0
        self._pending_overflow: list = []      # _QueuedFlag, oldest first
        self._warmed: set = set()
        # private: run every frame eagerly, without a CUDA graph (for
        # chip_smoke.py's comparisons; not public API)
        self._eager_frames = False
        self.last_overflow = None
        self.last_winners = ()
        self.id = renderer._register(renderer.draws, self)

    @staticmethod
    def create(renderer) -> "Draw":
        """``Draw.create`` (``Draw.zig:37-39``)."""
        return Draw(renderer)

    def begin(self) -> None:
        self._items = []
        self._clear = None

    def clear(self, color) -> None:
        """Stage a clear color for the next drawn surface
        (``Draw.zig:19-21``)."""
        c = np.asarray(color, np.float32).reshape(-1)
        if c.size == 3:
            c = np.append(c, np.float32(1.0))
        self._clear = c

    def draw_surface(self, surface) -> None:
        """``Draw.zig:23-27`` with a working per-frame dedupe."""
        if surface.frame_counter == self.renderer.frame_counter:
            return
        surface.frame_counter = self.renderer.frame_counter
        self._items.append((surface, self._clear))
        self._clear = None

    def end(self):
        """Run the frame (``Draw.zig:29-34``) and publish the new
        framebuffer to the window.

        Capacity (the reference's ``draw.py:646-678``): right after a
        (re)build, and every frame under ``Renderer.strict_overflow``,
        the frame's overflow flag is read synchronously (one host sync);
        otherwise it is queued and polled without blocking, and the
        queue is force-drained beyond ``OVERFLOW_WINDOW`` flags. A set
        flag raises ``big_scale`` x4 (up to ``BIG_SCALE_MAX``) and the
        detecting frame is rendered again before it publishes."""
        rend = self.renderer
        window = rend.window
        if window is None:
            raise RuntimeError("renderer has not adopted a window")
        if not self._items:
            return window.framebuffer
        plan = self._get_plan(window)
        args = self._gather_args(plan, window)
        fb, winners, overflow = self._run(plan, args)
        overflow_risk = 0      # frames that may publish drops undetected
        if self.big_scale >= BIG_SCALE_MAX:
            # the ladder is capped: flags go unchecked, and a scene that
            # still overflows drops triangles without bound
            overflow_risk = -1
        else:
            if self._frames_since_rebuild < 3 or rend.strict_overflow:
                self._frames_since_rebuild = min(
                    self._frames_since_rebuild + 1, 3)
                need_rebuild = bool(overflow.any())
            else:
                need_rebuild = self._poll_overflow_queue()
                overflow_risk = self.OVERFLOW_WINDOW
            while need_rebuild and self.big_scale < BIG_SCALE_MAX:
                self.big_scale *= 4
                # the lower rungs' plans (and graphs) are never used again
                self._plans = {k: p for k, p in self._plans.items()
                               if p.big_scale >= self.big_scale}
                plan = self._get_plan(window)
                fb, winners, overflow = self._run(plan, args)
                # queued flags described the old capacities
                self._pending_overflow = []
                self._frames_since_rebuild = 1
                need_rebuild = bool(overflow.any())
            if not rend.strict_overflow:
                self._pending_overflow.append(_QueuedFlag(overflow))
            self._maybe_warm_next_capacity(window)
        self.last_overflow = overflow
        self.last_winners = winners
        window.framebuffer = fb
        if rend.collect_stats:
            now = time.perf_counter()
            last, self._last_end_time = self._last_end_time, now
            batches = [b for s in plan.surfaces for b in s]
            rend.frame_stats = {
                "frame": rend.frame_counter,
                "surfaces": len(plan.surfaces),
                "batches": len(batches),
                "triangles_submitted": sum(b.tri_count for b in batches),
                "ms_since_last_end": (None if last is None
                                      else (now - last) * 1000.0),
                "backend": plan.backend,
                # straddler slots per batch are 2 * CLIP_CAPACITY * this
                "big_scale": self.big_scale,
                # one raster pass for the whole frame (a frame of one
                # batch counts, unlike the reference's flag)
                "merged": plan.merged,
                "fragment_programs": len({b.pipeline.fragment_fn
                                          for b in batches}),
                # published frames that can drop triangles before an
                # overflow is detected: 0 checked synchronously, -1 at
                # the top of the ladder (unchecked)
                "overflow_risk_frames": overflow_risk,
            }
        return fb

    def _capturable(self, plan: _FramePlan) -> bool:
        """A frame on cards runs as CUDA graph replays: one graph on the
        renderer's card, or the segments of a mesh frame on each of its
        cards; the oracle runs eagerly, as the CPU does."""
        return (plan.backend == "tile"
                and all(d.type == "cuda" for d in plan.devices))

    def _eager(self, plan: _FramePlan, args: dict):
        dev = self.renderer.device
        if plan.mesh is None:
            return _frame(plan, device_args(args, dev), dev)
        return _mesh_frame(plan, [device_args(v, d) for v, d
                                  in zip(args["views"], plan.devices)])

    def _capture(self, plan: _FramePlan, args: dict):
        """Capture ``plan``'s frame: (its CompiledFrame or
        CompiledMeshFrame, the warm-up frame's outputs)."""
        dev = self.renderer.device
        if plan.mesh is None:
            return CompiledFrame.capture(
                functools.partial(_frame, plan, device=dev), args, dev)
        return CompiledMeshFrame.capture(_mesh_stages(plan), args,
                                         plan.devices)

    def _run(self, plan: _FramePlan, args: dict):
        """(fb, winners, overflow) of one frame: a replay of the plan's
        CUDA graph(s), captured (after an eager warm-up, whose frame
        this returns) at the plan's first frame; an eager frame where no
        graph is taken."""
        if self._eager_frames or not self._capturable(plan):
            return self._eager(plan, args)
        if plan.compiled is None:
            plan.compiled, out = self._capture(plan, args)
            return out
        return plan.compiled.replay(args)

    def _maybe_warm_next_capacity(self, window) -> None:
        """``Renderer.precompile_capacity_bump``: make the next rung's
        plan and capture its CUDA graph(s) now, so that an overflow
        re-renders against a ready graph. Captured here, at the end of
        ``end`` on the calling thread (see the Renderer option)."""
        rend = self.renderer
        if not rend.precompile_capacity_bump:
            return
        nxt = self.big_scale * 4
        key = (rend.scene_version, nxt)
        if nxt > BIG_SCALE_MAX or key in self._warmed:
            return
        self._warmed.add(key)
        plan = self._get_plan(window, big_scale=nxt)
        if (plan.compiled is None and not self._eager_frames
                and self._capturable(plan)):
            plan.compiled, _out = self._capture(
                plan, self._gather_args(plan, window))

    def _poll_overflow_queue(self) -> bool:
        """Consume the queued overflow flags that have reached the host,
        oldest first; block only while the queue holds
        ``OVERFLOW_WINDOW`` flags (bounding both memory and detection
        latency). Returns True when a consumed flag is set."""
        hit = False
        q = self._pending_overflow
        while q:
            if not q[0].is_ready() and len(q) < self.OVERFLOW_WINDOW:
                break
            hit |= bool(np.asarray(q.pop(0)).any())
        return hit

    def _resolve_backend(self) -> str:
        name = self.renderer.raster_backend
        if name not in BACKENDS:
            raise ValueError(f"unknown raster backend {name!r}; expected "
                             f"one of {sorted(BACKENDS)}")
        return BACKENDS[name]

    def _get_plan(self, window, big_scale=None) -> _FramePlan:
        """The frame plan of the current draw items at ``big_scale``
        (default the Draw's), built on a miss. A new plan at the Draw's
        own scale re-arms the synchronous overflow checks and drops the
        queued flags; one made ahead of time for the next rung
        (``big_scale`` given) does not."""
        rend = self.renderer
        backend = self._resolve_backend()
        warm = big_scale is not None
        big_scale = self.big_scale if big_scale is None else big_scale
        # a surface whose window was resized (Core.resize_window) bumps
        # the scene version here, before the key is made: one new plan
        for s, _ in self._items:
            s.rebuild()
        key = (rend.scene_version, window.id,
               tuple(s.id for s, _ in self._items),
               tuple(c is not None for _, c in self._items),
               window.width, window.height, backend, rend.debug_winner,
               big_scale)
        plan = self._plans.get(key)
        if plan is not None:
            return plan
        if not warm:
            self._frames_since_rebuild = 0
            self._pending_overflow = []
        parents, levels = _build_levels(rend.scene_nodes)
        surfaces = []
        for s, _ in self._items:
            if s.window is not window:
                raise ValueError("surface targets a different window")
            surfaces.append(_build_batches(s))
        mesh = rend.mesh
        if mesh is not None:
            if backend != "tile":
                raise ValueError(
                    "row-band rendering (Renderer mesh=...) requires the "
                    "tile backend (raster_backend=\"auto\")")
            if "rows" not in mesh.axis_names:
                raise ValueError("renderer mesh needs a 'rows' axis")
            if window.height % mesh.shape["rows"]:
                raise ValueError(
                    f"window height {window.height} not divisible by "
                    f"mesh rows {mesh.shape['rows']}")
        devices = ([rend.device] if mesh is None
                   else list(dict.fromkeys(mesh.band_devices())))
        for batches in surfaces:
            for b in batches:
                b.device_arrays = {d: _batch_device_arrays(b, d)
                                   for d in devices}
                if mesh is not None:
                    b.shards = shard_ranges(b.tri_count, mesh.shape["rows"])
        plan = _FramePlan(
            surfaces=surfaces,
            clear_flags=tuple(c is not None for _, c in self._items),
            width=window.width, height=window.height, backend=backend,
            debug_winner=rend.debug_winner, mesh=mesh, big_scale=big_scale,
            devices=devices,
            level_index={d: vs.level_indices(levels, parents, d)
                         for d in devices})
        plan.merged = _mergeable(plan)
        # the scene version only grows: a plan of an older one is never
        # used again, and on a card it holds a CUDA graph and its pool
        self._plans = {k: p for k, p in self._plans.items()
                       if k[0] == rend.scene_version}
        if len(self._plans) >= PLAN_CACHE_SIZE:
            del self._plans[next(iter(self._plans))]
        self._plans[key] = plan
        return plan

    def _gather_args(self, plan: _FramePlan, window) -> dict:
        """The frame's arguments: host leaves (numpy f32: node
        transforms, perspectives, clear colours) and device tensors
        (bounds, cached by version; vertex buffers and bindings, cached
        by their versions; the incoming framebuffer, one tensor a band,
        None when the first surface clears). On a mesh, ``views`` holds
        these once per distinct device of ``plan.devices``, each with
        its device tensors on that device (every vertex buffer the
        frame reads, of which each shard reads its rows) and the bands
        of that device."""
        rend = self.renderer
        if plan.mesh is None:
            fb = None if plan.clear_flags[0] else [window.framebuffer]
            return self._device_args(plan, rend.device, fb)
        bands = [None] * len(plan.devices)
        if not plan.clear_flags[0]:
            layout = _band_layout(plan, rend.device)
            split = split_bands(window.framebuffer, [d for _y0, d in layout])
            bands = [[f for f, (_y0, b) in zip(split, layout) if b == d]
                     for d in plan.devices]
        return {"views": [self._device_args(plan, d, fb)
                          for d, fb in zip(plan.devices, bands)]}

    def _device_args(self, plan: _FramePlan, dev, fb) -> dict:
        rend = self.renderer
        nodes = rend.scene_nodes
        key = (rend.scene_version, rend.bounds_version)
        if self._bounds_cache_key != key:
            self._bounds_cache = {}
            self._bounds_cache_key = key
        if dev not in self._bounds_cache:
            aabb_min = np.stack([np.nan_to_num(n.bounding_box_p0,
                                               neginf=-1e30, posinf=1e30)
                                 for n in nodes]).astype(np.float32)
            aabb_max = np.stack([np.nan_to_num(n.bounding_box_p1,
                                               neginf=-1e30, posinf=1e30)
                                 for n in nodes]).astype(np.float32)
            finite = np.array([n.has_finite_aabb for n in nodes], bool)
            self._bounds_cache[dev] = (torch.from_numpy(aabb_min).to(dev),
                                       torch.from_numpy(aabb_max).to(dev),
                                       torch.from_numpy(finite).to(dev))
        aabb_min, aabb_max, finite = self._bounds_cache[dev]

        surfaces = []
        for (surface, clear), sbatches in zip(self._items, plan.surfaces):
            batches = []
            for b in sbatches:
                vbs = [inst.vertex_buffer.device_array(dev)
                       for inst in b.instances
                       if inst.vertex_buffer.has_buffer]
                bindings = {loc: [inst.binding_device_array(loc, dev)
                                  for inst in b.instances]
                            for loc in b.binding_locs}
                batches.append({"vbs": vbs, "bindings": bindings})
            c = clear if clear is not None else np.zeros(4, np.float32)
            surfaces.append({
                "persp": np.asarray(surface.perspective_matrix, np.float32),
                "clear": c.astype(np.float32),
                "batches": batches,
            })
        return {
            "fb": fb,
            "locals": np.stack([n.xform for n in nodes]).astype(np.float32),
            "aabb_min": aabb_min,
            "aabb_max": aabb_max,
            "finite": finite,
            "surfaces": surfaces,
        }
