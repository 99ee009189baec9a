"""Draw: frame composition and the frame program (torch).

Port of ``myrenderer_tpu/renderer/draw.py``. Mirrors
``Renderer/Draw.zig``'s API (begin / clear / draw_surface / end). A
frame is a function of its arguments (:func:`_frame`): scene transform
composition, culling, the vertex stage, per-batch eye-plane clip +
setup, raster passes (K1 on the card) and shading. Its shapes are
static and it reads nothing back to the host; it returns the
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
rows, one per mesh row, each on its device. The pre-kernel stage (vertex
stage, clip, setup, pack) runs once on the mesh's first device; each
raster pass then sends the records to every band's device and runs
binning, K1 and shading band by band. A band is bit-identical to the
same rows of a single-device frame. The framebuffer and
``last_winners`` stay banded (``parallel.Banded``); a frame with no
clear loads the previous frame's bands.

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

The CUDA graph (``compiled.CompiledFrame``): one per plan and rung, on
one card (a mesh whose bands all lie on that card included); a mesh
over several cards and the oracle backend run the same frame eagerly,
as the CPU does. A vertex or fragment function runs once, at capture,
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
from ..ops import vertex_stage as vs
from ..parallel.sharding import Banded, split_bands
from .compiled import CompiledFrame, device_args
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
    device_arrays: Optional[dict] = None


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
    # the scene's levels as device index pairs (vs.level_indices)
    level_index: Optional[list] = None
    compiled: Optional[CompiledFrame] = None


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


def _batch_vertex_products(plan: _FramePlan, args: dict, world, device):
    """Run every surface's vertex stage; returns
    [(surface index, batch, Triangles, valid bool[T], FragmentCtx|None)]
    in submission order."""
    out = []
    for s_i, batches in enumerate(plan.surfaces):
        sargs = args["surfaces"][s_i]
        # per-node clip matrices and conservative visibility, each node
        # against its OWN box under its own composed transform
        clip_all = vs.matmul4(sargs["persp"][None], world)
        vis = vs.cull_aabb(clip_all, args["aabb_min"], args["aabb_max"],
                           args["finite"])
        for b_i, b in enumerate(batches):
            bargs = sargs["batches"][b_i]
            dev = b.device_arrays
            clip_mats = clip_all[dev["nodes"]]
            inst_vis = vis[dev["nodes"]]
            attrs = {}
            if b.attr_offsets:
                rows = [bargs["vbs"][ordinal][fv:fv + count]
                        for ordinal, fv, count in b.rowspec]
                packed = torch.cat(rows, 0) if len(rows) > 1 else rows[0]
                attrs = {name: packed[:, off:off + wdt]
                         for name, (off, wdt) in b.attr_offsets.items()}
            bindings = {loc: torch.stack(arrs) if len(arrs) > 1
                        else arrs[0][None]
                        for loc, arrs in bargs["bindings"].items()}
            fctx = None
            if b.pipeline.fragment_uses_ctx:
                fctx = vs.FragmentCtx({loc: arrs[0] for loc, arrs
                                       in bargs["bindings"].items()})

            tris = vs.run_vertex_stage(
                b.pipeline.vertex_fn, dev["vidx"], attrs, clip_mats,
                dev["iids"], bindings,
                vertex_batch_fn=(b.pipeline.vertex_batch_fn
                                 if b.use_batch_fn else None),
                draw_instances=dev["dinst"])
            if tris.vary.shape[-1] != 4:
                raise ValueError(
                    f"vertex function "
                    f"{getattr(b.pipeline.vertex_fn, '__name__', '?')!r}"
                    f" emitted {tris.vary.shape[-1]} varying channels; the "
                    "fragment contract is exactly 4 (the reference's "
                    "FragPass vec4, Pipeline.zig:12-32) — pack unused "
                    "channels with zeros")
            tri_vis = inst_vis[dev["tri_iid"]]
            if tris.ids is not None:
                # permuted producers: slot k holds submission rank ids[k]
                tri_vis = tri_vis[tris.ids.long()]
            out.append((s_i, b, tris, tri_vis, fctx))
    return out


def _setup_batch(plan: _FramePlan, tris: rc.Triangles, valid, cull_mode,
                 z_bias=None, base_index: int = 0,
                 cap: int = CLIP_CAPACITY):
    """Per-batch eye-plane clip + triangle setup + record pack + viewport
    bbox. Returns (packed f32[T + 2*cap, 32], valid, bbox, clip overflow
    bool[]); the id lane holds global submission ranks from
    ``base_index``."""
    W, H = plan.width, plan.height
    app_clip, app_vary, app_valid, _sel, overflow = rc.select_straddlers(
        tris.clip, tris.vary, valid, cap)
    T = tris.clip.shape[0]
    tc = rc.triangle_setup(tris.clip, tris.vary, valid, W, H, cull_mode,
                           z_bias=z_bias, planar=tris.planar)
    tc_app = rc.triangle_setup(app_clip, app_vary, app_valid, W, H,
                               cull_mode, z_bias=z_bias)
    packed = torch.cat([
        rc.pack_coeffs_full(tc, base=base_index, ids=tris.ids),
        rc.pack_coeffs_full(tc_app, base=base_index + T)])
    bbox = tuple(torch.cat(c) for c in zip(
        raster.viewport_bbox(tris.clip, W, H),
        raster.viewport_bbox(app_clip, W, H)))
    return packed, torch.cat([tc.valid, tc_app.valid]), bbox, overflow


def _band_layout(plan: _FramePlan, device):
    """(y0, device) of each row band: one band on ``device`` without a
    mesh, else one per mesh row."""
    if plan.mesh is None:
        return [(0, device)]
    devices = plan.mesh.band_devices()
    band = plan.height // len(devices)
    return [(k * band, d) for k, d in enumerate(devices)]


def _band_fill(plan: _FramePlan, layout, value):
    """One [band, W] depth buffer of ``value`` per band."""
    band = plan.height // len(layout)
    return [torch.full((band, plan.width), value, dtype=torch.float32,
                       device=d) for _y0, d in layout]


def _band_clear(plan: _FramePlan, layout, color):
    band = plan.height // len(layout)
    return [color.to(d, non_blocking=True).expand(band, plan.width, 4)
            .clone() for _y0, d in layout]


def _raster_pass(plan: _FramePlan, layout, packed, valid, bbox, depth, fb,
                 ranges, flags):
    """Binning, K1 and shading of one raster pass over every band
    (``depth`` and ``fb`` hold one tensor per band); each band's pair
    overflow flag goes to ``flags["pairs"]``. Returns (depth, fb,
    winner), one tensor per band each."""
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
                 flags):
    """Every surface in one raster pass. Returns (fb, winner), one tensor
    per band each (winner None without products)."""
    if plan.clear_flags and plan.clear_flags[0]:
        fb = _band_clear(plan, layout, args["surfaces"][0]["clear"])
    if not products:
        return fb, None
    S = len(plan.surfaces)
    packs, valids, bboxes, ranges = [], [], [], []
    base = 0
    for s_i, b, tris, valid, fctx in products:
        bias = 2.0 * (S - 1 - s_i) if S > 1 else None
        packed, v, bbox, ovf = _setup_batch(plan, tris, valid,
                                            b.pipeline.cull_mode,
                                            z_bias=bias, base_index=base,
                                            cap=cap)
        flags["clip"].append(ovf)
        packs.append(packed)
        valids.append(v)
        bboxes.append(bbox)
        end = base + packed.shape[0]
        # adjacent batches sharing a ctx-free fragment program coalesce
        # into one shading range
        fn = b.pipeline.fragment_fn
        if (fctx is None and ranges and ranges[-1][2] is fn
                and ranges[-1][3] is None and ranges[-1][1] == base):
            ranges[-1] = (ranges[-1][0], end, fn, None)
        else:
            ranges.append((base, end, fn, fctx))
        base = end
    packed = torch.cat(packs)
    valid = torch.cat(valids)
    bbox = tuple(torch.cat(cs) for cs in zip(*bboxes))
    depth = _band_fill(plan, layout, 2.0 * (S - 1) + 1.0)
    _depth, fb, winner = _raster_pass(plan, layout, packed, valid, bbox,
                                      depth, fb, ranges, flags)
    return fb, winner


def _sequential_passes(plan: _FramePlan, args: dict, products, layout, fb,
                       cap, flags):
    """One raster pass per batch, surface by surface (the reference's
    ``draw.py:509-547``), every band in each. Returns (fb, [winner per
    pass]), one tensor per band each."""
    H, W = plan.height, plan.width
    products = iter(products)
    winners = []
    for s_i, batches in enumerate(plan.surfaces):
        if plan.clear_flags[s_i]:
            fb = _band_clear(plan, layout, args["surfaces"][s_i]["clear"])
        depth = _band_fill(plan, layout, 1.0)
        for b in batches:
            _s, _b, tris, valid, fctx = next(products)
            fn, cull = b.pipeline.fragment_fn, b.pipeline.cull_mode
            if plan.backend == "tile":
                packed, v, bbox, ovf = _setup_batch(plan, tris, valid, cull,
                                                    cap=cap)
                depth2, fb, winner = _raster_pass(
                    plan, layout, packed, v, bbox, depth, fb,
                    [(0, packed.shape[0], fn, fctx)], flags)
            else:
                # the oracle renders whole frames (a mesh needs the tile
                # backend): one band
                tris, v, ovf = rc.clip_near_capacity(tris, valid, cap)
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


def _frame(plan: _FramePlan, args: dict, device):
    """One frame over device ``args`` (:meth:`Draw._gather_args` with its
    host leaves on the device). Returns (fb f32[H, W, 4], winners tuple:
    one winner buffer per raster pass when ``plan.debug_winner``, each a
    :class:`Banded` on a mesh; overflow bool[2]: the pair capacity's
    lane and the clip capacity's, OR-ed over batches, passes and
    bands). Reads nothing back to the host."""
    world = vs.compose_world_transforms(args["locals"], plan.level_index)
    products = _batch_vertex_products(plan, args, world, device)
    cap = CLIP_CAPACITY * plan.big_scale
    layout = _band_layout(plan, device)
    fb = args["fb"]           # one tensor a band; None when it clears
    flags = {"pairs": [], "clip": []}
    if plan.merged:
        fb, winner = _merged_pass(plan, args, products, layout, fb, cap,
                                  flags)
        winners = [] if winner is None else [winner]
    else:
        fb, winners = _sequential_passes(plan, args, products, layout, fb,
                                         cap, flags)
    overflow = torch.stack([_any(flags["pairs"], device),
                            _any(flags["clip"], device)])

    def frame(bands):
        return bands[0] if plan.mesh is None else Banded(bands)

    return (frame(fb), (tuple(frame(w) for w in winners)
                        if plan.debug_winner else ()), overflow)


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
        self._bounds_cache = None
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
        """A frame runs as a CUDA graph on a card, its bands (if any) on
        the renderer's card; the oracle and a mesh over several cards run
        eagerly."""
        dev = self.renderer.device
        return (dev.type == "cuda" and plan.backend == "tile"
                and (plan.mesh is None
                     or set(plan.mesh.band_devices()) == {dev}))

    def _run(self, plan: _FramePlan, args: dict):
        """(fb, winners, overflow) of one frame: a replay of the plan's
        CUDA graph, captured (after an eager warm-up, whose frame this
        returns) at the plan's first frame; an eager frame where no graph
        is taken."""
        dev = self.renderer.device
        if self._eager_frames or not self._capturable(plan):
            return _frame(plan, device_args(args, dev), dev)
        if plan.compiled is None:
            plan.compiled, out = CompiledFrame.capture(
                functools.partial(_frame, plan, device=dev), args, dev)
            return out
        return plan.compiled.replay(args)

    def _maybe_warm_next_capacity(self, window) -> None:
        """``Renderer.precompile_capacity_bump``: make the next rung's
        plan and capture its CUDA graph now, so that an overflow
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
            dev = rend.device
            plan.compiled, _out = CompiledFrame.capture(
                functools.partial(_frame, plan, device=dev),
                self._gather_args(plan, window), dev)

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
        for batches in surfaces:
            for b in batches:
                b.device_arrays = _batch_device_arrays(b, rend.device)
        plan = _FramePlan(
            surfaces=surfaces,
            clear_flags=tuple(c is not None for _, c in self._items),
            width=window.width, height=window.height, backend=backend,
            debug_winner=rend.debug_winner, mesh=mesh, big_scale=big_scale,
            level_index=vs.level_indices(levels, parents, rend.device))
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
        None when the first surface clears)."""
        rend = self.renderer
        dev = rend.device
        nodes = rend.scene_nodes
        key = (rend.scene_version, rend.bounds_version, dev)
        if self._bounds_cache_key != key:
            aabb_min = np.stack([np.nan_to_num(n.bounding_box_p0,
                                               neginf=-1e30, posinf=1e30)
                                 for n in nodes]).astype(np.float32)
            aabb_max = np.stack([np.nan_to_num(n.bounding_box_p1,
                                               neginf=-1e30, posinf=1e30)
                                 for n in nodes]).astype(np.float32)
            finite = np.array([n.has_finite_aabb for n in nodes], bool)
            self._bounds_cache = (torch.from_numpy(aabb_min).to(dev),
                                  torch.from_numpy(aabb_max).to(dev),
                                  torch.from_numpy(finite).to(dev))
            self._bounds_cache_key = key
        aabb_min, aabb_max, finite = self._bounds_cache

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
        fb = None
        if not plan.clear_flags[0]:
            fb = ([window.framebuffer] if plan.mesh is None else
                  split_bands(window.framebuffer,
                              [d for _y0, d in _band_layout(plan, dev)]))
        return {
            "fb": fb,
            "locals": np.stack([n.xform for n in nodes]).astype(np.float32),
            "aabb_min": aabb_min,
            "aabb_max": aabb_max,
            "finite": finite,
            "surfaces": surfaces,
        }
