"""Profiling helpers: a ``torch.profiler`` trace around a block, and
rolling frame-time statistics.

Port of ``myrenderer_tpu/utils/profiling.py``; the trace is PyTorch's
(Chrome trace format) in place of ``jax.profiler``'s.

Below them, the measuring and checking code that ``chip_smoke.py`` and
``bench_torch.py`` share, so that each number is read one way: fences
(``sync_all``), K1's inputs and its bound (``capture_k1_inputs``,
``trimmed``, ``edge_hits``, ``k1_bound``), the profiler's device time
by kernel group (``profile_frames``, ``GROUPS``), host syncs a frame
(``syncs_per_frame``), and the frame checks (``frames_equal``,
``assert_no_flags``, ``oracle_frame``); K4's and K5's graph-replay
checks (``k4_graph_replays``, ``k5_graph_replays``), which
``chip_smoke.py`` and the card's tests share.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
import warnings

import numpy as np

# the repository's root: traces go under its build/ (gitignored), and
# host syncs are named by their path from here
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (host, and the card where CUDA is available)
    and write ``trace.json`` (Chrome trace; open it in Perfetto) into
    ``log_dir``. Yields the ``torch.profiler.profile`` object, whose
    ``key_averages()`` sums time by operator and kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class FrameTimer:
    """Rolling frame-time stats (host wall clock; the caller fences each
    tick, e.g. with ``torch.cuda.synchronize()``)."""

    def __init__(self, window: int = 120):
        self.window = window
        self.samples: list[float] = []
        self._last = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self.samples.append(now - self._last)
            if len(self.samples) > self.window:
                self.samples.pop(0)
        self._last = now

    @property
    def ms_per_frame(self) -> float:
        if not self.samples:
            return float("nan")
        return 1000.0 * sum(self.samples) / len(self.samples)

    @property
    def fps(self) -> float:
        ms = self.ms_per_frame
        return 1000.0 / ms if ms > 0 else float("nan")


def sync_all():
    """Wait for every visible card (a mesh's frame ends on all of them);
    nothing without one."""
    import torch
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def trimmed(inputs):
    """K1's inputs with the index cut to its live pairs (binning sizes it
    to a static capacity; K1 reads only the tiles' segments)."""
    packed, index, starts, counts, depth = inputs
    return packed, index[:int(counts.sum())], starts, counts, depth


@contextlib.contextmanager
def capture_k1_inputs(store: list, records: list = None):
    """Record the arguments of every K1 call the frame makes (and, into
    ``records``, the (packed, valid, bbox) of each raster pass). Eager
    frames only: a graph replay calls no Python."""
    from ..ops import raster
    orig, orig_pass = raster.rasterize_tiles, raster.rasterize_bands

    def wrapped(*inputs, **kw):
        store.append(inputs)
        return orig(*inputs, **kw)

    def wrapped_pass(packed, valid, bbox, *args, **kw):
        if records is not None:
            records.append((packed, valid, bbox))
        return orig_pass(packed, valid, bbox, *args, **kw)

    raster.rasterize_tiles = wrapped
    raster.rasterize_bands = wrapped_pass
    try:
        yield
    finally:
        raster.rasterize_tiles = orig
        raster.rasterize_bands = orig_pass


def edge_hits(inputs) -> int:
    """(record, pixel) tests of a K1 input whose three edge tests pass
    (every pixel of every (tile, record) pair, in blocks)."""
    import torch

    from ..ops import raster_common as rc
    from ..ops import raster_cuda as rk
    packed, index, starts, counts, depth = inputs
    H, W = depth.shape
    dev = depth.device
    ntx = -(-W // rk.TILE_W)
    tile_of = torch.repeat_interleave(
        torch.arange(counts.shape[0], device=dev), counts.long())
    lx = torch.arange(rk.TILE_W, device=dev).repeat(rk.TILE_H)
    ly = torch.arange(rk.TILE_H, device=dev).repeat_interleave(rk.TILE_W)
    total = 0
    for b0 in range(0, index.shape[0], 8192):
        t = tile_of[b0:b0 + 8192]
        rec = packed[index[b0:b0 + 8192].long()]
        x = (t % ntx * rk.TILE_W)[:, None] + lx
        y = (t // ntx * rk.TILE_H)[:, None] + ly
        px, py = x.float() + 0.5, y.float() + 0.5
        lane = [rec[:, k, None] for k in range(9)]
        hit = (x < W) & (y < H)
        for e in range(3):
            a, b, c = lane[3 * e:3 * e + 3]
            th = torch.where(rc.edge_is_top_left(a, b), -rc.TL_EPS, -0.0)
            hit &= rc.edge_eval(a, b, c, px, py) > th
        total += int(hit.sum())
    return total


def k1_bound(inputs, winner, label):
    """K1's bound at these inputs: (ms, "bytes" or "operations"). The
    bytes are what this run's data needs, each once: lanes 0..15 (64
    bytes) of every referenced record, lanes 16..31 (64 bytes: id and
    varying planes) of every winning record, the index, starts, counts,
    depth in, and the six planes and the winner out. The ids that exact
    depth ties read are left out, so the bound is if anything low."""
    import torch

    from ..ops import raster_cuda as rk
    packed, index, starts, counts, depth = inputs
    H, W = depth.shape
    rows = torch.unique(index).long()
    records = int(rows.numel())
    won = int(torch.unique(winner[winner >= 0]).numel())
    # with one id per referenced record, the winning ids count the
    # winning records; otherwise they are a lower bound on them
    ids_unique = int(torch.unique(packed[rows, 16]).numel()) == records
    nbytes = (records * 64 + won * 64 + index.numel() * 4
              + 2 * counts.numel() * 4 + H * W * 4 + 7 * H * W * 4)
    hits = edge_hits(inputs)
    ms_bytes = nbytes / 3.35e12 * 1e3
    ms_ops = 21 * hits / 67e12 * 1e3
    print(f"  bound {label}: {nbytes} bytes ({records} referenced records, "
          f"{won} winning ids, ids unique per record: {ids_unique}) -> "
          f"{ms_bytes:.4f} ms; {hits} passing edge tests of "
          f"{index.numel() * rk.TILE_H * rk.TILE_W} -> {ms_ops:.4f} ms")
    return (ms_bytes, "bytes") if ms_bytes >= ms_ops else (ms_ops,
                                                            "operations")


def syncs_per_frame(app) -> collections.Counter:
    """Host syncs of one steady-state frame, as the CUDA sync debug mode
    reports them, counted by the source line that made each (a blocking
    copy from pageable host memory counts as one). The fourth of four
    frames is counted: the first may count the mode's own set-up, and
    the three after a new frame plan check its overflow flag
    synchronously."""
    import torch
    torch.cuda.synchronize()
    for _ in range(4):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                app.tick()
            finally:
                torch.cuda.set_sync_debug_mode("default")

    def site(w):
        path = os.path.relpath(w.filename, REPO)
        return (f"{os.path.basename(path) if path.startswith('..') else path}"
                f":{w.lineno}")
    return collections.Counter(site(w) for w in caught
                               if "synchroniz" in str(w.message))


def assert_no_flags(app, label):
    """No overflow flag in any frame ``app.draw`` rendered at big scale
    1: the scale never rose, and the last frame's flag and every flag
    still queued are clear (read back here, between frames). ``app`` is
    anything with a ``draw``: an app, a frame function, a renderer."""
    draw = app.draw if hasattr(app, "draw") else app.draws[0]
    flags = [draw.last_overflow.cpu().numpy()] + [
        np.asarray(f) for f in draw._pending_overflow]
    if draw.big_scale != 1 or any(f.any() for f in flags):
        raise AssertionError(f"{label}: an overflow flag at big scale 1 "
                             f"(big scale now {draw.big_scale})")


# device-time groups of a profiled frame: (group, substring of the
# kernel names the profiler gives)
GROUPS = (("torch.cat copies", "CatArrayBatchedCopy"),
          ("elementwise kernels", "elementwise_kernel"),
          ("gathers", "gather"), ("K1", "raster_tile_kernel"),
          ("K2", "setup_pack_kernel"), ("K3", "terrain_vertex_kernel"),
          ("K4", "straddle_"), ("K5", "bin_tiles_"),
          ("host-to-device copies", "Memcpy HtoD"))
# the sorts of binning's plain version and of the straddler selection
# (cub's radix sorts, torch's in-place sorts of short rows); K5's one kernel
# (bin_tiles_kernel, a launch a raster pass) matches neither this nor
# elementwise_kernel
SORTS = ("sorts", "Sort")


def group_totals(by_name: dict, key: str, frames: int):
    """(ms a frame, launches a frame) of the kernels whose name holds
    ``key``."""
    rows = [v for name, v in by_name.items() if key in name]
    return (sum(t for t, _ in rows) / 1e3 / frames,
            sum(n for _, n in rows) // frames)


def print_groups(by_name: dict, frames: int, groups=GROUPS):
    for group, key in groups:
        ms, n = group_totals(by_name, key, frames)
        print(f"    group {group}: {ms:.3f} ms/frame, {n}x")


def profile_frames(app, frames: int, name: str):
    """torch.profiler over ``frames`` unfenced frames: (wall ms/frame,
    device busy ms/frame, device ops/frame, {kernel: (us, count)}, the
    profiler's events). The trace goes to ``build/<name>/trace.json``."""
    import torch
    torch.cuda.synchronize()
    with trace(os.path.join(REPO, "build", name)) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            app.tick()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000.0 / frames
    # device-side events only (kernels, copies, fills): the host ops
    # that launched them carry the same time again
    events = prof.events()
    kernels = [e for e in events if on_device(e)]
    by_name = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    device_ms = sum(t for t, _ in by_name.values()) / 1e3 / frames
    return wall_ms, device_ms, len(kernels) / frames, by_name, events


def on_device(event) -> bool:
    """A profiler event of work on the card: a kernel, copy or fill, not
    the device-side shadow of a ``record_function`` span."""
    import torch
    return (event.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(event, "is_user_annotation", False))


def frames_equal(a, b, label: str, frame: int):
    """Two apps' framebuffers and winners bit-equal after a frame (a
    banded frame is assembled on the first card)."""
    def whole(t):
        return t.to("cuda") if hasattr(t, "bands") else t
    fa, fb = whole(a.window.framebuffer), whole(b.window.framebuffer)
    wa = [whole(w) for w in a.draw.last_winners]
    wb = [whole(w) for w in b.draw.last_winners]
    if not (torch_equal_bits(fa, fb)
            and len(wa) == len(wb) == 1 and wa[0].equal(wb[0])):
        raise AssertionError(f"{label}: frame {frame} differs")


def torch_equal_bits(a, b) -> bool:
    """Two float tensors equal bit for bit (NaNs and signed zeros
    included)."""
    import torch
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def unpack_records(packed):
    """The set-up triangles of packed records (``rc.pack_coeffs_full``),
    as a TriCoeffs in id order: the oracle's lowest index at an exact
    depth tie is then K1's lowest id. Returns (TriCoeffs, ids, order)."""
    import torch

    from ..ops import raster_common as rc
    order = torch.argsort(packed[:, 16], stable=True)
    p = packed[order]
    zhi = p[:, 15]
    tc = rc.TriCoeffs(
        edge_a=p[:, 0:9:3], edge_b=p[:, 1:9:3], edge_c=p[:, 2:9:3],
        z_abc=p[:, 9:12], w_abc=p[:, 12:15],
        col_abc=p[:, 20:32].reshape(-1, 4, 3).transpose(1, 2),
        en_abc=p[:, 17:20], valid=zhi > 0, zhi=zhi)
    return tc, p[:, 16].to(torch.int32), order


def oracle_frame(packed, bbox, H: int, W: int, depth0: float):
    """The full-frame oracle (``ops/raster_ref.py``) over a raster pass's
    packed records and boxes, on their device, independent of binning
    and K1: (depth [H, W], den plane [H, W], num planes [4, H, W], the
    winning record's id [H, W], -1 where nothing covers)."""
    import torch

    from ..ops import raster_ref
    tc, ids, order = unpack_records(packed)
    d_r, w_r = raster_ref.rasterize_visibility(
        tc, H, W, depth=torch.full((H, W), depth0, device=packed.device),
        bbox=tuple(c[order] for c in bbox))
    num_r, den_r = raster_ref.planes(tc, w_r)
    w_ids = torch.where(w_r >= 0, ids[w_r.clamp(min=0).long()], w_r)
    return d_r, den_r, num_r, w_ids


def zeroed_table(table):
    """A zeroed :class:`setup_pack.RecordTable` shaped as ``table``, on
    its device."""
    import torch

    from ..ops import setup_pack as sp
    return sp.RecordTable(*(torch.zeros_like(t) for t in table))


def tables_differ(got: list, want: list):
    """(values that differ, the largest finite difference) between two
    lists of record tables, lane by lane; NaN against NaN counts as
    equal."""
    import torch
    bad, err = 0, 0.0
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if a.is_floating_point():
                differ = ((a.view(torch.int32) != b.view(torch.int32))
                          & ~(torch.isnan(a) & torch.isnan(b)))
                both = torch.isfinite(a) & torch.isfinite(b)
                if bool(both.any()):
                    err = max(err, float((a[both] - b[both]).abs().max()))
            else:
                differ = a != b
            bad += int(differ.sum())
    return bad, err


def k2_pass_against_plain(segments: list):
    """A pass's segments (``setup_pack.Segment``, on the card) through K2's
    launches (``setup_pack.launch_groups``) and through its plain version,
    each into
    zeroed tables shaped as the segments'. Returns (values that differ,
    the largest finite difference, launches). K2's launch count is left as
    it was."""
    import torch

    from ..ops import setup_pack as sp
    tables = {id(s.table): s.table for s in segments}
    got = {k: zeroed_table(t) for k, t in tables.items()}
    want = {k: zeroed_table(t) for k, t in tables.items()}
    launches = sp.K2.launches
    groups = sp.launch_groups([s._replace(table=got[id(s.table)])
                               for s in segments])
    for group in groups:
        sp.K2(group)
    sp.K2.launches = launches
    sp.setup_pack_pass_reference([s._replace(table=want[id(s.table)])
                                  for s in segments])
    torch.cuda.synchronize()
    return (*tables_differ([got[k] for k in tables],
                           [want[k] for k in tables]), len(groups))


def k2_graph_replays(device, replays: int = 30,
                     sizes=(20_000, 256, 7, 256)) -> int:
    """K2 captured in one CUDA graph as frames hold it: a merged pass of
    four segments of ``sizes`` into one table (the first planar with ids
    and biased, the second read through strided views, cull modes back,
    none, front, back), then a pass of two segments into two tables (the
    shards of a mesh); replayed ``replays`` times with every input
    rewritten in place before each replay (``trisets.setup_batch``); after
    each replay every table against the plain version on that replay's
    inputs. Returns the values that differ (NaN against NaN counts as
    equal), and raises if the graph does not hold exactly two launches.
    K2's launch count is left as it was."""
    import torch

    from ..ops import setup_pack as sp
    from .trisets import setup_batch

    def inputs(n, strided=False):
        clip = torch.zeros((n, 3, 4), device=device)
        vary = torch.zeros((n, 3, 4), device=device)
        if strided:
            vary = vary.transpose(1, 2).contiguous().transpose(1, 2)
            clip = torch.zeros((n, 3, 8), device=device)[..., 2:6]
        return (clip, vary, torch.zeros(n, dtype=torch.bool, device=device),
                torch.zeros(n, dtype=torch.int32, device=device))

    W, H = 1920, 1080
    bufs = [inputs(n, k == 1) for k, n in enumerate(sizes)]
    merged = sp.new_table(sum(sizes), device)
    shards = [sp.new_table(n, device) for n in sizes[:2]]
    culls = ("back", "none", "front", "back")
    first = [sum(sizes[:k]) for k in range(len(sizes))]
    passes = [
        [sp.Segment(merged, r, c, v, m, W, H, cull, 2.0 if k == 0 else None,
                    k == 0, r, ids if k == 0 else None)
         for k, (r, (c, v, m, ids), cull) in enumerate(zip(first, bufs,
                                                            culls))],
        [sp.Segment(t, 0, c, v, m, W, H, "none", 0.0, False, 1000)
         for t, (c, v, m, _ids) in zip(shards, bufs)]]
    tables = [merged, *shards]
    graph = torch.cuda.CUDAGraph()
    launches = sp.K2.launches
    with torch.cuda.device(device):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for segments in passes:
                sp.setup_pack_pass(segments)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        before = sp.K2.launches
        with torch.cuda.graph(graph):
            for segments in passes:
                sp.setup_pack_pass(segments)
        held = sp.K2.launches - before
        if held != len(passes):
            raise AssertionError(f"the graph holds {held} K2 launches for "
                                 f"{len(passes)} passes")
        bad = 0
        for r in range(replays):
            for k, (b, n) in enumerate(zip(bufs, sizes)):
                for t, a in zip(b, setup_batch(n, 7 * r + k)):
                    t.copy_(torch.from_numpy(a))
            graph.replay()
            want = [zeroed_table(t) for t in tables]
            by_id = {id(t): w for t, w in zip(tables, want)}
            sp.setup_pack_pass_reference(
                [s._replace(table=by_id[id(s.table)])
                 for segments in passes for s in segments])
            bad += tables_differ(tables, want)[0]
    sp.K2.launches = launches
    return bad


def k4_graph_replays(device, replays: int = 60,
                     sizes=(300_000, 5_000)) -> int:
    """K4 captured in one CUDA graph as a frame holds it (two calls, one
    a batch of each of ``sizes``, on one stream, its scratch owned by the
    graph as ``renderer/compiled.py`` owns it), replayed ``replays`` times
    with the batches rewritten in place before each replay
    (``trisets.straddler_replay``); after each replay all five results of
    both calls against ``select_straddlers_reference`` on that replay's
    inputs. Returns the values that differ (NaN against NaN by bits), and
    raises if the graph does not hold exactly two launches or leaves its
    scratch dirty. K4's launch count is left as it was."""
    import torch

    from ..ops import raster_common as rc
    from ..ops import straddlers as st
    from .trisets import REPLAY_CAP, straddler_replay
    bufs = [(torch.zeros((n, 3, 4), device=device),
             torch.zeros((n, 3, 4), device=device),
             torch.zeros(n, dtype=torch.bool, device=device)) for n in sizes]
    store, graph = {}, torch.cuda.CUDAGraph()
    launches = st.K4.launches
    with torch.cuda.device(device):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side), st.graph_scratch(store):
            for b in bufs:                  # the warm-up makes the scratch
                rc.select_straddlers(*b, REPLAY_CAP)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        before = st.K4.launches
        with st.graph_scratch(store), torch.cuda.graph(graph):
            outs = [rc.select_straddlers(*b, REPLAY_CAP) for b in bufs]
        if st.K4.launches - before != len(sizes):
            raise AssertionError(f"the graph holds {st.K4.launches - before}"
                                 f" K4 launches for {len(sizes)} calls")
        bad = 0
        for r in range(replays):
            for k, (b, n) in enumerate(zip(bufs, sizes)):
                for t, a in zip(b, straddler_replay(n, 3 * r + k)):
                    t.copy_(torch.from_numpy(a))
            graph.replay()
            for b, got in zip(bufs, outs):
                want = rc.select_straddlers_reference(*b, REPLAY_CAP)
                for x, y in zip(got, want):
                    if x.is_floating_point():
                        x, y = x.view(torch.int32), y.view(torch.int32)
                    bad += int((x != y).sum())
        dirty = sum(int(t.count_nonzero()) for t in store.values())
    st.K4.launches = launches
    if dirty or not store:
        raise AssertionError(f"K4's graph scratch holds {dirty} nonzero "
                             f"words after the replays")
    return bad


def k5_graph_replays(device, replays: int = 30, records: int = 20_000,
                     frame=(1080, 1920), band=(270, 540)) -> int:
    """K5 captured in one CUDA graph as a frame holds it (two passes over
    the same ``records`` boxes of a ``frame`` (H, W): the whole frame and
    its band ``band`` = (height, y0), on one stream, its scratch owned by
    the graph as ``renderer/compiled.py`` owns it), replayed ``replays``
    times with the boxes rewritten in place before each replay
    (``trisets.bin_boxes`` by ``BIN_REPLAYS``); after each replay the four
    results of both passes against ``bin_tiles_reference`` on that
    replay's inputs. Returns the values that differ, and raises if the
    graph does not hold exactly two launches or leaves its scratch dirty.
    K5's launch count is left as it was."""
    import torch

    from ..ops import binning
    from ..ops.raster import pair_capacity
    from .trisets import BIN_REPLAYS, bin_boxes
    H, W = frame
    valid = torch.zeros(records, dtype=torch.bool, device=device)
    bbox = torch.zeros((4, records), dtype=torch.float32, device=device)
    cap = pair_capacity(records)
    passes = ((H, 0), band)
    store, graph = {}, torch.cuda.CUDAGraph()
    launches = binning.K5.launches

    def frame_passes():
        return [binning.bin_tiles(valid, bbox, h, W, y0, cap)
                for h, y0 in passes]

    with torch.cuda.device(device):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side), binning.graph_scratch(store):
            frame_passes()                  # the warm-up makes the scratch
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        before = binning.K5.launches
        with binning.graph_scratch(store), torch.cuda.graph(graph):
            outs = frame_passes()
        held = binning.K5.launches - before
        if held != len(passes):
            raise AssertionError(f"the graph holds {held} K5 launches for "
                                 f"{len(passes)} passes")
        bad = 0
        for r in range(replays):
            v, b = bin_boxes(records, r, H, W,
                             **BIN_REPLAYS[r % len(BIN_REPLAYS)])
            valid.copy_(torch.from_numpy(v))
            bbox.copy_(torch.from_numpy(b))
            graph.replay()
            for (h, y0), got in zip(passes, outs):
                want = binning.bin_tiles_reference(valid, bbox, h, W, y0,
                                                   cap)
                bad += sum(int((x != y).sum()) for x, y in zip(got, want))
        dirty = sum(int(t.count_nonzero()) for t in store.values())
    binning.K5.launches = launches
    if dirty or not store:
        raise AssertionError(f"K5's graph scratch holds {dirty} nonzero "
                             f"words after the replays")
    return bad
