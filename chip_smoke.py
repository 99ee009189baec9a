"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA card.

Run from the repository root:  python3 chip_smoke.py

Drives myrenderer_tpu_torch through its entry points and exits non-zero
at the first failed phase:

1. environment: torch version, card name and power limit;
2. build: K1 (csrc/raster_tile.cu), K2 (csrc/setup_pack.cu), K3
   (csrc/terrain_vertex.cu), K4 (csrc/straddlers.cu) and K5
   (csrc/bin_tiles.cu), one nvcc each, started together, timed;
3. K1 against its plain PyTorch version on the card: random triangle
   sets (with duplicated triangles for depth ties), a crowded tile (1,200
   small triangles and 400 duplicates in one tile: 13 chunks of K1's
   ring, ties across chunk borders), a ragged 47x161 frame, a set stored
   last record first (depth ties go to later records), and the
   1920x1080 demo's frame-1 records; winners exact, depth bit-exact, the
   five planes bit-exact (0 ulp). The plain version on the card is also
   held bit for bit against the same frame rendered on the CPU. Per-tile
   record counts (mean, p50, p99, max, empty tiles) of each frame-1
   shape;
4. goldens through K1: DemoApp(128, 128) frames 1 and 31 against
   tests/goldens (max diff <= 1, > 99.9 % of values exact);
5. the slice: DemoApp(1920, 1080) for 1 warm-up plus 60 timed frames
   (CUDA graph replays), exactly one K1 launch per frame, ms/frame
   beside the plain-version path's (eager); K1 alone at the frame-1
   shapes beside its plain version and its bound;
6. the stress scene: StressApp at full width (3840x2160, terrain 708
   plus 10,000 instanced markers: 1,012,528 triangles, two batches, one
   merged pass) for 1 eager frame plus 20 timed frames (graph
   replays), exactly one K1 launch per frame, a finite framebuffer and
   the peak device memory (of the eager frame 1);
   K1 against its plain version on frame 1's records (winners exact,
   depth and planes 0 ulp); a few frames of the plain-version path, its
   last frame bit-equal to the K1 path's; K1 alone at these shapes
   beside its plain version and its bound, with every tile emptied (its
   memory floor) and with every record invalid (its records copied and
   staged, no list walked); where the frame's time goes
   (a fence around each layer of the eager frame, and the eager
   frame's device busy share, ops and groups from torch.profiler);
7. the sequential frame path on the card: a later surface that clears
   and a depth_write=False pipeline, one K1 launch per batch, the
   framebuffer and every pass's winners equal to the CPU's bit for bit;
8. fragment-stage texture sampling through K1: the textured quad
   against tests/goldens/textured_128.png (the goldens rule);
9. the 7680x4320 demo frame 1 through K1 (one launch), K1 against its
   plain version on its records, K1 alone beside its plain version and
   its bound;
10. row bands on the card: K1 against its plain version at y0 > 0, bit
   for bit, on the row bands of the 1080p, 4K and 8K frame-1 records
   and on thin slivers in the last 270-row band of a 7680x4320 frame;
   DemoApp(1920, 1080) on 4 bands of cuda:0 (frames 1 and 31) and the
   stress scene on 4 and 8 bands, sharded (each batch packed in one
   piece a band of about T / bands rows, shown from an eager frame's
   packs), winners and framebuffers bit-equal to the single-device
   frames, one K1 launch per band and frame; with more than one card
   (d), the matrix of peer access, the demo (frames 1 and 31) and the
   stress scene (frame 1) with one band a card as per-card graph
   replays, bit-equal to one card, 0 host syncs a steady-state frame,
   the all-gather's bytes a frame, and ms/frame in turns beside one
   card's graph frame; ms/frame of each beside the single-device frame
   in turns in the same call, and host syncs per frame by the line that
   made them;
11. the compiled frame (``renderer/compiled.py``): the 1080p demo (31
   frames), the demo on 4 bands of one card (31) and the stress scene
   (20), and the stress scene on 4 bands of one card (20), as CUDA graph
   replays (a mesh frame as segmented graphs: the shards' graph and the
   bands' graph) bit-equal, framebuffer and winners, to the eager frame
   after every frame, one K1 launch a band and frame; host syncs of a
   steady-state frame by line (0 on the graph, also on 4 bands, 1 under
   strict_overflow); ms/frame graph against eager in turns, and the 4
   band graph frames against one device's graph frame in turns; device busy
   share, device ops a frame and K1's time inside the replay from
   torch.profiler; each graph's capture time and pool memory (each
   segment's on a mesh); the
   capacity ladder on the card (a starved first frame recovered bit for
   bit, a late overflow detected through the asynchronous flag queue);
   a vertex function that calls ``.item()`` makes Draw.end raise. No
   frame any phase renders raises an overflow flag at big scale 1;
12. the behaviour scenes on the card: (a) every scripted scene of
   ``myrenderer_tpu_torch/utils/scenes.py`` (vertex, u32-binding and
   texture writes, an animated clear colour, vertex-buffer swaps,
   resizes, surfaces that appear and disappear, instanced draws, ctx
   fragment programs, eye-plane straddlers, sequential passes, a planar
   vertex function) for 6 frames as graph replays, eagerly and on the
   oracle backend: replay bit-equal to eager (framebuffer and winners)
   and winners equal to the oracle's after every frame, with the graphs
   captured and their pool; (b) ``tools/tpu_checks.py`` check 1: K1
   against the full-frame oracle (``ops/raster_ref.py``) on random
   batches of 16, 128 and 512 triangles at 96x256, on the 1080p demo's
   frame-1 records and on their band at y0 = 540: winner diffs 0 and
   num/den plane ulps 0, depth ulps printed;
13. the benchmark's smoke rows: ``bench_torch.main(["--smoke"])`` in
   this process (the demo at 256x256 through its checks, timed loops and
   traced run), its row non-null and correct;
14. K2 (clip + setup + pack, ``ops/setup_pack.py``: one launch a raster
   pass over its segments, each batch and each appendee block) against
   its plain PyTorch version on the card, bit for bit in every lane of
   the records, the valid flags and the boxes (NaN against NaN):
   random batches (``trisets.setup_batch``) over every cull mode, layout,
   z bias and ids, half of them read through strided views, as passes of
   6 segments and one pass of all 36 (two launches); K2 as a CUDA graph of
   two passes replayed 30 times with every input rewritten in place
   (``profiling.k2_graph_replays``); every K2 pass of the 1080p demo's,
   the 4K stress scene's, the sequential path's and the demo on 4 bands'
   eager frame 1 (captured at ``setup_pack_pass``); K2 alone over a
   frame's launches at the two cells' passes, back to back and with the
   L2 flushed, beside its plain version
   and its bound; its launches on every path (counted from 0 around each
   path as K1's are, and required; exactly one a raster pass without a
   mesh and two a frame and distinct card on one: the shards' stage, the
   bands' pass);
15. K3 (the terrain's whole-stream vertex shader,
   ``ops/terrain_vertex.py``) and K4 (the straddler selection,
   ``ops/straddlers.py``) against their plain PyTorch versions on the
   card, bit for bit in every value: K3 on random terrains of the demo's
   size (100), the stress scene's (708), three instances of size 37, one
   of size 1 and three of size 7 with random worlds (heights with 0, 1
   and subnormals); K4 on the CPU tests' batches
   (``trisets.STRADDLER_CASES``: no straddler, one of each kind, exactly
   cap and cap + 1, fewer triangles than cap, one triangle, w at W_EPS
   and NaN, invalid rows among straddlers) and on four batches of
   1,002,528 triangles; K4 as a CUDA graph of a frame's two calls,
   replayed 60 times with its inputs rewritten in place
   (``profiling.k4_graph_replays``: every replay bit-equal, the scratch
   left zeroed); both on every call of the 1080p demo's and the 4K stress
   scene's eager frame 1 (captured at ``terrain_vertex`` and
   ``select_straddlers``); each alone a frame's calls at a time (warm,
   L2-flushed) beside its plain version and its bytes bound and share,
   one launch a call, and K4 alone on the two straddler-heavy 1M batches
   too; their launches on every path (counted from 0 around each path as
   K2's are): K3 required on every path that draws a terrain, K4 on every
   path without a mesh, one K4 launch a batch and frame on the demo and
   stress paths;
16. K5 (binning, ``ops/binning.py``) against its plain PyTorch version on
   the card, bit for bit in the index, starts, counts and flag: the CPU
   tests' random boxes (``trisets.BIN_CASES``: off the frame, NaN,
   invalid, a box over every tile, ragged frames, bands at y0 > 0, one
   record, a crowded frame, one triangle over most of a 1080p frame among
   20,000 small ones), each also starved to a third of its pairs; spans
   summing past 2^31; a pass of the 8K frame (129,600 tiles) on the
   card's whole residency (``K5.resident_blocks`` blocks); every binning
   call of the 1080p demo's and the 4K stress scene's eager frame 1
   (captured at ``bin_tiles``), as it is, starved to a third of its pairs
   and cut into four bands; the spans past 2^31 and the stress call on
   one block an SM (more records a block than its record cache holds),
   each as it is and starved; K5 as a CUDA graph of two passes replayed 30
   times with its boxes rewritten in place (``profiling.k5_graph_replays``);
   the seven phases of one launch on each cell's call (``K5.phase_times``);
   K5 alone a frame's calls at a time (warm, L2-flushed) beside its plain
   version, its bytes bound and torch.sort over the pass's int64 tile
   keys; its launches
   counted from 0 around every path, required on every path that bins
   (phases 5 and 6: one a frame), no sort kernel in a single-device
   frame's trace and one K5 kernel a raster pass in a graph replay's
   (phase 11);
17. a JSON line of the kernels (K1-K5), the card line, and the last line
   {"ok": true, "device": {...}}.

K1's bound at a shape is the larger of its bytes over 3.35 TB/s (what
the run's data needs, each once: 64 bytes (lanes 0..15) of each
referenced record, 64 more (lanes 16..31) of each winning record, the
index, starts and counts, depth in, the six planes and the winner out)
and its operations over 67 TFLOP/s (21 fp32 operations for each
(record, pixel) whose three edge tests pass: the tests a perfect reject
leaves). K1 is timed back to back (its inputs may stay in the 50 MB L2
where they fit), queued behind a spin on the card so that the host's
launch rate does not count, and call by call with the L2 flushed before
each call. K2's bound is the larger of its bytes over 3.35 TB/s (each
triangle's clip positions and varyings, 96 bytes, its valid flag and id
in; its 128-byte record, 16-byte box and flag out) and its
K2_OPS_PER_TRI fp32 operations a triangle over 67 TFLOP/s; it is timed
like K1, a frame's launches at a time. K3's bound is its bytes over 3.35
TB/s (heights, data transform and world matrix in; 100 bytes a triangle
out), K4's its bytes (49 a triangle for the sectors that hold the w
lanes and the valid flag, then the rows it selects in and the appendee
block out); both are timed like K2. K5's bound is its bytes (each
record's box and flag in; the index's C slots, each tile's start and
count and the flag out), timed like K2.

Imports no JAX. Needs one CUDA card; fails without one.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import gc
import io
import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import torch

from myrenderer_tpu_torch.utils.profiling import (
    SORTS, assert_no_flags, capture_k1_inputs, frames_equal, k1_bound,
    k4_graph_replays, k5_graph_replays, on_device, oracle_frame,
    print_groups, profile_frames, sync_all, syncs_per_frame, trimmed)

REPO = os.path.dirname(os.path.abspath(__file__))
TIMED_FRAMES = 60
PLAIN_FRAMES = 30     # plain-version path frames, before and after K1's
STRESS_FRAMES = 20
STRESS_PLAIN_FRAMES = 3   # plain-version path frames after its warm-up
PROFILE_FRAMES = 3
BAND_FRAMES = 10          # demo frames a turn, banded and on one device
BAND_STRESS_FRAMES = 5    # stress frames a turn, banded and on one device
BAND_ROUNDS = 3           # turns of each
SPIN_HZ = 2.0e9           # cycles a second of torch.cuda._sleep (at most)
ALONE_SPIN_MS = 0.5       # card spin ahead of each K3 / K4 frame timed alone
K2_REPLAYS = 30           # replays of phase 14's K2 graph
K4_REPLAYS = 60           # replays of phase 15's K4 graph
# fp32 operations of one triangle in K2: pixel coordinates 24, edges 27
# (an FMA counts two), det 5, the cull sign 9, the z bias 6, 18 plane
# columns of 5, the den plane 6, the id 1, the box 24, comparisons 15
K2_OPS_PER_TRI = 207
# fp32 operations of one triangle in K3: for each of its 3 vertices, x
# and z 3 each (an FMA counts two), the 4 clip channels 6 each, y 1
K3_OPS_PER_TRI = 93
K5_REPLAYS = 30           # replays of phase 16's K5 graph
# K2's, K3's, K4's and K5's launches by path, each counted from 0 around
# the path's run
K2_BY_PATH = collections.Counter()
K3_BY_PATH = collections.Counter()
K4_BY_PATH = collections.Counter()
K5_BY_PATH = collections.Counter()


def phase(name: str):
    print(f"[phase] {name}", flush=True)


def card_lines() -> list:
    """Each card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()


def card_line() -> str:
    return card_lines()[0]


@contextlib.contextmanager
def kernel_path(path: str):
    """Count K2's, K3's, K4's and K5's launches while the block drives
    ``path``: each count set to 0 just before, read just after, added to
    ``K2_BY_PATH[path]`` .. ``K5_BY_PATH[path]``."""
    from myrenderer_tpu_torch.ops.binning import K5
    from myrenderer_tpu_torch.ops.setup_pack import K2
    from myrenderer_tpu_torch.ops.straddlers import K4
    from myrenderer_tpu_torch.ops.terrain_vertex import K3
    counted = ((K2, K2_BY_PATH), (K3, K3_BY_PATH), (K4, K4_BY_PATH),
               (K5, K5_BY_PATH))
    for kernel, _ in counted:
        kernel.launches = 0
    yield
    for kernel, by_path in counted:
        by_path[path] += kernel.launches


def batches(app) -> int:
    """Batches of ``app``'s frame plan (K4 launches once for each on one
    device)."""
    plan = next(iter(app.draw._plans.values()))
    return sum(len(b) for b in plan.surfaces)


def bin_random(n, seed, H, W, dup, dev, box=None, reverse=False):
    """K1 inputs for a random set: setup, pack (ids = array ranks),
    exact binning. ``dup`` appends copies of the first triangles, whose
    depth ties go to the lowest id; ``box`` crowds the triangles into
    one tile; ``reverse`` stores the records last first, so a tie goes
    to the record that comes later in a tile."""
    from myrenderer_tpu_torch.ops import raster
    from myrenderer_tpu_torch.ops import raster_common as rc
    from myrenderer_tpu_torch.utils.trisets import (crowded_triangles,
                                                    random_triangles)
    clip, vary = (random_triangles(n, seed) if box is None
                  else crowded_triangles(n, seed, H, W, box))
    if dup:
        clip = np.concatenate([clip, clip[:dup]])
        vary = np.concatenate([vary, vary[:dup][..., ::-1].copy()])
    clip_t = torch.from_numpy(clip).to(dev)
    vary_t = torch.from_numpy(vary).to(dev)
    valid = torch.ones(clip.shape[0], dtype=torch.bool, device=dev)
    tc = rc.triangle_setup(clip_t, vary_t, valid, W, H, "back")
    packed = rc.pack_coeffs_full(tc)
    bbox = raster.viewport_bbox(clip_t, W, H)
    valid = tc.valid
    if reverse:
        packed, valid = packed.flip(0), valid.flip(0)
        bbox = tuple(b.flip(0) for b in bbox)
    index, starts, counts, overflow = raster.bin_packed(packed, valid, bbox,
                                                        H, W)
    if bool(overflow):
        raise AssertionError("a random set outgrew the pair capacity")
    depth = torch.ones((H, W), dtype=torch.float32, device=dev)
    return trimmed((packed, index, starts, counts, depth))


def ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    ai = a.contiguous().view(torch.int32).long()
    bi = b.contiguous().view(torch.int32).long()
    return int((ai - bi).abs().max()) if a.numel() else 0


def compare_k1(inputs, label, y0=0):
    """K1 against the plain version on the same card inputs (a band
    from frame row ``y0``). Returns the max abs difference over the
    fused planes."""
    from myrenderer_tpu_torch.ops import raster_cuda as rk
    fused, winner = rk.K1(*inputs, y0=y0)
    rfused, rwinner = rk.rasterize_tiles_reference(*inputs, y0=y0)
    torch.cuda.synchronize()
    bad_w = int((winner != rwinner).sum())
    depth_ulp = ulps(fused[0], rfused[0])
    plane_ulp = ulps(fused[1:], rfused[1:])
    err = float((fused - rfused).abs().max()) if fused.numel() else 0.0
    print(f"  {label}: {inputs[0].shape[0]} records, {inputs[1].shape[0]} "
          f"(tile, record) pairs, covered "
          f"{int((winner >= 0).sum())}, winner mismatches {bad_w}, depth "
          f"ulps {depth_ulp}, plane ulps {plane_ulp}, max abs {err}")
    if bad_w or depth_ulp or plane_ulp:
        raise AssertionError(
            f"K1 disagrees with its plain version ({label})")
    return err


def tile_stats(inputs, label):
    """Per-tile record counts of a K1 input: how even the CTAs' work is."""
    counts = inputs[3].float()
    q = torch.quantile(counts, torch.tensor([0.5, 0.99], device=counts.device))
    stats = {"tiles": counts.numel(), "mean": float(counts.mean()),
             "p50": float(q[0]), "p99": float(q[1]),
             "max": int(counts.max()), "empty": int((counts == 0).sum())}
    print(f"  tile records {label}: {stats}")
    return stats


def time_cold(fn, n: int, flush, spin_ms: float = 0.0) -> float:
    """Median over ``n`` calls of each call's own device time (CUDA
    events around it), a write of ``flush`` before each call evicting the
    card's 50 MB L2 (and keeping the card busy while the call is
    queued), then a spin of ``spin_ms`` on the card for a call whose
    host side takes longer to queue than the write takes to run."""
    times = []
    for _ in range(n):
        flush.zero_()
        if spin_ms:
            torch.cuda._sleep(int(spin_ms * 1e-3 * SPIN_HZ))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in times]))


def time_k1(inputs, n_k1, n_plain, label, card, flush):
    """K1 alone beside its plain version (plain, K1, K1, plain), then K1
    call by call with the L2 flushed; the timing launches are taken back
    out of K1's count."""
    from myrenderer_tpu_torch.ops import raster_cuda as rk
    p1 = time_call(lambda: rk.rasterize_tiles_reference(*inputs), n_plain)
    launches = rk.K1.launches
    k_a = time_call(lambda: rk.K1(*inputs), n_k1, head_start=True)
    k_b = time_call(lambda: rk.K1(*inputs), n_k1, head_start=True)
    cold = time_cold(lambda: rk.K1(*inputs), n_k1, flush)
    _, winner = rk.K1(*inputs)
    rk.K1.launches = launches
    p2 = time_call(lambda: rk.rasterize_tiles_reference(*inputs), n_plain)
    k1_ms, plain_ms = min(k_a, k_b), min(p1, p2)
    bound_ms, bound_by = k1_bound(inputs, winner, label)
    print(f"  K1 at {label} ({inputs[1].shape[0]} pairs, "
          f"{inputs[0].shape[0]} records): {k1_ms:.4f} ms (runs {k_a:.4f}, "
          f"{k_b:.4f}); bound {bound_ms:.4f} ms ({bound_by}), "
          f"{100.0 * bound_ms / k1_ms:.1f} % of it; call by call with the "
          f"L2 flushed (median of {n_k1}): {cold:.4f} ms "
          f"({100.0 * bound_ms / cold:.1f} % of the bound); plain version "
          f"{plain_ms:.3f} ms (runs {p1:.3f}, "
          f"{p2:.3f}); card: {card}")
    return {"ms": k1_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "pairs": int(inputs[1].shape[0]),
            "cold_ms": cold}


@contextlib.contextmanager
def plain_k1():
    """Route the frame's raster pass through K1's plain PyTorch version
    (for the plain-version path's timing)."""
    from myrenderer_tpu_torch.ops import raster, raster_cuda
    orig = raster.rasterize_tiles
    raster.rasterize_tiles = (
        lambda *inputs, check_segments=True, **kw:
        raster_cuda.rasterize_tiles_reference(*inputs, **kw))
    try:
        yield
    finally:
        raster.rasterize_tiles = orig


def time_frames(app, n: int) -> float:
    sync_all()
    t0 = time.perf_counter()
    for _ in range(n):
        app.tick()
    sync_all()
    return (time.perf_counter() - t0) * 1000.0 / n


def time_in_turns(apps: dict, n: int, rounds: int = BAND_ROUNDS,
                  path=None):
    """ms/frame of each app in ``apps`` {bands: app}: ``n`` fenced frames
    an app, the apps taking turns for ``rounds`` rounds. Returns each
    app's rounds and the K1 launches each made (counted from 0 just
    before each of its turns); with ``path``, K2's, K3's and K4's go to
    their ``*_BY_PATH[f"{path}_bands{bands}"]``."""
    from myrenderer_tpu_torch.ops import raster_cuda as rk
    ms = {k: [] for k in apps}
    launches = dict.fromkeys(apps, 0)
    for _ in range(rounds):
        for k, app in apps.items():
            rk.K1.launches = 0
            with (kernel_path(f"{path}_bands{k}") if path
                  else contextlib.nullcontext()):
                ms[k].append(time_frames(app, n))
            launches[k] += rk.K1.launches
    for k, count in launches.items():
        if count != k * n * rounds:
            raise AssertionError(f"K1 launched {count} times in "
                                 f"{n * rounds} frames of {k} bands")
    return ms, launches


def report_turns(label, ms: dict, launches: dict, syncs: dict, n: int,
                 card: str):
    for k, rounds in ms.items():
        print(f"  {label} on {k} band{'s' if k > 1 else ''}: "
              f"{float(np.median(rounds)):.3f} ms/frame (median of rounds "
              f"{', '.join(f'{r:.3f}' for r in rounds)}; {n} frames each), "
              f"{launches[k] / (n * len(rounds)):.0f} K1 launches a frame, "
              f"{sum(syncs[k].values())} host syncs a steady-state frame; "
              f"card: {card}")
        print(f"    syncs by line: " + ", ".join(
            f"{site} x{c}" for site, c in sorted(syncs[k].items())))


def time_call(fn, n: int, head_start: bool = False,
              spin_ms: float = 0.1) -> float:
    """Device ms per call over ``n`` back-to-back calls of ``fn``.
    ``head_start`` first queues a spin of ``spin_ms`` a call on the card,
    so the host has queued every call before the card reaches the first:
    a slow host then cannot leave the card idle between short kernels."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    if head_start:
        torch.cuda._sleep(int(n * spin_ms * 1e-3 * SPIN_HZ))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


@contextlib.contextmanager
def fenced_layers(totals: dict):
    """Add each frame layer's wall time, fenced by a device sync before
    and after it, into ``totals`` (ms by layer)."""
    from myrenderer_tpu_torch.ops import raster
    from myrenderer_tpu_torch.ops import setup_pack as sp
    from myrenderer_tpu_torch.renderer import draw
    targets = [(draw, "_batch_vertex_products", "vertex stage (incl. cull)"),
               (draw, "_batch_segments", "clip + setup + pack"),
               (sp, "setup_pack_pass", "clip + setup + pack"),
               (raster, "bin_bands", "binning"),
               (raster, "rasterize_tiles", "K1"),
               (raster, "shade_from_planes_ranges", "shade"),
               (draw.Draw, "_gather_args", "_gather_args (host to device)"),
               # a mesh frame's shards and its all-gather
               (draw, "_shard_vertex_products", "vertex stage (incl. cull)"),
               (draw, "_shard_setup", "clip + setup + pack"),
               (draw, "_mesh_setup", "clip + setup + pack"),
               (draw, "all_gather", "all-gather")]
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in targets]

    def fence(fn, label):
        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            totals[label] = (totals.get(label, 0.0)
                             + (time.perf_counter() - t0) * 1000.0)
            return out
        return timed

    for (owner, name, label), (_o, _n, fn) in zip(targets, saved):
        setattr(owner, name, fence(fn, label))
    try:
        yield
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def sequential_scene(device):
    """A frame for the sequential path: surface 1 holds a
    depth_write=False batch and a depth-writing one, surface 2 clears
    first and holds one more batch. Random triangles from a seed.
    Returns a function that draws the frame and returns (framebuffer,
    winners of every raster pass)."""
    from myrenderer_tpu_torch import (BindingLayout, Core, Draw, Instance,
                                      Pipeline, Renderer, SceneNode,
                                      Surface, VertexBuffer, VertexLayout,
                                      math3d)
    from myrenderer_tpu_torch.ops.vertex_stage import matvec4
    from myrenderer_tpu_torch.renderer.pipeline import BUILTIN_TRANSFORM
    core = Core(fixed_timestep=1.0 / 60.0)
    window = core.create_window(256, 256, "sequential")
    rend = Renderer(core, device=device)
    rend.adopt_window(window)
    rend.debug_winner = True
    layout = VertexLayout.create([("pos", 3), ("color", 3)])

    def vfn(ctx):
        p, c = ctx.attr("pos"), ctx.attr("color")
        one = torch.ones((), dtype=torch.float32, device=p.device)
        return (matvec4(ctx.world, torch.stack([p[0], p[1], p[2], one])),
                torch.stack([c[0], c[1], c[2], one]))

    def pipe(**kw):
        return Pipeline.create(rend, vertex_fn=vfn, vertex_layout=layout,
                               bindings=[BindingLayout(0, BUILTIN_TRANSFORM)],
                               cull_mode="none", **kw)

    nodepth, flat = pipe(depth_write=False), pipe()
    surfaces = []
    for seeds in (((nodepth, 1), (flat, 2)), ((flat, 3),)):
        root = SceneNode.create(rend)
        for pl, seed in seeds:
            rng = np.random.default_rng(seed)
            rows = np.concatenate([rng.uniform(-0.1, 1.1, (300, 3, 2)),
                                   rng.uniform(0.2, 1.8, (300, 3, 1)),
                                   rng.uniform(0, 1, (300, 3, 3))], -1)
            vb = VertexBuffer.new(rend, 0, 300, layout)
            vb.write_vertices(rows.astype(np.float32).reshape(-1, 6))
            node = Instance.create_node(rend, pipeline=pl)
            node.get_backing().set_vertex_buffer(vb)
            root.add_child(node)
        surf = Surface.create_window_scene(rend, window, root)
        surf.set_perspective(math3d.projection_2d(
            left=0.0, right=1.0, bottom=1.0, top=0.0, near=0.1, far=2.0))
        surfaces.append(surf)
    draw = Draw.create(rend)

    def frame():
        draw.begin()
        draw.clear((0.0, 0.0, 1.0, 1.0))
        draw.draw_surface(surfaces[0])
        draw.clear((0.2, 0.1, 0.0, 1.0))
        draw.draw_surface(surfaces[1])
        draw.end()
        return window.framebuffer, draw.last_winners

    frame.draw = draw
    return frame


def textured_quad_frame(device, size=128):
    """The fragment-ctx quad (tests/test_render_e2e.py): a 4x4 checker
    sampled per pixel by a two-parameter fragment program. Returns the
    frame's uint8 pixels."""
    from myrenderer_tpu_torch import (Binding, BindingLayout, Core, Draw,
                                      Instance, Pipeline, Renderer, Surface,
                                      VertexBuffer, VertexLayout, math3d)
    from myrenderer_tpu_torch.ops.sampling import sample_nearest
    from myrenderer_tpu_torch.ops.vertex_stage import matvec4
    from myrenderer_tpu_torch.renderer.pipeline import (BUILTIN_TRANSFORM,
                                                        TEXTURE_VIEW)
    core = Core(fixed_timestep=1.0 / 60.0)
    window = core.create_window(size, size, "textured")
    rend = Renderer(core, device=device)
    rend.adopt_window(window)
    layout = VertexLayout.create([("pos", 2), ("uv", 2)])

    def vfn(ctx):
        p, uv = ctx.attr("pos"), ctx.attr("uv")
        one = torch.ones((), dtype=torch.float32, device=p.device)
        return (matvec4(ctx.world, torch.stack([p[0], p[1], one, one])),
                torch.stack([uv[0], uv[1], torch.zeros_like(one), one]))

    pipe = Pipeline.create(
        rend, vertex_fn=vfn,
        fragment_fn=lambda vary, ctx: sample_nearest(ctx.binding(1),
                                                     vary[..., :2]),
        bindings=[BindingLayout(0, BUILTIN_TRANSFORM),
                  BindingLayout(1, TEXTURE_VIEW)],
        vertex_layout=layout)
    tex = np.zeros((4, 4, 4), np.float32)
    for y in range(4):
        for x in range(4):
            tex[y, x] = [1, 0, 0, 1] if (x + y) % 2 == 0 else [0, 1, 0, 1]
    vb = VertexBuffer.new(rend, 0, 2, layout)
    lo, hi = 0.1, 0.9
    vb.write_vertices(np.array([
        [lo, lo, 0, 0], [hi, lo, 1, 0], [lo, hi, 0, 1],
        [hi, lo, 1, 0], [hi, hi, 1, 1], [lo, hi, 0, 1]], np.float32))
    node = Instance.create_node(rend, pipeline=pipe,
                                bindings=[Binding(1, attachment=tex)])
    node.get_backing().set_vertex_buffer(vb)
    surf = Surface.create_window_scene(rend, window, node)
    surf.set_perspective(math3d.projection_2d(
        left=0.0, right=1.0, bottom=1.0, top=0.0, near=0.1, far=2.0))
    draw = Draw.create(rend)
    draw.begin()
    draw.clear((0, 0, 1, 1))
    draw.draw_surface(surf)
    draw.end()
    assert_no_flags(rend, "textured quad")
    return window.read_pixels()


def assert_goldens_rule(got, name):
    from myrenderer_tpu_torch.utils.png import load_rgba8
    want = load_rgba8(os.path.join(REPO, "tests", "goldens", name))
    diff = np.abs(got.astype(int) - want.astype(int))
    exact = float((diff == 0).mean())
    print(f"  {name}: max diff {int(diff.max())}, exact {exact:.6f}")
    if diff.max() > 1 or exact <= 0.999:
        raise AssertionError(f"{name} differs")


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(
        a.cpu().contiguous().view(torch.int32),
        b.cpu().contiguous().view(torch.int32))


def banded_k1_checks(frames, bands: int) -> float:
    """K1 against its plain version on every band below the first of
    each frame-1 pass in ``frames``: (label, (packed, valid, bbox),
    (H, W), incoming depth). Returns the max abs difference."""
    from myrenderer_tpu_torch.ops import raster
    err = 0.0
    for label, (packed, valid, bbox), (H, W), depth_in in frames:
        band = H // bands
        for k in range(1, bands):
            y0 = k * band
            index, starts, counts, overflow = raster.bin_packed(
                packed, valid, bbox, band, W, y0=y0)
            if bool(overflow):
                raise AssertionError(f"{label} band {k} outgrew the pair "
                                     "capacity")
            depth = torch.full((band, W), depth_in, device=packed.device)
            err = max(err, compare_k1(
                trimmed((packed, index, starts, counts, depth)),
                f"{label} band {k} of {bands} (y0 {y0})", y0=y0))
    return err


def sliver_band_check(dev) -> float:
    """K1 against its plain version on thin slivers grazing sub-block
    borders in the last 270-row band of a 7680x4320 frame."""
    from myrenderer_tpu_torch.ops import raster
    from myrenderer_tpu_torch.ops import raster_common as rc
    from myrenderer_tpu_torch.utils.trisets import band_slivers
    H, W, band = 4320, 7680, 270
    y0 = H - band
    clip, vary = band_slivers(20000, 7, H, W, y0)
    clip_t = torch.from_numpy(clip).to(dev)
    tc = rc.triangle_setup(clip_t, torch.from_numpy(vary).to(dev),
                           torch.ones(clip.shape[0], dtype=torch.bool,
                                      device=dev), W, H, "none")
    packed = rc.pack_coeffs_full(tc)
    index, starts, counts, overflow = raster.bin_packed(
        packed, tc.valid, raster.viewport_bbox(clip_t, W, H), band, W, y0=y0)
    if bool(overflow):
        raise AssertionError("the slivers outgrew the pair capacity")
    depth = torch.ones((band, W), device=dev)
    return compare_k1(trimmed((packed, index, starts, counts, depth)),
                      f"slivers 7680x4320 last band (y0 {y0})", y0=y0)


def assert_same_frame(banded, fb, winner, label):
    """The banded app's framebuffer and winners bit-equal to a
    single-device frame's ``fb`` and ``winner``."""
    if not (bits_equal(banded.window.framebuffer.cpu(), fb)
            and len(banded.draw.last_winners) == 1
            and torch.equal(banded.draw.last_winners[0].cpu(), winner.cpu())):
        raise AssertionError(f"{label} differs from the single-device frame")
    print(f"  {label}: framebuffer and winners bit-equal to the "
          f"single-device frame ({len(banded.window.framebuffer.bands)} "
          f"bands)")


def pack_split(make_app, label: str):
    """One eager frame of ``make_app()`` with the record pack recorded:
    every batch is packed in one piece a shard (shard k holds triangles
    [k * ceil(T / rows), ...)), plus its appendee block of 2 * 128 clip
    slots once a distinct device, and no piece holds a whole batch of
    more than one shard's triangles; two K2 passes a distinct device.
    Prints each batch's pieces."""
    from myrenderer_tpu_torch.renderer.draw import CLIP_CAPACITY
    app = make_app()
    app.draw._eager_frames = True
    passes = []
    with capture_setup_passes(passes):
        app.tick()
    sizes = [s.tri_clip.shape[0] for segments in passes for s in segments]
    plan = next(iter(app.draw._plans.values()))
    # a distinct device's shards in one K2 pass, its bands' appendee
    # blocks in another
    if len(passes) != 2 * len(plan.devices):
        raise AssertionError(f"{label}: {len(passes)} K2 passes on "
                             f"{len(plan.devices)} distinct devices")
    batches = [b for batches in plan.surfaces for b in batches]
    want = collections.Counter()
    for b in batches:
        want.update(hi - lo for lo, hi in b.shards)
        want[2 * CLIP_CAPACITY * plan.big_scale] += len(plan.devices)
    if collections.Counter(sizes) != want:
        raise AssertionError(f"{label}: packs of {sorted(sizes)} rows, not "
                             f"one a shard {sorted(want.elements())}")
    for b in batches:
        pieces = [hi - lo for lo, hi in b.shards]
        print(f"  {label}: a batch of {b.tri_count} triangles packed in "
              f"{len(pieces)} shard pieces of {sorted(set(pieces))} rows "
              f"(T / {len(pieces)} = {b.tri_count / len(pieces):.1f})")
    if any(n == b.tri_count > max(hi - lo for lo, hi in b.shards)
           for b in batches for n in sizes):
        raise AssertionError(f"{label}: a whole batch was packed at once")
    del app
    gc.collect()


def banded_demo(devices, single_frames: dict, label):
    """DemoApp(1920, 1080) banded over ``devices`` for 31 frames, held
    to ``single_frames`` {frame: (framebuffer, winner)} at frames 1 and
    31."""
    from myrenderer_tpu_torch.app.demo import DemoApp
    from myrenderer_tpu_torch.parallel import make_mesh
    app = DemoApp(1920, 1080, mesh=make_mesh(devices=devices))
    app.renderer.debug_winner = True
    for frame in range(1, 32):
        app.tick()
        if frame in single_frames:
            assert_same_frame(app, *single_frames[frame],
                              f"{label}, frame {frame}")
    devices = sorted({str(d) for d in app.window.framebuffer.devices})
    print(f"  {label}: on {devices}")
    return app


def single_demo_frames():
    """DemoApp(1920, 1080) on one device after 31 frames, and its
    {frame: (framebuffer, winner)} at frames 1 and 31."""
    from myrenderer_tpu_torch.app.demo import DemoApp
    single = DemoApp(1920, 1080, device="cuda")
    single.renderer.debug_winner = True
    frames = {}
    for frame in range(1, 32):
        single.tick()
        if frame in (1, 31):
            frames[frame] = (single.window.framebuffer.cpu(),
                             single.draw.last_winners[0].cpu())
    return single, frames


def peer_matrix(n: int) -> str:
    return "; ".join(
        f"cuda:{i} -> " + " ".join(
            "self" if i == j else
            ("yes" if torch.cuda.can_device_access_peer(i, j) else "no")
            for j in range(n)) for i in range(n))


def gather_line(app, label):
    """The all-gather's bytes a frame of ``app``'s mesh graph frame."""
    cf = next(iter(app.draw._plans.values())).compiled
    print(f"  {label}: the all-gather copies {cf.gather_bytes} bytes a frame "
          f"between cards ({cf.gather_bytes / 2**20:.1f} MiB; "
          f"{len(cf.graphs)} cards, {sum(len(g) for g in cf.graphs)} "
          f"graphs, capture {cf.capture_seconds:.3f} s, pools "
          f"{cf.pool_bytes / 2**20:.1f} MiB)")
    return cf.gather_bytes


def bands_over_cards(single, single_frames, cards):
    """One band a card over every card (as many as divide 1080), each
    card's share in its own CUDA graphs: the 1080p demo (frames 1 and
    31) and the stress scene (frame 1) bit-equal to one card, 0 host
    syncs a steady-state frame, the all-gather's bytes a frame, then
    each timed beside one card's graph frame in turns. Returns the
    results."""
    from myrenderer_tpu_torch.app.stress import StressApp
    from myrenderer_tpu_torch.parallel import make_mesh
    n = torch.cuda.device_count()
    while 1080 % n:
        n -= 1
    card = "; ".join(f"cuda:{i} {c}" for i, c in enumerate(cards))
    print(f"  peer access: {peer_matrix(torch.cuda.device_count())}")
    devices = [torch.device("cuda", i) for i in range(n)]
    banded = banded_demo(devices, single_frames,
                         f"demo 1920x1080 on {n} cards")
    out = {"cards": n, "card_lines": cards,
           "demo_gather_bytes": gather_line(banded, f"demo on {n} cards")}
    single.renderer.debug_winner = banded.renderer.debug_winner = False
    apps = {1: single, n: banded}
    ms, launches = time_in_turns(apps, BAND_FRAMES)
    syncs = {k: syncs_per_frame(a) for k, a in apps.items()}
    report_turns("demo 1920x1080, one band a card (graphs)", ms, launches,
                 syncs, BAND_FRAMES, card)
    if sum(syncs[n].values()):
        raise AssertionError(f"the demo on {n} cards syncs the host")
    print(f"  (the eager frame, one band a card on four H100 80GB HBM3 at "
          f"700 W: demo 28.512 against 22.991 ms/frame on one card)")
    out["demo_ms"] = {k: float(np.median(v)) for k, v in ms.items()}
    out["demo_launches"] = launches[n]
    single.renderer.debug_winner = True
    del apps, banded
    gc.collect()
    apps = {1: StressApp(device="cuda"),
            n: StressApp(mesh=make_mesh(devices=devices))}
    for app in apps.values():
        app.renderer.debug_winner = True
        app.tick()
        app.renderer.debug_winner = False
    assert_same_frame(apps[n], apps[1].window.framebuffer,
                      apps[1].draw.last_winners[0],
                      f"stress 3840x2160 frame 1 on {n} cards")
    out["stress_gather_bytes"] = gather_line(apps[n],
                                             f"stress on {n} cards")
    ms, launches = time_in_turns(apps, BAND_STRESS_FRAMES)
    for k, app in apps.items():
        assert_no_flags(app, f"stress 3840x2160 on {k} cards")
    syncs = {k: syncs_per_frame(a) for k, a in apps.items()}
    report_turns("stress 3840x2160, one band a card (graphs)", ms, launches,
                 syncs, BAND_STRESS_FRAMES, card)
    if sum(syncs[n].values()):
        raise AssertionError(f"the stress scene on {n} cards syncs the host")
    print(f"  (the eager frame, one band a card on four H100 80GB HBM3 at "
          f"700 W: stress 32.423 against 25.853 ms/frame on one card)")
    out["stress_ms"] = {k: float(np.median(v)) for k, v in ms.items()}
    out["stress_launches"] = launches[n]
    return out


def graph_against_eager(make_app, frames: int, label: str, path: str):
    """``frames`` frames of a graph app and an eager app built alike,
    framebuffers and winners bit-equal after every frame, K1 launched
    bands-many times a frame by each; the graph app's K2, K3 and K4
    launches go to their ``*_BY_PATH[path]``. Returns (graph app, eager
    app)."""
    from myrenderer_tpu_torch.ops import raster_cuda as rk
    apps = {"graph": make_app(), "eager": make_app()}
    apps["eager"].draw._eager_frames = True
    launches = dict.fromkeys(apps, 0)
    for app in apps.values():
        app.renderer.debug_winner = True
    k2_before = K2_BY_PATH[path]
    for frame in range(1, frames + 1):
        for mode, app in apps.items():
            rk.K1.launches = 0
            with kernel_path(path if mode == "graph" else f"{path} (eager)"):
                app.tick()
            launches[mode] += rk.K1.launches
        frames_equal(apps["graph"], apps["eager"], label, frame)
    bands = n_bands(apps["graph"])
    k2 = K2_BY_PATH[path] - k2_before
    if k2 != k2_a_frame(apps["graph"]) * frames:
        raise AssertionError(f"{label}: K2 launched {k2} times in {frames} "
                             f"frames")
    for mode, app in apps.items():
        if launches[mode] != bands * frames:
            raise AssertionError(f"{label} ({mode}): K1 launched "
                                 f"{launches[mode]} times in {frames} "
                                 f"frames of {bands} bands")
        assert_no_flags(app, f"{label} ({mode})")
        app.renderer.debug_winner = False
    plan = next(iter(apps["graph"].draw._plans.values()))
    if plan.compiled is None:
        raise AssertionError(f"{label}: no CUDA graph was captured")
    kind = ("segmented graphs (shards, then bands)" if bands > 1
            else "graph")
    print(f"  {label}: {kind} replay and eager frames bit-equal, "
          f"framebuffer and winners, in each of {frames} frames; "
          f"{bands} K1 launch{'es' if bands > 1 else ''} a frame each; no "
          f"overflow flag at big scale 1")
    return apps["graph"], apps["eager"], launches["graph"]


def k2_a_frame(app) -> int:
    """K2's launches in a frame of ``app`` (one merged raster pass): one,
    or on a mesh two for each distinct card (the shards' stage, the
    bands' pass)."""
    plan = next(iter(app.draw._plans.values()))
    return 1 if plan.mesh is None else 2 * len(plan.devices)


def n_bands(app) -> int:
    mesh = app.renderer.mesh
    return 1 if mesh is None else mesh.shape["rows"]


def graph_turns(apps: dict, n: int, bands: int, label: str, card: str):
    """ms/frame of {"graph": app, "eager": app} in turns (``n`` fenced
    frames a turn, BAND_ROUNDS rounds), K1 launches held to ``bands`` a
    frame. Returns {mode: median}."""
    from myrenderer_tpu_torch.ops import raster_cuda as rk
    ms = {k: [] for k in apps}
    for _ in range(BAND_ROUNDS):
        for mode, app in apps.items():
            rk.K1.launches = 0
            ms[mode].append(time_frames(app, n))
            if rk.K1.launches != bands * n:
                raise AssertionError(f"{label} ({mode}): {rk.K1.launches} "
                                     f"K1 launches in {n} frames")
    med = {k: float(np.median(v)) for k, v in ms.items()}
    print(f"  {label}: graph {med['graph']:.3f} ms/frame (rounds "
          f"{', '.join(f'{r:.3f}' for r in ms['graph'])}), eager "
          f"{med['eager']:.3f} (rounds "
          f"{', '.join(f'{r:.3f}' for r in ms['eager'])}), {n} frames a "
          f"turn, median of {BAND_ROUNDS} rounds; {bands} K1 launch"
          f"{'es' if bands > 1 else ''} a frame; card: {card}")
    return med


def mesh_turns(single, banded, n: int, label: str, card: str, ref: str):
    """ms/frame of a one-device graph app and a 4-band graph app of one
    card in turns (``n`` fenced frames a turn); returns the medians."""
    apps = {1: single, 4: banded}
    ms, launches = time_in_turns(apps, n)
    med = {k: float(np.median(v)) for k, v in ms.items()}
    print(f"  {label}, graphs, in turns: {med[4]:.3f} ms/frame on 4 bands "
          f"of one card (rounds {', '.join(f'{r:.3f}' for r in ms[4])}; "
          f"segmented: shards, then bands) against {med[1]:.3f} on one "
          f"device (rounds {', '.join(f'{r:.3f}' for r in ms[1])}); "
          f"{launches[4] // (n * BAND_ROUNDS)} K1 launches a frame on 4 "
          f"bands; before sharding: {ref}; card: {card}")
    return med


def capture_line(app, label: str):
    """Print the capture time and pool memory of ``app``'s graph(s);
    returns (seconds, pool bytes)."""
    cf = next(iter(app.draw._plans.values())).compiled
    print(f"  {label}: capture {cf.capture_seconds:.3f} s, graph pool "
          f"{cf.pool_bytes / 2**20:.1f} MiB, {cf.k1_launches} K1 "
          f"launch(es) a replay")
    for device, segment, secs, pool in getattr(cf, "segments", ()):
        print(f"    {segment} graph on {device}: captured in {secs:.3f} s, "
              f"pool {pool / 2**20:.1f} MiB")
    return cf.capture_seconds, cf.pool_bytes


LADDER_SIZE = 256
LADDER_STARVED = 64   # pairs at big scale 1: 48 small fit, 192 tall do not


def ladder_app(tall: bool = False):
    """A 256x256 frame of 48 small triangles, three in each 16-pixel tile
    column of the first tile row (48 (tile, record) pairs); stretched x8
    in y (``tall``) each spans 4 tile rows (192 pairs). Returns an app
    (``tick``, ``window``, ``draw``, ``renderer``, ``tall()``)."""
    import types
    from myrenderer_tpu_torch import (BindingLayout, Core, Draw, Instance,
                                      Pipeline, Renderer, Surface,
                                      VertexBuffer, VertexLayout, math3d)
    from myrenderer_tpu_torch.ops.vertex_stage import matvec4
    from myrenderer_tpu_torch.renderer.pipeline import BUILTIN_TRANSFORM
    core = Core(fixed_timestep=1.0 / 60.0)
    window = core.create_window(LADDER_SIZE, LADDER_SIZE, "ladder")
    rend = Renderer(core, device="cuda")
    rend.adopt_window(window)
    layout = VertexLayout.create([("pos", 3), ("color", 3)])

    def vfn(ctx):
        p, c = ctx.attr("pos"), ctx.attr("color")
        one = torch.ones((), dtype=torch.float32, device=p.device)
        return (matvec4(ctx.world, torch.stack([p[0], p[1], p[2], one])),
                torch.stack([c[0], c[1], c[2], one]))

    pipe = Pipeline.create(rend, vertex_fn=vfn, vertex_layout=layout,
                           bindings=[BindingLayout(0, BUILTIN_TRANSFORM)])
    rows = []
    for col in range(LADDER_SIZE // 16):
        for k in range(3):
            x0 = (16 * col + 1 + 5 * k) / LADDER_SIZE
            for x, y in ((x0, 1.0), (x0 + 3.0 / LADDER_SIZE, 1.0),
                         (x0, 6.0)):
                rows.append([x, y / LADDER_SIZE, 1.0, 0.3 * k, 0.06 * col,
                             1.0])
    rows = np.asarray(rows, np.float32)
    vb = VertexBuffer.new(rend, 0, rows.shape[0] // 3, layout)
    vb.write_vertices(rows)
    node = Instance.create_node(rend, pipeline=pipe)
    node.get_backing().set_vertex_buffer(vb)
    surf = Surface.create_window_scene(rend, window, node)
    surf.set_perspective(math3d.projection_2d(
        left=0.0, right=1.0, bottom=1.0, top=0.0, near=0.1, far=2.0))
    draw = Draw.create(rend)
    rend.debug_winner = True

    def stretch():
        node.set_xform(np.diag([1.0, 8.0, 1.0, 1.0]).astype(np.float32))

    def tick():
        draw.begin()
        draw.clear((0.0, 0.0, 1.0, 1.0))
        draw.draw_surface(surf)
        draw.end()
        rend.update()

    if tall:
        stretch()
    return types.SimpleNamespace(tick=tick, window=window, draw=draw,
                                 renderer=rend, tall=stretch)


def ladder_on_card(card: str):
    """The capacity ladder on the card, through the pair capacity's
    starve hook: (1) the 1080p demo's first frame outgrows a starved
    capacity in the synchronous window: big scale 4, framebuffer equal
    to the unstarved frame's, winners equal to an unstarved frame at big
    scale 4 (ids shift with the scale: each batch reserves 2 * 128 *
    big_scale clip slots); (2) a late overflow in graph replays is
    detected through the asynchronous flag queue within OVERFLOW_WINDOW
    frames and the detecting frame re-rendered."""
    from myrenderer_tpu_torch.app.demo import DemoApp
    from myrenderer_tpu_torch.ops import raster
    frames = {}
    for name, scale, starve in (("unstarved", 1, None),
                                ("unstarved at big scale 4", 4, None),
                                ("starved", 1, 20_000)):
        app = DemoApp(1920, 1080, device="cuda")
        app.renderer.debug_winner = True
        app.draw.big_scale = scale
        raster._FORCE_PAIR_CAPACITY = starve
        try:
            app.tick()
        finally:
            raster._FORCE_PAIR_CAPACITY = None
        frames[name] = (app.draw.big_scale,
                        app.window.framebuffer.clone(),
                        app.draw.last_winners[0].clone(),
                        app.draw.last_overflow.cpu())
        del app
    scale, fb, win, ovf = frames["starved"]
    _s1, fb1, win1, _o = frames["unstarved"]
    _s4, _fb4, win4, _o = frames["unstarved at big scale 4"]
    if not (scale == 4 and not ovf.any()
            and torch.equal(fb.view(torch.int32), fb1.view(torch.int32))
            and torch.equal(win, win4)):
        raise AssertionError("the ladder did not recover the starved 1080p "
                             "frame bit for bit")
    print(f"  demo 1920x1080 frame 1 with 20,000 pair slots (60,872 "
          f"pairs): flagged, big scale 1 -> {scale}, re-rendered: "
          f"framebuffer bit-equal to the unstarved frame, winners equal "
          f"to the unstarved frame at big scale 4 (and "
          f"{'equal' if torch.equal(win, win1) else 'not equal'} to big "
          f"scale 1's: ids shift with the scale)")
    raster._FORCE_PAIR_CAPACITY = LADDER_STARVED
    try:
        late = ladder_app()
        for _ in range(6):
            late.tick()
        if late.draw.big_scale != 1 or late.draw.last_overflow.any():
            raise AssertionError("the small ladder scene overflowed")
        late.tall()
        detected = None
        for i in range(late.draw.OVERFLOW_WINDOW + 2):
            late.tick()
            if late.draw.big_scale > 1:
                detected = i
                break
        fresh = ladder_app(tall=True)
        fresh.tick()
    finally:
        raster._FORCE_PAIR_CAPACITY = None
    unstarved = ladder_app(tall=True)
    unstarved.tick()
    if detected is None or detected > late.draw.OVERFLOW_WINDOW:
        raise AssertionError(f"late overflow detected after {detected} "
                             "frames")
    for ref, name in ((fresh, "a fresh starved frame"),
                      (unstarved, "an unstarved frame")):
        frames_equal(late, ref, f"late ladder against {name}", detected)
    if late.draw.last_overflow.any() or fresh.draw.big_scale != 4:
        raise AssertionError("the ladder scene's re-render still overflows")
    print(f"  late overflow ({LADDER_SIZE}x{LADDER_SIZE}, 48 -> 192 pairs "
          f"against {LADDER_STARVED} slots) in graph replays: detected "
          f"through the asynchronous flag queue {detected} frame(s) after "
          f"the first flagged frame (OVERFLOW_WINDOW "
          f"{late.draw.OVERFLOW_WINDOW}), big scale -> "
          f"{late.draw.big_scale}, the detecting frame re-rendered: equal "
          f"to a fresh starved frame and to an unstarved one; card: {card}")


def uncapturable_raises():
    """A vertex function that reads a value back (``.item()``) makes
    Draw.end raise on the card: the capture fails and nothing falls back
    to an eager frame."""
    app = ladder_app()
    pipe = app.renderer.pipelines[0]
    inner = pipe.vertex_fn
    gain = torch.ones((), device="cuda")
    pipe.vertex_fn = lambda ctx: (inner(ctx)[0] * gain.item(), inner(ctx)[1])
    try:
        app.tick()
    except RuntimeError as e:
        print(f"  a vertex function calling .item(): Draw.end raised "
              f"RuntimeError ({str(e).splitlines()[0][:90]})")
        return
    raise AssertionError("a vertex function that reads back was captured "
                         "or rendered eagerly")


def no_sort(label: str, by_name: dict):
    """A single-device frame's trace holds no sort (K4 selects the
    straddlers and K5 bins without one); a mesh frame still sorts its
    shards' straddler candidates, and its sorts are printed. A graph
    replay's trace holds one K5 kernel a raster pass (one a frame, one a
    band on bands); an eager frame's cooperative launch does not show in
    the trace."""
    sorts = {k: n for k, (_t, n) in by_name.items() if SORTS[1] in k}
    print(f"  sort kernels in the {label} frames: {sum(sorts.values())}")
    if sorts and "bands" not in label:
        raise AssertionError(f"{label}: sort kernels in the trace: "
                             f"{sorted(sorts)}")
    if "graph" in label:
        k5 = sum(n for k, (_t, n) in by_name.items() if "bin_tiles_" in k)
        passes = (4 if "4 bands" in label else 1) * PROFILE_FRAMES
        print(f"  K5 kernels in the {label} frames: {k5} for {passes} "
              f"raster passes")
        if k5 != passes:
            raise AssertionError(f"{label}: {k5} K5 kernels for {passes} "
                                 f"raster passes")


def compiled_frame_phase(card: str, k1_alone: dict) -> dict:
    """Phase 11: the frame as one CUDA graph replay, against the eager
    frame."""
    from myrenderer_tpu_torch.app.demo import DemoApp
    from myrenderer_tpu_torch.app.stress import StressApp
    from myrenderer_tpu_torch.parallel import make_mesh
    out = {}
    dev = torch.device("cuda", 0)
    # (a) bit-equality, K1 launches a frame, no flag at big scale 1
    demo = graph_against_eager(lambda: DemoApp(1920, 1080, device="cuda"),
                               31, "demo 1920x1080, 31 frames",
                               "demo_1080p_graph")
    bands = graph_against_eager(
        lambda: DemoApp(1920, 1080, mesh=make_mesh(devices=[dev] * 4)),
        31, "demo 1920x1080 on 4 bands of one card, 31 frames",
        "demo_1080p_bands4_graph")
    out["demo_bands4_graph_launches"] = bands[2]
    # (b) host syncs a steady-state frame, by line
    syncs = {"demo graph": syncs_per_frame(demo[0]),
             "demo eager": syncs_per_frame(demo[1]),
             "demo 4 bands graph": syncs_per_frame(bands[0])}
    demo[0].renderer.strict_overflow = True
    syncs["demo graph, strict_overflow"] = syncs_per_frame(demo[0])
    demo[0].renderer.strict_overflow = False
    for label, counter in syncs.items():
        print(f"  host syncs a steady-state frame, {label}: "
              f"{sum(counter.values())}" + (" (" + ", ".join(
                  f"{site} x{c}" for site, c in sorted(counter.items()))
                  + ")" if counter else ""))
    want = {"demo graph": 0, "demo 4 bands graph": 0,
            "demo graph, strict_overflow": 1}
    for label, n in want.items():
        if sum(syncs[label].values()) != n:
            raise AssertionError(f"{label}: {sum(syncs[label].values())} "
                                 f"host syncs a frame, not {n}")
    out["syncs"] = {k: sum(v.values()) for k, v in syncs.items()}
    # (c) ms/frame in turns, graph against eager
    out["demo_ms"] = graph_turns({"graph": demo[0], "eager": demo[1]},
                                 BAND_FRAMES, 1, "demo 1920x1080", card)
    out["demo_bands4_ms"] = graph_turns(
        {"graph": bands[0], "eager": bands[1]}, BAND_FRAMES, 4,
        "demo 1920x1080 on 4 bands of one card", card)
    out["demo_bands4_vs_one"] = mesh_turns(
        demo[0], bands[0], BAND_FRAMES, "demo 1920x1080", card,
        "one graph, 3.369 ms/frame on 4 bands of one card and 2.471 on "
        "one device (H100 80GB HBM3, 700 W)")
    # (d) device busy share and device ops a frame, K1 inside the graph
    for label, app in (("demo graph", demo[0]), ("demo eager", demo[1]),
                       ("demo 4 bands graph", bands[0])):
        wall, busy, ops, by_name, _ = profile_frames(
            app, PROFILE_FRAMES, "trace_" + label.replace(" ", "_"))
        no_sort(label, by_name)
        k1 = by_name.get(next((k for k in by_name
                               if "raster_tile_kernel" in k), ""), (0, 0))
        k1_ms = k1[0] / 1e3 / k1[1] if k1[1] else None
        out[label] = {"wall_ms": wall, "busy_ms": busy, "ops": ops,
                      "k1_ms": k1_ms}
        print(f"  profiled {label}: {wall:.3f} ms/frame wall, device busy "
              f"{busy:.3f} ms/frame ({100.0 * busy / wall:.1f} %), "
              f"{ops:.0f} device ops/frame; K1 in these frames "
              + (f"{k1_ms:.4f} ms a launch ({k1[1]} launches)" if k1_ms else
                 "not seen by the profiler")
              + f" against {k1_alone['demo_1080p']:.4f} alone")
    for label, app in (("demo", demo[0]), ("demo 4 bands", bands[0])):
        out[f"{label} capture"] = capture_line(app, label)
    del demo, bands
    gc.collect()
    torch.cuda.empty_cache()
    # the stress scene
    stress = graph_against_eager(lambda: StressApp(device="cuda"), 20,
                                 "stress 3840x2160, 20 frames",
                                 "stress_4k_graph")
    syncs_s = syncs_per_frame(stress[0])
    print(f"  host syncs a steady-state frame, stress graph: "
          f"{sum(syncs_s.values())}")
    if sum(syncs_s.values()):
        raise AssertionError("the stress graph frame syncs the host")
    out["stress_ms"] = graph_turns({"graph": stress[0], "eager": stress[1]},
                                   BAND_STRESS_FRAMES, 1,
                                   "stress 3840x2160", card)
    out["stress capture"] = capture_line(stress[0], "stress")
    # the stress scene on 4 bands of one card: segmented graphs
    stress4 = graph_against_eager(
        lambda: StressApp(mesh=make_mesh(devices=[dev] * 4)), 20,
        "stress 3840x2160 on 4 bands of one card, 20 frames",
        "stress_4k_bands4_graph")
    out["stress_bands4_graph_launches"] = stress4[2]
    syncs_s4 = syncs_per_frame(stress4[0])
    print(f"  host syncs a steady-state frame, stress 4 bands graph: "
          f"{sum(syncs_s4.values())}")
    if sum(syncs_s4.values()):
        raise AssertionError("the 4-band stress graph frame syncs the host")
    out["syncs"]["stress 4 bands graph"] = 0
    out["stress capture 4 bands"] = capture_line(stress4[0],
                                                 "stress 4 bands")
    out["stress_bands4_vs_one"] = mesh_turns(
        stress[0], stress4[0], BAND_STRESS_FRAMES, "stress 3840x2160", card,
        "8.272 ms/frame on one device (H100 80GB HBM3, 700 W)")
    for label, app in (("stress graph", stress[0]),
                       ("stress eager", stress[1]),
                       ("stress 4 bands graph", stress4[0])):
        wall, busy, ops, by_name, _ = profile_frames(
            app, PROFILE_FRAMES, "trace_" + label.replace(" ", "_"))
        no_sort(label, by_name)
        k1 = by_name.get(next((k for k in by_name
                               if "raster_tile_kernel" in k), ""), (0, 0))
        k1_ms = k1[0] / 1e3 / k1[1] if k1[1] else None
        out[label] = {"wall_ms": wall, "busy_ms": busy, "ops": ops,
                      "k1_ms": k1_ms}
        print(f"  profiled {label}: {wall:.3f} ms/frame wall, device busy "
              f"{busy:.3f} ms/frame ({100.0 * busy / wall:.1f} %), "
              f"{ops:.0f} device ops/frame; K1 in these frames "
              + (f"{k1_ms:.4f} ms a launch ({k1[1] // PROFILE_FRAMES} a "
                 f"frame)" if k1_ms else "not seen by the profiler")
              + f" against {k1_alone['stress_4k']:.4f} alone (one launch "
                f"over the whole frame)")
        print_groups(by_name, PROFILE_FRAMES)
    del stress, stress4
    gc.collect()
    torch.cuda.empty_cache()
    # (e) the ladder, then (f) an uncapturable vertex function
    ladder_on_card(card)
    uncapturable_raises()
    return out


SCENE_FRAMES = 6      # frames of each behaviour scene's script


def behaviour_scenes(card: str) -> dict:
    """Phase 12 (a): every scripted scene of ``utils/scenes.py`` for
    SCENE_FRAMES frames in three ways on the card: CUDA graph replays
    (the default), eager frames and the oracle backend. After every
    frame the replay equals the eager frame bit for bit (framebuffer and
    each pass's winners) and its frame-wide winners equal the oracle's.
    Returns the K1 launches of the graph runs and, per scene, the graphs
    captured and their pool MiB."""
    from myrenderer_tpu_torch.ops import raster_cuda as rk
    from myrenderer_tpu_torch.utils import scenes
    launches, out = 0, {}
    for name, build in scenes.SCRIPTED.items():
        modes = {"graph": build("cuda", "auto"), "eager": build("cuda", "auto"),
                 "oracle": build("cuda", "oracle")}
        modes["eager"].draw._eager_frames = True
        graphs, differ = {}, []
        for k in range(SCENE_FRAMES):
            for mode, sc in modes.items():
                rk.K1.launches = 0
                with kernel_path("behaviour_scenes" if mode == "graph"
                             else f"behaviour_scenes ({mode})"):
                    sc.step(k)
                if mode == "graph":
                    launches += rk.K1.launches
            g, e, o = (modes[m] for m in ("graph", "eager", "oracle"))
            plan = g.draw._get_plan(g.window)
            if plan.compiled is None:
                raise AssertionError(f"{name}: frame {k} was not a CUDA "
                                     "graph")
            graphs[id(plan.compiled)] = plan.compiled.pool_bytes
            same = (bits_equal(g.window.framebuffer, e.window.framebuffer)
                    and len(g.draw.last_winners) == len(e.draw.last_winners)
                    and all(torch.equal(a, b) for a, b in
                            zip(g.draw.last_winners, e.draw.last_winners)))
            oracle = torch.equal(scenes.global_winners(g.draw),
                                 scenes.global_winners(o.draw))
            if not (same and oracle):
                differ.append((k, "graph == eager" if not same else "",
                               "winners == oracle" if not oracle else ""))
        for mode, sc in modes.items():
            assert_no_flags(sc, f"{name} ({mode})")
        pool = sum(graphs.values()) / 2**20
        held = sum(p.compiled.pool_bytes for p in
                   modes["graph"].draw._plans.values()
                   if p.compiled is not None) / 2**20
        out[name] = {"graphs": len(graphs), "pool_mib": pool,
                     "held_mib": held}
        shape = tuple(modes["graph"].window.framebuffer.shape)
        print(f"  {name}: {SCENE_FRAMES} frames (last {shape}), "
              f"{len(graphs)} CUDA graph(s) captured, pools {pool:.1f} MiB "
              f"({held:.1f} MiB still held by cached plans); "
              + ("graph == eager bit for bit and winners == oracle after "
                 "every frame" if not differ else f"DIFFER at {differ}"))
        if differ:
            raise AssertionError(f"{name}: frames differ {differ}")
        del modes
    print(f"  {len(scenes.SCRIPTED)} scenes; {launches} K1 launches in "
          f"their graph frames; card: {card}")
    return {"launches": launches, "scenes": out}


def k1_against_oracle_case(label, packed, bbox, H, W, depth0, y0=0,
                           band=None):
    """K1 over packed records (binned here, on rows [y0, y0 + band) of
    an H x W frame) against the full-frame oracle (``ops/raster_ref.py``)
    over the same records: winner diffs and num/den plane ulps must be 0
    (``tools/tpu_checks.py``'s checks); depth ulps are printed."""
    from myrenderer_tpu_torch.ops import raster
    from myrenderer_tpu_torch.ops import raster_cuda as rk
    band = H if band is None else band
    d_r, den_r, num_r, w_ids = oracle_frame(packed, bbox, H, W, depth0)
    rows = slice(y0, y0 + band)
    w_ids = w_ids[rows]
    index, starts, counts, overflow = raster.bin_packed(
        packed, packed[:, 15] > 0, bbox, band, W, y0=y0)
    if bool(overflow):
        raise AssertionError(f"{label}: binning overflowed")
    fused, winner = rk.rasterize_tiles(
        packed, index, starts, counts,
        torch.full((band, W), depth0, device=packed.device), y0=y0,
        vp_height=H)
    torch.cuda.synchronize()
    wd = int((winner != w_ids).sum())
    d_ulps = ulps(fused[0], d_r[rows])
    p_ulps = max(ulps(fused[1], den_r[rows]), ulps(fused[2:6],
                                                   num_r[:, rows]))
    err = float(max((fused[0] - d_r[rows]).abs().max(),
                    (fused[1] - den_r[rows]).abs().max(),
                    (fused[2:6] - num_r[:, rows]).abs().max()))
    print(f"  K1 against the oracle, {label}: {packed.shape[0]} records, "
          f"covered {int((winner >= 0).sum())}, winner diffs {wd}, depth "
          f"ulps {d_ulps}, num/den plane ulps {p_ulps}")
    if wd or p_ulps:
        raise AssertionError(f"K1 disagrees with the oracle ({label})")
    return {"winner_diffs": wd, "depth_ulps": d_ulps, "plane_ulps": p_ulps,
            "max_abs_err": err}


def k1_against_oracle(demo_records, card: str) -> dict:
    """Phase 12 (b), ``tools/tpu_checks.py`` check 1 on the card: K1
    against the full-frame oracle on seeded random batches (the check's
    ``random_triangles``, ``utils/trisets.py``) of T = 16, 128 and 512 at
    96x256, on the 1080p demo's frame-1 records, and on one band of them
    at y0 > 0."""
    from myrenderer_tpu_torch.ops import raster
    from myrenderer_tpu_torch.ops import raster_common as rc
    from myrenderer_tpu_torch.utils.trisets import random_triangles
    out = {}
    H, W = 96, 256
    for n, seed in ((16, 0), (128, 1), (512, 2)):
        clip, vary = (torch.from_numpy(a).to("cuda")
                      for a in random_triangles(n, seed))
        tc = rc.triangle_setup(clip, vary, torch.ones(n, dtype=torch.bool,
                                                      device="cuda"),
                               W, H, "back")
        out[f"T={n}"] = k1_against_oracle_case(
            f"T={n} {H}x{W}", rc.pack_coeffs_full(tc),
            raster.viewport_bbox(clip, W, H), H, W, 1.0)
    (packed, _valid, bbox), (H, W), depth0 = demo_records
    out["demo 1080p frame 1"] = k1_against_oracle_case(
        "demo 1920x1080 frame 1", packed, bbox, H, W, depth0)
    out["demo 1080p frame 1, band y0=540"] = k1_against_oracle_case(
        "demo 1920x1080 frame 1, rows 540-809", packed, bbox, H, W, depth0,
        y0=540, band=270)
    print(f"  card: {card}")
    return out


def bench_smoke():
    """Phase 13: ``bench_torch.main(["--smoke"])`` in this process, its
    lines echoed indented; returns (K1 launches, its row), and raises
    unless it exits 0 with a non-null, correct row."""
    import bench_torch
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench_torch.main(["--smoke"])
    lines = buf.getvalue().splitlines()
    for line in lines[:-1]:
        print(f"  | {line}")
    row = json.loads(lines[-1]) if lines else {}
    if rc != 0 or row.get("value") is None or row.get("correct") is not True:
        raise AssertionError(f"bench_torch.py --smoke failed (exit {rc}): "
                             f"{lines[-1] if lines else 'no output'}")
    from myrenderer_tpu_torch.ops import raster_cuda as rk
    return rk.K1.launches, row


@contextlib.contextmanager
def capture_setup_passes(store: list):
    """Record the segments of every K2 pass (``setup_pack_pass``) a frame
    makes, a list a pass."""
    from myrenderer_tpu_torch.ops import setup_pack as sp
    orig = sp.setup_pack_pass

    def wrapped(segments):
        segments = [sp.Segment(*s) for s in segments]
        store.append(segments)
        return orig(segments)

    sp.setup_pack_pass = wrapped
    try:
        yield
    finally:
        sp.setup_pack_pass = orig


def k2_bound(segments):
    """K2's bound over ``segments``: (ms, "bytes" or "operations", bytes).
    Each triangle's clip positions and varyings (96 bytes), valid flag
    and id (4 bytes, when given) are read once, its record (128), box
    (16) and flag (1) written once; K2_OPS_PER_TRI fp32 operations a
    triangle."""
    tris = sum(s.tri_clip.shape[0] for s in segments)
    nbytes = sum(s.tri_clip.shape[0]
                 * (96 + 1 + (0 if s.ids is None else 4) + 128 + 16 + 1)
                 for s in segments)
    ms_bytes = nbytes / 3.35e12 * 1e3
    ms_ops = K2_OPS_PER_TRI * tris / 67e12 * 1e3
    return ((ms_bytes, "bytes", nbytes) if ms_bytes >= ms_ops
            else (ms_ops, "operations", nbytes))


def check_k2_passes(passes, label: str) -> float:
    """Each pass of ``passes`` through K2 against its plain version, bit
    for bit; raises at a difference. Returns the largest finite
    difference."""
    from myrenderer_tpu_torch.utils.profiling import k2_pass_against_plain
    err = 0.0
    for j, segments in enumerate(passes):
        bad, e, launches = k2_pass_against_plain(segments)
        if bad:
            raise AssertionError(f"K2 differs from its plain version in "
                                 f"{bad} values: {label}, pass {j}")
        err = max(err, e)
        sizes = [s.tri_clip.shape[0] for s in segments]
        print(f"  {label}, pass {j}: {len(segments)} segments of {sizes} "
              f"triangles in {launches} launch(es): every lane, flag and box "
              f"bit-equal to the plain version")
    return err


def time_k2(passes, flush, label, card):
    """K2 alone over one frame's passes (its launches a frame) beside its
    plain version, in turns (plain, K2, K2, plain), then frame by frame
    with the L2 flushed, and a device copy of as many bytes; the timing
    launches are taken back out of K2's count."""
    from myrenderer_tpu_torch.ops import setup_pack as sp
    groups = [g for segments in passes for g in sp.launch_groups(segments)]
    segments = [s for pss in passes for s in pss]

    def k2_frame():
        for g in groups:
            sp.K2(g)

    def plain_frame():
        sp.setup_pack_pass_reference(segments)

    launches = sp.K2.launches
    p1 = time_call(plain_frame, 5)
    # the host queues a K2 launch (its segments' ctypes arguments) in about
    # as long as the card runs the demo's: spin ALONE_SPIN_MS a frame ahead
    # of it
    k_a, k_b = (time_call(k2_frame, 100, head_start=True,
                          spin_ms=ALONE_SPIN_MS) for _ in range(2))
    cold = time_cold(k2_frame, 50, flush, spin_ms=ALONE_SPIN_MS)
    sp.K2.launches = launches
    p2 = time_call(plain_frame, 5)
    ms, plain_ms = min(k_a, k_b), min(p1, p2)
    bound_ms, bound_by, nbytes = k2_bound(segments)
    # what the card reaches on the same bytes: a device copy reading half
    # of them and writing the other half
    src = torch.empty(nbytes // 8, dtype=torch.float32,
                      device=segments[0].tri_clip.device)
    dst = torch.empty_like(src)
    copy_ms = time_call(lambda: dst.copy_(src), 100, head_start=True)
    del src, dst
    tris = sum(s.tri_clip.shape[0] for s in segments)
    print(f"  K2 at {label} ({len(groups)} launch(es) a frame, "
          f"{len(segments)} segments, {tris} triangles, {nbytes} bytes): "
          f"{ms:.4f} ms a frame (runs {k_a:.4f}, {k_b:.4f}); bound "
          f"{bound_ms:.4f} ms ({bound_by}), {100.0 * bound_ms / ms:.1f} % of "
          f"it; frame by frame with the L2 flushed (median of 50): "
          f"{cold:.4f} ms ({100.0 * bound_ms / cold:.1f} %); a device copy of the same bytes {copy_ms:.4f} ms (K2 at "
          f"{100.0 * copy_ms / ms:.1f} % of its rate); plain version "
          f"{plain_ms:.3f} ms (runs {p1:.3f}, {p2:.3f}); card: {card}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "cold_ms": cold, "copy_ms": copy_ms,
            "bytes": nbytes,
            "triangles": tris, "launches_a_frame": len(groups)}


def k2_phase(dev, card: str, flush) -> dict:
    """Phase 14: K2 against its plain version, bit for bit, on random
    multi-segment passes, in graph replays and on the passes of the 1080p
    demo's, the 4K stress scene's, the sequential path's and the demo on
    4 bands' frame 1; K2 alone at the two cells' passes."""
    import itertools
    from myrenderer_tpu_torch.app.demo import DemoApp
    from myrenderer_tpu_torch.app.stress import StressApp
    from myrenderer_tpu_torch.ops import setup_pack as sp
    from myrenderer_tpu_torch.parallel import make_mesh
    from myrenderer_tpu_torch.utils.profiling import k2_graph_replays
    from myrenderer_tpu_torch.utils.trisets import setup_batch
    combos = list(itertools.product(("back", "front", "none"),
                                    (False, True), (None, 0.0, 2.0),
                                    (False, True)))
    sizes = [3000 + 17 * i for i in range(len(combos))]
    table = sp.new_table(37 + sum(sizes) + 11 * len(sizes), dev)
    segments, row = [], 37
    for i, ((cull, planar, bias, with_ids), T) in enumerate(zip(combos,
                                                                sizes)):
        clip, vary, valid, ids = (torch.from_numpy(a).to(dev)
                                  for a in setup_batch(T, 100 + i))
        if i % 2:
            # strided views: varyings stored channel-major, clip positions
            # inside a wider array
            vary = vary.transpose(1, 2).contiguous().transpose(1, 2)
            wide = torch.zeros((T, 3, 8), device=dev)
            wide[..., 2:6] = clip
            clip = wide[..., 2:6]
        segments.append(sp.Segment(table, row, clip, vary, valid, 1920, 1080,
                                   cull, bias, planar, 1000 + row,
                                   ids if with_ids else None))
        row += T + 11
    # passes of 6 segments, then all 36 (two launches)
    err = check_k2_passes([segments[i:i + 6] for i in range(0, 36, 6)]
                          + [segments], "random batches")
    print(f"  random batches: {len(combos)} (every cull mode, layout, z bias "
          f"and ids; 3,000-3,595 triangles with w at W_EPS, degenerate, "
          f"subnormal, huge and non-finite rows; half through strided "
          f"views; from row 37) in passes of 6 and of all {len(combos)}")
    del segments, table
    bad = k2_graph_replays(dev, replays=K2_REPLAYS)
    if bad:
        raise AssertionError(f"K2's graph replays differ from the plain "
                             f"version in {bad} values")
    print(f"  K2 as a CUDA graph of two passes (four segments into one "
          f"table, two into two), replayed {K2_REPLAYS} times with every "
          f"input rewritten in place: each replay bit-equal to the plain "
          f"version")

    def sequential():
        frame = sequential_scene("cuda")
        return types.SimpleNamespace(draw=frame.draw, tick=frame)

    shapes = {}
    for name, make, n_passes in (
            ("demo_1080p", lambda: DemoApp(1920, 1080, device="cuda"), 1),
            ("stress_4k", lambda: StressApp(device="cuda"), 1),
            ("sequential", sequential, 3),
            ("demo_1080p_bands4", lambda: DemoApp(
                1920, 1080, mesh=make_mesh(devices=[dev] * 4)), 2)):
        app = make()
        app.draw._eager_frames = True
        passes = []
        with capture_setup_passes(passes):
            app.tick()
        assert_no_flags(app, f"{name} frame 1 (K2's passes)")
        if len(passes) != n_passes:
            raise AssertionError(f"{name} frame 1 made {len(passes)} K2 "
                                 f"passes, not {n_passes}")
        err = max(err, check_k2_passes(passes, f"{name} frame 1"))
        if name in ("demo_1080p", "stress_4k"):
            shapes[name] = time_k2(passes, flush, f"{name} frame-1 passes",
                                   card)
        del app, passes
        gc.collect()
        torch.cuda.empty_cache()
    by_path = {k: v for k, v in K2_BY_PATH.items() if "(" not in k}
    print(f"  K2 launches by path (each counted from 0 around it): "
          f"{by_path}; card: {card}")
    return {"max_abs_err": err, "shapes": shapes,
            "random_batches": len(combos), "graph_replays": K2_REPLAYS}


@contextlib.contextmanager
def record_calls(module, name: str, store: list):
    """Record the arguments of every call of ``module.<name>`` while the
    block runs (each call still runs), bound to its parameter names."""
    import inspect
    orig = getattr(module, name)
    sig = inspect.signature(orig)

    def wrapped(*args, **kw):
        call = sig.bind(*args, **kw)
        call.apply_defaults()
        store.append(dict(call.arguments))
        return orig(*args, **kw)

    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, orig)


def against_plain(got, want):
    """(values whose bits differ, the largest finite difference) of the
    tensors ``got`` against ``want``, pair by pair."""
    bad, err = 0, 0.0
    for a, b in zip(got, want):
        if a.is_floating_point():
            differ = a.view(torch.int32) != b.view(torch.int32)
            both = torch.isfinite(a) & torch.isfinite(b)
            if bool(both.any()):
                err = max(err, float((a[both] - b[both]).abs().max()))
        else:
            differ = a != b
        bad += int(differ.sum())
    return bad, err


def k3_check(call):
    """K3 and its plain version on one call's inputs: (values that
    differ, the largest finite difference)."""
    from myrenderer_tpu_torch.ops import terrain_vertex as tv
    launches = tv.K3.launches
    got = tv.K3(**call)
    tv.K3.launches = launches
    want = tv.terrain_vertex_reference(**call)
    torch.cuda.synchronize()
    return against_plain(got[:3], want[:3])


def k4_check(call):
    """K4 and its plain version on one call's inputs: (values that
    differ, the largest finite difference)."""
    from myrenderer_tpu_torch.ops import raster_common as rc
    from myrenderer_tpu_torch.ops import straddlers as st
    launches = st.K4.launches
    got = st.K4(**call)
    st.K4.launches = launches
    want = rc.select_straddlers_reference(**call)
    torch.cuda.synchronize()
    return against_plain(got, want)


def k3_bound(calls):
    """K3's bound over ``calls``: (ms, "bytes" or "operations", bytes).
    Each instance's heights (4 bytes a quad), data transform and world
    matrix (128 bytes) are read once; each triangle's clip rows, varying
    rows and id (100 bytes) written once; K3_OPS_PER_TRI fp32 operations
    a triangle."""
    tris = sum(2 * c["heights"].numel() for c in calls)
    nbytes = sum(4 * c["heights"].numel() + 128 * c["heights"].shape[0]
                 + 100 * 2 * c["heights"].numel() for c in calls)
    ms_bytes = nbytes / 3.35e12 * 1e3
    ms_ops = K3_OPS_PER_TRI * tris / 67e12 * 1e3
    return ((ms_bytes, "bytes", nbytes) if ms_bytes >= ms_ops
            else (ms_ops, "operations", nbytes))


def k4_bound(calls):
    """K4's bound over ``calls``: (ms, "bytes", bytes). Each triangle's
    three w lanes lie 16 bytes apart in its 48-byte clip row, so every
    32-byte sector of the rows holds one: 48 bytes a triangle, with its
    valid flag 49. Then the rows this call's data selects (its first
    ``cap`` straddlers, and row T - 1 where slots are left) are read
    once, and the appendee block, ``sel`` and the flag written once. The
    comparisons (six a triangle) are far under the bytes."""
    nbytes = 0
    for c in calls:
        T, C, cap = c["tri_clip"].shape[0], c["tri_vary"].shape[-1], c["cap"]
        w = c["tri_clip"][..., 3]
        n = int((c["valid"] & (w > 1e-6).any(-1) & (w <= 1e-6).any(-1))
                .sum())
        row = 48 + 12 * C
        nbytes += (49 * T + (min(n, cap) + (n < cap)) * row
                   + 2 * cap * (row + 1) + 4 * cap + 1)
    return nbytes / 3.35e12 * 1e3, "bytes", nbytes


def time_alone(name, kernel, plain, calls, flush, bound, label, card):
    """``kernel`` alone over one frame's ``calls`` (its launches a frame)
    beside ``plain`` (plain, kernel, kernel, plain), then frame by frame
    with the L2 flushed; the timing launches are taken back out of the
    kernel's count."""
    def kernel_frame():
        for c in calls:
            kernel(**c)

    def plain_frame():
        for c in calls:
            plain(**c)

    launches = kernel.launches
    kernel_frame()
    per_frame = kernel.launches - launches
    if per_frame != len(calls):
        raise AssertionError(f"{name} launched {per_frame} times for "
                             f"{len(calls)} calls")
    p1 = time_call(plain_frame, 5)
    # the host queues a K4 call (its outputs, a ctypes call) in about as
    # long as the card runs it: spin ALONE_SPIN_MS a frame ahead of it
    k_a = time_call(kernel_frame, 100, head_start=True,
                    spin_ms=ALONE_SPIN_MS)
    k_b = time_call(kernel_frame, 100, head_start=True,
                    spin_ms=ALONE_SPIN_MS)
    cold = time_cold(kernel_frame, 50, flush, spin_ms=ALONE_SPIN_MS)
    kernel.launches = launches
    p2 = time_call(plain_frame, 5)
    ms, plain_ms = min(k_a, k_b), min(p1, p2)
    bound_ms, bound_by, nbytes = bound(calls)
    print(f"  {name} at {label} ({len(calls)} calls, {per_frame} launches "
          f"a frame, {nbytes} "
          f"bytes): {ms:.4f} ms a frame (runs {k_a:.4f}, {k_b:.4f}); bound "
          f"{bound_ms:.4f} ms ({bound_by}), {100.0 * bound_ms / ms:.1f} % "
          f"of it; frame by frame with the L2 flushed (median of 50): "
          f"{cold:.4f} ms ({100.0 * bound_ms / cold:.1f} %); plain version "
          f"{plain_ms:.3f} ms (runs {p1:.3f}, {p2:.3f}); card: {card}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "cold_ms": cold, "bytes": nbytes,
            "calls_a_frame": len(calls), "launches_a_frame": per_frame}


def k3_k4_phase(dev, card: str, flush) -> dict:
    """Phase 15: K3 and K4 against their plain versions, bit for bit, on
    random inputs and on every call of the 1080p demo's and the 4K stress
    scene's frame 1; each alone at those calls' shapes."""
    from myrenderer_tpu_torch.app.demo import DemoApp
    from myrenderer_tpu_torch.app.stress import StressApp
    from myrenderer_tpu_torch.ops import raster_common as rc
    from myrenderer_tpu_torch.ops import straddlers as st
    from myrenderer_tpu_torch.ops import terrain_vertex as tv
    from myrenderer_tpu_torch.utils.trisets import (
        STRADDLER_CASES, straddler_batch, straddler_case, terrain_inputs)
    err = {"K3": 0.0, "K4": 0.0}

    def held(name, check, call, label):
        bad, e = check(call)
        print(f"  {name} {label}: {bad} values differ")
        if bad:
            raise AssertionError(f"{name} differs from its plain version "
                                 f"({label})")
        err[name] = max(err[name], e)

    for size, instances in ((100, 1), (708, 1), (37, 3), (1, 1), (7, 3)):
        h, u, w = (torch.from_numpy(a).to(dev)
                   for a in terrain_inputs(size, instances, size))
        held("K3", k3_check, {"heights": h, "uniforms": u, "worlds": w,
                              "size": size},
             f"random terrain, size {size}, {instances} instance(s) (heights "
             f"with 0, 1 and subnormals, random worlds)")
    cases = {name: straddler_case(name) for name in STRADDLER_CASES}
    for name, (n, kw, cap) in {
            "T = 1,002,528, none": (0, {}, 128),
            "T = 1,002,528, 77 and NaN rows": (77, {"nan_rows": 40}, 128),
            "T = 1,002,528, cap + 1 and invalid": (129, {"invalid": 30},
                                                   128),
            "T = 1,002,528, 5,000 under cap 32,768": (5000, {}, 32768)
    }.items():
        cases[name] = (*straddler_batch(1_002_528, n + 11, n, **kw), cap)
    heavy = []          # the straddler-heavy 1M batches, timed alone below
    for name, (clip, vary, valid, cap) in cases.items():
        clip, vary, valid = (torch.from_numpy(a).to(dev)
                             for a in (clip, vary, valid))
        call = {"tri_clip": clip, "tri_vary": vary, "valid": valid,
                "cap": cap}
        held("K4", k4_check, call,
             f"random batch {name} (T {clip.shape[0]}, cap {cap})")
        if name.endswith(("cap + 1 and invalid", "under cap 32,768")):
            heavy.append((name, call))
    del cases
    bad = k4_graph_replays(dev, replays=K4_REPLAYS)
    print(f"  K4 as a CUDA graph of two calls (300,000 and 5,000 triangles, "
          f"cap 64), {K4_REPLAYS} replays, inputs rewritten in place: {bad} "
          f"values differ; scratch zeroed after; card: {card}")
    if bad:
        raise AssertionError("K4's graph replays differ from its plain "
                             "version")
    shapes = {"K3": {}, "K4": {}}
    for cell, make in (("demo_1080p", lambda: DemoApp(1920, 1080,
                                                       device="cuda")),
                       ("stress_4k", lambda: StressApp(device="cuda"))):
        app = make()
        app.draw._eager_frames = True
        k3_calls, k4_calls = [], []
        with record_calls(tv, "terrain_vertex", k3_calls), \
                record_calls(rc, "select_straddlers", k4_calls):
            app.tick()
        assert_no_flags(app, f"{cell} frame 1 (K3's and K4's calls)")
        if not (k3_calls and k4_calls):
            raise AssertionError(f"{cell} frame 1 made no K3 or K4 call")
        for c in k3_calls:
            held("K3", k3_check, c, f"{cell} frame 1, terrain size "
                 f"{c['size']}, {c['heights'].shape[0]} instance(s)")
        for c in k4_calls:
            held("K4", k4_check, c, f"{cell} frame 1, batch of "
                 f"{c['tri_clip'].shape[0]} triangles, cap {c['cap']}")
        shapes["K3"][cell] = time_alone(
            "K3", tv.K3, tv.terrain_vertex_reference, k3_calls, flush,
            k3_bound, f"{cell} frame-1 calls", card)
        shapes["K4"][cell] = time_alone(
            "K4", st.K4, rc.select_straddlers_reference, k4_calls, flush,
            k4_bound, f"{cell} frame-1 calls", card)
        del app, k3_calls, k4_calls
        gc.collect()
        torch.cuda.empty_cache()
    for name, call in heavy:
        label = f"1M, {name.removeprefix('T = 1,002,528, ')}"
        shapes["K4"][label] = time_alone(
            "K4", st.K4, rc.select_straddlers_reference, [call], flush,
            k4_bound, f"{name} (one call)", card)
    del heavy
    for name, by_path in (("K3", K3_BY_PATH), ("K4", K4_BY_PATH)):
        print(f"  {name} launches by path (each counted from 0 around it): "
              f"{ {k: v for k, v in by_path.items() if '(' not in k} }; "
              f"card: {card}")
    return {"max_abs_err": err, "shapes": shapes}


def k5_check(call, blocks=None):
    """K5 (on ``blocks`` blocks, else its own grid) and its plain version
    on one call's inputs: (values that differ, the largest absolute
    difference over the four results, each an integer or a flag)."""
    from myrenderer_tpu_torch.ops import binning
    launches = binning.K5.launches
    got = binning.K5(**call, blocks=blocks)
    binning.K5.launches = launches
    want = binning.bin_tiles_reference(**call)
    torch.cuda.synchronize()
    bad, _ = against_plain(got, want)
    err = max(float((a.long() - b.long()).abs().max()) if a.numel() else 0.0
              for a, b in zip(got, want))
    return bad, err


def k5_bound(calls):
    """K5's bound over ``calls``: (ms, "bytes", bytes). Each record's box
    (16 bytes) and valid flag are read once; each of the C slots of the
    index (4 bytes), each tile's start and count (8 bytes) and the flag
    written once. The comparisons and the integer arithmetic of a rect
    (some 30 operations a record) are far under the bytes."""
    from myrenderer_tpu_torch.ops.binning import tile_grid
    nbytes = 0
    for c in calls:
        nty, ntx = tile_grid(c["height"], c["width"])
        nbytes += (17 * c["valid"].shape[0] + 4 * c["capacity"]
                   + 8 * nty * ntx + 1)
    return nbytes / 3.35e12 * 1e3, "bytes", nbytes


def k5_phase(dev, card: str, flush) -> dict:
    """Phase 16: K5 against its plain version, bit for bit, on random
    boxes, on the 1080p demo's and the 4K stress scene's frame-1 binning
    calls (as they are, starved to a third of their pairs, and cut into
    four bands), on one block an SM where a block's records outgrow its
    record cache (the spans past 2^31 and the stress call), and as graph
    replays; K5 alone at those calls' shapes
    beside its plain version, its bound and torch.sort over the pass's
    int64 tile keys."""
    from myrenderer_tpu_torch.app.demo import DemoApp
    from myrenderer_tpu_torch.app.stress import StressApp
    from myrenderer_tpu_torch.ops import binning, raster
    from myrenderer_tpu_torch.utils.trisets import (BIN_CASES, bin_boxes,
                                                    bin_case)

    worst = [0.0]
    # one block an SM: more records a block than the 2,048 whose rects a
    # block keeps in shared memory, so its compaction reads the boxes again
    sms = binning.K5.occupancy(dev)[1]

    def held(call, label, blocks=None):
        bad, err = k5_check(call, blocks)
        worst[0] = max(worst[0], err)
        R = call["valid"].shape[0]
        grid = "" if blocks is None else f", {blocks} blocks"
        print(f"  K5 {label} ({R} records, {call['height']} x "
              f"{call['width']} from row {call['y0']}, capacity "
              f"{call['capacity']}{grid}): {bad} values differ, largest "
              f"difference {err}")
        if bad:
            raise AssertionError(f"K5 differs from its plain version "
                                 f"({label})")

    def pairs_of(call):
        return int(binning.bin_tiles_reference(**call)[2].sum())

    for name in BIN_CASES:
        valid, bbox, height, width, y0 = bin_case(name)
        call = {"valid": torch.from_numpy(valid).to(dev),
                "bbox": tuple(torch.from_numpy(bbox).to(dev)),
                "height": height, "width": width, "y0": y0,
                "capacity": raster.pair_capacity(valid.size)}
        held(call, f"random boxes, {name}")
        held({**call, "capacity": max(pairs_of(call) // 3, 1)},
             f"random boxes, {name}, starved to a third of its pairs")
    def uncached(call, label):
        R = call["valid"].shape[0]
        if R <= 2048 * sms:
            raise AssertionError(f"{label}: {R} records on {sms} blocks fit "
                                 "the blocks' record caches")
        held(call, f"{label}, one block an SM", sms)
        held({**call, "capacity": max(pairs_of(call) // 3, 1)},
             f"{label}, one block an SM, starved to a third of its pairs",
             sms)

    R = 2**31 // 4096 + 1
    call = {"valid": torch.ones(R, dtype=torch.bool, device=dev),
            "bbox": tuple(torch.tensor([-1.0, 1030.0, -1.0, 1030.0],
                                       device=dev)[:, None].expand(4, R)),
            "height": 1024, "width": 1024, "y0": 0,
            "capacity": raster.pair_capacity(R)}
    label = "every record over every tile, spans summing to 2^31 + 4,096"
    held(call, label)
    uncached(call, label)
    # the 8K frame on every block the card holds at once (the cooperative
    # launch's largest grid), its 127 chunks of 1,024 tiles
    resident = binning.K5.resident_blocks(dev)
    valid, bbox = bin_boxes(20_000, 14, 4320, 7680, big=0.01, full=1)
    call = {"valid": torch.from_numpy(valid).to(dev),
            "bbox": tuple(torch.from_numpy(bbox).to(dev)),
            "height": 4320, "width": 7680, "y0": 0,
            "capacity": raster.pair_capacity(valid.size)}
    launches = binning.K5.launches
    got = binning.K5(**call, blocks=resident)
    binning.K5.launches = launches
    want = binning.bin_tiles_reference(**call)
    torch.cuda.synchronize()
    bad, err = against_plain(got, want)
    worst[0] = max(worst[0], float(max(
        (a.long() - b.long()).abs().max() for a, b in zip(got, want))))
    print(f"  K5 on the 8K frame (20,000 boxes, 129,600 tiles) on all "
          f"{resident} resident blocks: {bad} values differ")
    if bad:
        raise AssertionError("K5 differs from its plain version on the "
                             "card's whole residency")
    bad = k5_graph_replays(dev, replays=K5_REPLAYS)
    print(f"  K5 as a CUDA graph of two passes (20,000 boxes of a 1920 x "
          f"1080 frame, the frame and its band from row 540), "
          f"{K5_REPLAYS} replays, boxes rewritten in place: {bad} values "
          f"differ; scratch zeroed after; card: {card}")
    if bad:
        raise AssertionError("K5's graph replays differ from its plain "
                             "version")
    shapes, phases = {}, {}
    for cell, make in (("demo_1080p", lambda: DemoApp(1920, 1080,
                                                       device="cuda")),
                       ("stress_4k", lambda: StressApp(device="cuda"))):
        app = make()
        app.draw._eager_frames = True
        calls = []
        with record_calls(binning, "bin_tiles", calls):
            app.tick()
        assert_no_flags(app, f"{cell} frame 1 (K5's calls)")
        if not calls:
            raise AssertionError(f"{cell} frame 1 made no binning call")
        for c in calls:
            c["bbox"] = tuple(c["bbox"])
            held(c, f"{cell} frame 1")
            pairs = pairs_of(c)
            held({**c, "capacity": pairs // 3},
                 f"{cell} frame 1, starved to a third of its {pairs} pairs")
            H = c["height"]
            for k in range(4):
                held({**c, "height": H // 4, "y0": k * H // 4},
                     f"{cell} frame 1, band {k} of 4")
            if c["valid"].shape[0] > 2048 * sms:
                uncached(c, f"{cell} frame 1")
        shapes[cell] = time_alone("K5", binning.K5,
                                  binning.bin_tiles_reference, calls, flush,
                                  k5_bound, f"{cell} frame-1 calls", card)
        # the phases of one launch (the median of five) on the cell's
        # largest call
        big = max(calls, key=lambda c: c["valid"].shape[0])
        launches = binning.K5.launches
        phases[cell] = binning.K5.phase_times(**big)
        binning.K5.launches = launches
        blocks = binning.K5.blocks(dev, big["valid"].shape[0])
        print(f"  K5 at {cell}'s largest call, {blocks} blocks: phases of "
              f"one launch (median of 5), ms: "
              + ", ".join(f"{k} {v:.4f}" for k, v in phases[cell].items())
              + f"; card: {card}")
        # torch.sort over the int64 tile keys of the pass's C slots, as the
        # plain version sorts them
        keys = [binning._slot_tiles(binning._spans(
            c["valid"], c["bbox"], c["height"], c["width"], c["y0"]),
            c["capacity"])[1] for c in calls]

        def sort_frame():
            for k in keys:
                torch.sort(k, stable=True)
        runs = [time_call(sort_frame, 20) for _ in range(2)]
        shapes[cell]["sort_keys_ms"] = min(runs)
        print(f"  torch.sort(stable=True) over the {cell} frame-1 pass's "
              f"{sum(k.numel() for k in keys)} int64 tile keys: "
              f"{min(runs):.4f} ms (runs {runs[0]:.4f}, {runs[1]:.4f}); "
              f"card: {card}")
        del app, calls, keys
        gc.collect()
        torch.cuda.empty_cache()
    by_path = {k: v for k, v in K5_BY_PATH.items() if "(" not in k}
    print(f"  K5 launches by path (each counted from 0 around it): "
          f"{by_path}; K5.resident_blocks (the largest grid its cooperative "
          f"launch takes): {resident}; card: {card}")
    return {"max_abs_err": worst[0], "shapes": shapes, "phases_ms": phases,
            "random_cases": len(BIN_CASES), "resident_blocks": resident}


def main() -> int:
    phase("1 environment")
    if not torch.cuda.is_available():
        print("CUDA is not available: this smoke test needs an NVIDIA card",
              file=sys.stderr)
        return 1
    from myrenderer_tpu_torch.app.demo import DemoApp
    from myrenderer_tpu_torch.ops import raster_cuda as rk
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"  torch {torch.__version__} (CUDA {torch.version.cuda}); "
          f"card: {card}")
    dev = torch.device("cuda", 0)

    phase("2 build K1, K2, K3, K4 and K5")
    from myrenderer_tpu_torch.ops import binning
    from myrenderer_tpu_torch.ops import setup_pack as sp
    from myrenderer_tpu_torch.ops import straddlers as st
    from myrenderer_tpu_torch.ops import terrain_vertex as tv
    kernels = {"K1": rk.K1, "K2": sp.K2, "K3": tv.K3, "K4": st.K4,
               "K5": binning.K5}
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(kernels)) as pool:
        list(pool.map(lambda k: k.build(), kernels.values()))
    print(f"  built in {time.perf_counter() - t0:.3f} s (nvcc, started "
          f"together: " + ", ".join(f"{name} {k.build_seconds:.3f} s"
                                   for name, k in kernels.items()) + ")")
    for name, kernel in kernels.items():
        for line in kernel.build_log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas {name}:", line.strip())

    phase("3 K1 against its plain version on the card")
    for n, seed, (H, W), dup in ((1, 0, (48, 160), 0), (7, 1, (48, 160), 0),
                                 (40, 2, (48, 160), 5),
                                 (200, 3, (48, 160), 50),
                                 (200, 4, (128, 128), 100)):
        compare_k1(bin_random(n, seed, H, W, dup, dev),
                   f"random n={n} dup={dup} {H}x{W}")
    crowded = bin_random(1200, 5, 64, 64, 400, dev, box=(16, 16))
    if int(crowded[3].max()) < 1000:
        raise AssertionError("the crowded set is not crowded")
    tile_stats(crowded, "crowded 64x64")
    compare_k1(crowded, "crowded tile 64x64 n=1200 dup=400")
    compare_k1(bin_random(120, 6, 47, 161, 20, dev), "ragged 47x161 n=120 "
               "dup=20")
    compare_k1(bin_random(200, 4, 128, 128, 100, dev, reverse=True),
               "random n=200 dup=100 128x128, ids falling")
    # the 1080p demo's frame-1 records, on the card and on the CPU
    frames = {}
    for d in ("cuda", "cpu"):
        app = DemoApp(1920, 1080, device=d)
        app.renderer.debug_winner = True
        app.draw._eager_frames = True
        store, records = [], []
        with capture_k1_inputs(store, records):
            app.tick()
        frames[d] = (app, trimmed(store[0]), records[0])
    k1_inputs = frames["cuda"][1]
    # frame-1 records of each scene, for the row-band phase
    band_frames = [("demo 1920x1080", frames["cuda"][2], (1080, 1920),
                    float(k1_inputs[4][0, 0]))]
    max_err = compare_k1(k1_inputs, "demo 1920x1080 frame 1")
    tile_stats(k1_inputs, "demo 1920x1080 frame 1")
    for name, a, b in zip(("records", "index", "starts", "counts"),
                          frames["cuda"][1], frames["cpu"][1]):
        if a.shape != b.shape or not torch.equal(
                a.cpu().view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"frame-1 {name} differ between the card "
                                 "and the CPU")
    rfused, rwinner = rk.rasterize_tiles_reference(*k1_inputs)
    cfused, cwinner = rk.rasterize_tiles_reference(*frames["cpu"][1])
    if not (torch.equal(rwinner.cpu(), cwinner) and torch.equal(
            rfused.cpu().view(torch.int32), cfused.view(torch.int32))):
        raise AssertionError("the plain version gives other bits on the "
                             "card than on the CPU")
    fb_gpu = frames["cuda"][0].window.framebuffer.cpu()
    fb_cpu = frames["cpu"][0].window.framebuffer
    if not torch.equal(fb_gpu.view(torch.int32), fb_cpu.view(torch.int32)):
        raise AssertionError("1080p frame 1 through K1 differs from the "
                             "CPU frame")
    for d, (app, _inputs, _records) in frames.items():
        assert_no_flags(app, f"demo 1920x1080 frame 1 ({d})")
    print("  frame-1 records, plain raster and framebuffer: card == CPU, "
          "bit for bit")

    phase("4 goldens through K1")
    for frame in (1, 31):
        app = DemoApp(128, 128, device="cuda")
        launches = rk.K1.launches
        app.run(frame)
        if rk.K1.launches - launches != frame:
            raise AssertionError("golden frames did not go through K1")
        assert_no_flags(app, f"demo 128x128, {frame} frames")
        assert_goldens_rule(app.window.read_pixels(),
                            f"demo_128_frame{frame}.png")

    phase("5 the slice: DemoApp 1920x1080")
    app = DemoApp(1920, 1080, device="cuda")
    app.tick()                          # warm-up, and the graph's capture
    plain = DemoApp(1920, 1080, device="cuda")
    plain.draw._eager_frames = True     # the plain version reads back
    with plain_k1():
        plain.tick()
        plain_ms_a = time_frames(plain, PLAIN_FRAMES)
    rk.K1.launches = 0
    with kernel_path("demo_1080p"):
        ms = time_frames(app, TIMED_FRAMES)
    path_launches = rk.K1.launches
    with plain_k1():
        plain_ms_b = time_frames(plain, PLAIN_FRAMES)
    plain_ms = (plain_ms_a + plain_ms_b) / 2
    if path_launches != TIMED_FRAMES:
        raise AssertionError(f"K1 launched {path_launches} times in "
                             f"{TIMED_FRAMES} frames")
    if K2_BY_PATH["demo_1080p"] != TIMED_FRAMES:
        raise AssertionError(f"K2 launched {K2_BY_PATH['demo_1080p']} "
                             f"times in {TIMED_FRAMES} frames")
    if K4_BY_PATH["demo_1080p"] != batches(app) * TIMED_FRAMES:
        raise AssertionError(f"K4 launched {K4_BY_PATH['demo_1080p']} "
                             f"times in {TIMED_FRAMES} frames")
    if K5_BY_PATH["demo_1080p"] != TIMED_FRAMES:
        raise AssertionError(f"K5 launched {K5_BY_PATH['demo_1080p']} "
                             f"times in {TIMED_FRAMES} one-pass frames")
    fb = app.window.framebuffer
    if fb.shape != (1080, 1920, 4) or not bool(torch.isfinite(fb).all()):
        raise AssertionError("1080p framebuffer is not finite f32[1080, "
                             "1920, 4]")
    # both apps rendered 1 + TIMED_FRAMES frames: same pixels
    if not torch.equal(fb.view(torch.int32),
                       plain.window.framebuffer.view(torch.int32)):
        raise AssertionError("K1 path and plain path frames differ")
    assert_no_flags(app, "demo 1920x1080")
    assert_no_flags(plain, "demo 1920x1080, plain path")
    print(f"  K1 path (CUDA graph replay): {ms:.3f} ms/frame over "
          f"{TIMED_FRAMES} frames, {path_launches} K1 launches, "
          f"{K2_BY_PATH['demo_1080p']} K2 launches, "
          f"{K3_BY_PATH['demo_1080p']} K3, {K4_BY_PATH['demo_1080p']} K4, "
          f"{K5_BY_PATH['demo_1080p']} K5 launches; "
          f"plain-version path (eager): {plain_ms:.3f} ms/frame "
          f"({plain_ms_a:.3f}, {plain_ms_b:.3f}); card: {card}")

    # K1 alone at the frame-1 shapes, beside its plain version
    # 256 MiB written between timed calls flushes the 50 MB L2
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    shapes = {"demo_1080p": time_k1(k1_inputs, 200, 10,
                                    "demo 1920x1080 frame-1 shapes", card,
                                    flush)}

    phase("6 the stress scene: StressApp 3840x2160")
    from myrenderer_tpu_torch.app.stress import StressApp
    # free the demo phases' device memory, so the stress peak is its own
    # (a renderer and its scene nodes form reference cycles: collect them)
    del (app, plain, frames, k1_inputs, rfused, rwinner, cfused, cwinner,
         fb, fb_gpu, fb_cpu)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    stress = StressApp(device="cuda")
    print(f"  triangles/frame: {stress.triangles} (built in "
          f"{time.perf_counter() - t0:.3f} s)")
    if stress.triangles != 1_012_528:
        raise AssertionError("the stress scene is not at full width")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    store, records = [], []
    launches = rk.K1.launches
    stress.draw._eager_frames = True    # frame 1 eager: its K1 inputs
    with capture_k1_inputs(store, records):
        stress.tick()                                   # warm-up, frame 1
    stress.draw._eager_frames = False
    torch.cuda.synchronize()
    # the scene's state plus frame 1's temporaries
    peak = torch.cuda.max_memory_allocated() - base
    if rk.K1.launches - launches != 1 or len(store) != 1:
        raise AssertionError("the stress frame is not one K1 launch")
    s_inputs = trimmed(store[0])
    band_frames.append(("stress 3840x2160", records[0], (2160, 3840),
                        float(s_inputs[4][0, 0])))
    print(f"  frame 1: {records[0][0].shape[0]} packed records, "
          f"{s_inputs[1].shape[0]} binned (tile, record) pairs, big scale "
          f"{stress.draw.big_scale}; peak device memory "
          f"{peak / 2**20:.1f} MiB (above {base / 2**20:.1f} MiB held "
          f"before the scene was built)")
    tile_stats(s_inputs, "stress 3840x2160 frame 1")
    s_err = compare_k1(s_inputs, "stress 3840x2160 frame 1")
    # frames 2 .. 1 + STRESS_PLAIN_FRAMES, kept to hold the plain path to
    for _ in range(STRESS_PLAIN_FRAMES):
        stress.tick()
    fb_k1 = stress.window.framebuffer.clone()
    rk.K1.launches = 0
    with kernel_path("stress_4k"):
        stress_ms = time_frames(stress, STRESS_FRAMES)
    stress_launches = rk.K1.launches
    if stress_launches != STRESS_FRAMES:
        raise AssertionError(f"K1 launched {stress_launches} times in "
                             f"{STRESS_FRAMES} stress frames")
    if K2_BY_PATH["stress_4k"] != STRESS_FRAMES:
        raise AssertionError(f"K2 launched {K2_BY_PATH['stress_4k']} times "
                             f"in {STRESS_FRAMES} stress frames")
    if K4_BY_PATH["stress_4k"] != batches(stress) * STRESS_FRAMES:
        raise AssertionError(f"K4 launched {K4_BY_PATH['stress_4k']} times "
                             f"in {STRESS_FRAMES} stress frames")
    if K5_BY_PATH["stress_4k"] != STRESS_FRAMES:
        raise AssertionError(f"K5 launched {K5_BY_PATH['stress_4k']} times "
                             f"in {STRESS_FRAMES} one-pass stress frames")
    fb = stress.window.framebuffer
    if fb.shape != (2160, 3840, 4) or not bool(torch.isfinite(fb).all()):
        raise AssertionError("stress framebuffer is not finite f32[2160, "
                             "3840, 4]")
    assert_no_flags(stress, "stress 3840x2160")
    plain = StressApp(device="cuda")
    plain.draw._eager_frames = True
    with plain_k1():
        plain.tick()
        stress_plain_ms = time_frames(plain, STRESS_PLAIN_FRAMES)
    if not bits_equal(plain.window.framebuffer, fb_k1):
        raise AssertionError("stress frame: the plain path differs from "
                             "the K1 path")
    assert_no_flags(plain, "stress 3840x2160, plain path")
    del plain
    print(f"  K1 path (CUDA graph replay): {stress_ms:.3f} ms/frame over "
          f"{STRESS_FRAMES} frames "
          f"({stress.triangles / stress_ms / 1e3:.2f} Mtri/s), "
          f"{stress_launches} K1 launches, {K2_BY_PATH['stress_4k']} K2 "
          f"launches, {K3_BY_PATH['stress_4k']} K3, "
          f"{K4_BY_PATH['stress_4k']} K4, {K5_BY_PATH['stress_4k']} K5 "
          f"launches; plain-version path: "
          f"{stress_plain_ms:.3f} ms/frame over {STRESS_PLAIN_FRAMES} "
          f"frames, last frame bit-equal to the K1 path's; card: {card}")
    shapes["stress_4k"] = time_k1(s_inputs, 50, 2,
                                  "stress 3840x2160 frame-1 shapes", card,
                                  flush)
    # where K1's time goes here: the same launch with every tile empty (its
    # memory floor: depth in, the seven planes out), and with every record
    # invalid (zhi = 0: each record is still copied and staged, and the
    # reject then drops it, so no list is walked)
    packed_s, index_s, starts_s, counts_s, depth_s = s_inputs
    empty = (packed_s, index_s, starts_s, torch.zeros_like(counts_s), depth_s)
    invalid = packed_s.clone()
    invalid[:, 15] = 0.0
    no_walk = (invalid, index_s, starts_s, counts_s, depth_s)
    launches = rk.K1.launches
    floor_ms = time_call(lambda: rk.K1(*empty), 50, head_start=True)
    no_walk_ms = time_call(lambda: rk.K1(*no_walk), 50, head_start=True)
    rk.K1.launches = launches
    floor_bytes = 8 * depth_s.numel() * 4 + 2 * counts_s.numel() * 4
    print(f"  K1 with every tile empty at these shapes: {floor_ms:.4f} ms for "
          f"{floor_bytes} bytes ({floor_bytes / 3.35e9:.4f} ms at 3.35 TB/s); "
          f"with every record invalid (copied and staged, no list walked): "
          f"{no_walk_ms:.4f} ms; card: {card}")
    shapes["stress_4k"]["empty_tiles_ms"] = floor_ms
    shapes["stress_4k"]["no_walk_ms"] = no_walk_ms
    del (s_inputs, store, empty, invalid, no_walk, packed_s, index_s,
         starts_s, counts_s, depth_s)
    # where the eager frame's time goes: a fence around each layer, then
    # the device's busy share over unfenced frames
    stress.draw._eager_frames = True
    totals = {}
    with fenced_layers(totals):
        fenced_ms = time_frames(stress, PROFILE_FRAMES)
    for label, total in sorted(totals.items(), key=lambda kv: -kv[1]):
        print(f"  fenced {label}: {total / PROFILE_FRAMES:.3f} ms/frame")
    print(f"  fenced total: {fenced_ms:.3f} ms/frame")
    wall_ms, device_ms, ops, by_name, _ = profile_frames(
        stress, PROFILE_FRAMES, "stress_trace")
    print(f"  profiled {PROFILE_FRAMES} frames: {wall_ms:.3f} "
          f"ms/frame wall, device busy {device_ms:.3f} "
          f"ms/frame ({100.0 * device_ms / wall_ms:.1f} % of the profiled "
          f"wall, {100.0 * device_ms / stress_ms:.1f} % of "
          f"the unprofiled frame), {ops:.0f} "
          f"device ops/frame (the design that gathered the records into a "
          f"[pairs, 32] stream: 8.93-9.12 ms/frame and 1,187 ops/frame on "
          f"an H100 80GB HBM3 at 700 W)")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"    {t / 1e3 / PROFILE_FRAMES:.3f} ms/frame  "
              f"{n // PROFILE_FRAMES:5d}x  {name[:70]}")
    print_groups(by_name, PROFILE_FRAMES)
    del stress

    phase("7 the sequential frame path on the card")
    frames = {d: sequential_scene(d) for d in ("cuda", "cpu")}
    rk.K1.launches = 0
    with kernel_path("sequential"):
        fb_gpu, win_gpu = frames["cuda"]()
    seq_launches = rk.K1.launches
    fb_cpu, win_cpu = frames["cpu"]()
    if seq_launches != 3 or len(win_gpu) != 3:
        raise AssertionError(f"sequential frame: {seq_launches} K1 launches "
                             "for 3 batches")
    if K2_BY_PATH["sequential"] != 3:
        raise AssertionError(f"sequential frame: {K2_BY_PATH['sequential']} "
                             "K2 launches for 3 passes")
    for d, frame in frames.items():
        assert_no_flags(frame, f"sequential frame ({d})")
    if not bits_equal(fb_gpu, fb_cpu) or not all(
            torch.equal(a.cpu(), b) for a, b in zip(win_gpu, win_cpu)):
        raise AssertionError("sequential frame differs from the CPU's")
    print(f"  {seq_launches} K1 launches for 3 batches; framebuffer and "
          f"every pass's winners equal the CPU frame's "
          f"({[int((w >= 0).sum()) for w in win_cpu]} covered pixels)")

    phase("8 fragment-stage texture sampling through K1")
    rk.K1.launches = 0
    with kernel_path("textured"):
        assert_goldens_rule(textured_quad_frame("cuda"), "textured_128.png")
    tex_launches = rk.K1.launches
    if tex_launches != 1:
        raise AssertionError("the textured frame did not go through K1")

    phase("9 the 8K demo frame 1: DemoApp 7680x4320")
    gc.collect()
    torch.cuda.empty_cache()
    app = DemoApp(7680, 4320, device="cuda")
    app.draw._eager_frames = True       # its K1 inputs
    store, records = [], []
    rk.K1.launches = 0
    with capture_k1_inputs(store, records), kernel_path("demo_8k"):
        app.tick()
    k8_launches = rk.K1.launches
    if k8_launches != 1 or len(store) != 1:
        raise AssertionError("the 8K frame is not one K1 launch")
    fb = app.window.framebuffer
    if fb.shape != (4320, 7680, 4) or not bool(torch.isfinite(fb).all()):
        raise AssertionError("8K framebuffer is not finite f32[4320, 7680, 4]")
    assert_no_flags(app, "demo 7680x4320")
    store[0] = trimmed(store[0])
    tile_stats(store[0], "demo 7680x4320 frame 1")
    k8_err = compare_k1(store[0], "demo 7680x4320 frame 1")
    shapes["demo_8k"] = time_k1(store[0], 50, 2,
                                "demo 7680x4320 frame-1 shapes", card, flush)
    band_frames.append(("demo 7680x4320", records[0], (4320, 7680),
                        float(store[0][4][0, 0])))
    del app, store, fb, records
    demo_records = band_frames[0][1:]     # phase 12's oracle check

    phase("10 row bands on the card")
    from myrenderer_tpu_torch.parallel import make_mesh
    # (a) K1 at y0 > 0 against its plain version, bit for bit
    band_err = max(banded_k1_checks(band_frames, 4), sliver_band_check(dev))
    del band_frames
    gc.collect()
    torch.cuda.empty_cache()
    # (b) the 1080p demo on 4 bands of this card against one device,
    # its pre-kernel stage in 4 shards
    pack_split(lambda: DemoApp(1920, 1080, mesh=make_mesh(devices=[dev] * 4)),
               "demo 1920x1080 on 4 bands")
    single, single_frames = single_demo_frames()
    banded = banded_demo([dev] * 4, single_frames, "demo 1920x1080 on 4 "
                         "bands of one card")
    # (d) one band a card, where there are several
    cards = None
    if torch.cuda.device_count() > 1:
        cards = bands_over_cards(single, single_frames, card_lines())
    # (e) ms/frame beside the single-device frame, in turns
    single.renderer.debug_winner = banded.renderer.debug_winner = False
    demo_ms, demo_launches = time_in_turns({1: single, 4: banded},
                                           BAND_FRAMES, path="demo_1080p")
    demo_bands_launches = demo_launches[4]
    demo_syncs = {1: syncs_per_frame(single), 4: syncs_per_frame(banded)}
    report_turns("demo 1920x1080", demo_ms, demo_launches, demo_syncs,
                 BAND_FRAMES, card)
    for n, app in ((1, single), (4, banded)):
        assert_no_flags(app, f"demo 1920x1080 on {n} bands")
    del single, banded, single_frames
    gc.collect()
    torch.cuda.empty_cache()
    # (c) the stress scene on 4 and 8 bands against one device, its
    # pre-kernel stage in 4 and 8 shards
    for n in (4, 8):
        pack_split(lambda: StressApp(mesh=make_mesh(devices=[dev] * n)),
                   f"stress 3840x2160 on {n} bands")
    gc.collect()
    torch.cuda.empty_cache()
    stress_apps = {1: StressApp(device="cuda")}
    stress_apps[1].renderer.debug_winner = True
    stress_apps[1].tick()
    frame1 = (stress_apps[1].window.framebuffer.clone(),
              stress_apps[1].draw.last_winners[0].clone())
    for n in (4, 8):
        app = StressApp(mesh=make_mesh(devices=[dev] * n))
        app.renderer.debug_winner = True
        app.tick()
        assert_same_frame(app, *frame1, f"stress 3840x2160 frame 1 on {n} "
                          "bands")
        stress_apps[n] = app
    for app in stress_apps.values():
        app.renderer.debug_winner = False
    stress_turn_ms, stress_launches_b = time_in_turns(
        stress_apps, BAND_STRESS_FRAMES, path="stress_4k")
    stress_syncs = {n: syncs_per_frame(a) for n, a in stress_apps.items()}
    report_turns("stress 3840x2160", stress_turn_ms, stress_launches_b,
                 stress_syncs, BAND_STRESS_FRAMES, card)
    # where the banded frames' time goes: phase 6's fences, the apps in
    # turns, each layer's least ms/frame over the rounds
    for n, app in stress_apps.items():
        assert_no_flags(app, f"stress 3840x2160 on {n} bands")
        app.draw._eager_frames = True   # the fences need the eager frame
    layers = {n: {} for n in stress_apps}
    for _ in range(BAND_ROUNDS):
        for n, app in stress_apps.items():
            totals = {}
            with fenced_layers(totals):
                totals["total"] = (time_frames(app, PROFILE_FRAMES)
                                   * PROFILE_FRAMES)
            for label, total in totals.items():
                layers[n][label] = min(layers[n].get(label, np.inf),
                                       total / PROFILE_FRAMES)
    labels = {label for by_label in layers.values() for label in by_label}
    for label in sorted(labels, key=lambda k: -layers[4].get(k, 0.0)):
        print(f"  stress 3840x2160 fenced {label} (least of "
              f"{BAND_ROUNDS} rounds): " + ", ".join(
                  f"{layers[n].get(label, 0.0):.3f}" for n in stress_apps)
              + f" ms/frame on {', '.join(map(str, stress_apps))} bands")
    del stress_apps, app, frame1
    gc.collect()
    torch.cuda.empty_cache()

    phase("11 the compiled frame: one CUDA graph replay a frame")
    graph = compiled_frame_phase(card, {k: v["ms"]
                                        for k, v in shapes.items()})

    phase("12 the behaviour scenes on the card")
    gc.collect()
    torch.cuda.empty_cache()
    scenes = behaviour_scenes(card)
    oracle = k1_against_oracle(demo_records, card)
    del demo_records

    phase("13 the benchmark's smoke rows")
    gc.collect()
    torch.cuda.empty_cache()
    rk.K1.launches = 0
    with kernel_path("bench_smoke"):
        bench_launches, bench_row = bench_smoke()
    print(f"  bench_torch.py --smoke: {bench_row['metric']} "
          f"{bench_row['value']:.2f} fps, correct, {bench_launches} K1 "
          f"launches; card: {card}")

    phase("14 K2 against its plain version on the card")
    gc.collect()
    torch.cuda.empty_cache()
    k2 = k2_phase(dev, card, flush)

    phase("15 K3 and K4 against their plain versions on the card")
    gc.collect()
    torch.cuda.empty_cache()
    k34 = k3_k4_phase(dev, card, flush)

    phase("16 K5 against its plain version on the card")
    gc.collect()
    torch.cuda.empty_cache()
    k5 = k5_phase(dev, card, flush)

    phase("17 results")
    by_path = {"demo_1080p": path_launches, "stress_4k": stress_launches,
               "sequential": seq_launches, "textured": tex_launches,
               "demo_8k": k8_launches,
               "demo_1080p_bands4": demo_bands_launches,
               "stress_4k_bands4": stress_launches_b[4],
               # phase 11: 4 bands of one card as segmented graphs
               "demo_1080p_bands4_graph": graph["demo_bands4_graph_launches"],
               "stress_4k_bands4_graph":
                   graph["stress_bands4_graph_launches"],
               "behaviour_scenes": scenes["launches"],
               "bench_smoke": bench_launches}
    if cards is not None:
        # phase 10 (d): one band a card, per-card segmented graphs
        by_path["demo_1080p_cards_graph"] = cards["demo_launches"]
        by_path["stress_4k_cards_graph"] = cards["stress_launches"]
    # K2 on every path K1 is counted on (the eager and oracle twins of
    # phases 11-12 are comparisons, not paths)
    k2_by_path = {k: v for k, v in K2_BY_PATH.items() if "(" not in k}
    missing = [k for k in ("demo_1080p", "stress_4k", "sequential",
                           "textured", "demo_8k", "demo_1080p_bands1",
                           "demo_1080p_bands4", "stress_4k_bands4",
                           "stress_4k_bands8", "demo_1080p_graph",
                           "demo_1080p_bands4_graph", "stress_4k_graph",
                           "stress_4k_bands4_graph", "behaviour_scenes",
                           "bench_smoke") if not k2_by_path.get(k)]
    if missing:
        raise AssertionError(f"K2 was not launched on {missing}")
    # K3 on every path that draws a terrain, K4 on every path without a
    # mesh (a mesh frame merges its shards' straddler candidates in torch)
    k3_by_path = {k: v for k, v in K3_BY_PATH.items() if "(" not in k}
    k4_by_path = {k: v for k, v in K4_BY_PATH.items() if "(" not in k}
    terrain_paths = ("demo_1080p", "stress_4k", "demo_8k",
                     "demo_1080p_bands1", "demo_1080p_bands4",
                     "stress_4k_bands1", "stress_4k_bands4",
                     "stress_4k_bands8", "demo_1080p_graph",
                     "demo_1080p_bands4_graph", "stress_4k_graph",
                     "stress_4k_bands4_graph", "bench_smoke")
    single_paths = ("demo_1080p", "stress_4k", "sequential", "textured",
                    "demo_8k", "demo_1080p_bands1", "stress_4k_bands1",
                    "demo_1080p_graph", "stress_4k_graph",
                    "behaviour_scenes", "bench_smoke")
    # K5 on every path that bins (every path K1 is counted on, a mesh's
    # bands included)
    k5_by_path = {k: v for k, v in K5_BY_PATH.items() if "(" not in k}
    bin_paths = ("demo_1080p", "stress_4k", "sequential", "textured",
                 "demo_8k", "demo_1080p_bands1", "demo_1080p_bands4",
                 "stress_4k_bands1", "stress_4k_bands4", "stress_4k_bands8",
                 "demo_1080p_graph", "demo_1080p_bands4_graph",
                 "stress_4k_graph", "stress_4k_bands4_graph",
                 "behaviour_scenes", "bench_smoke")
    for name, counts, paths in (("K3", k3_by_path, terrain_paths),
                                ("K4", k4_by_path, single_paths),
                                ("K5", k5_by_path, bin_paths)):
        missing = [k for k in paths if not counts.get(k)]
        if missing:
            raise AssertionError(f"{name} was not launched on {missing}")
    print(json.dumps({"kernels": [{
        "name": "K1 raster_tile",
        "route": "cuda",
        "source": "myrenderer_tpu_torch/csrc/raster_tile.cu",
        "replaces": "myrenderer_tpu/ops/raster_pallas.py:659",
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "max_abs_err": max(max_err, s_err, k8_err, band_err),
        # the main path's shapes (the 1080p demo's frame 1); every shape
        # timed is under "shapes"
        "ms": shapes["demo_1080p"]["ms"],
        "plain_ms": shapes["demo_1080p"]["plain_ms"],
        "bound_ms": shapes["demo_1080p"]["bound_ms"],
        "bound_by": shapes["demo_1080p"]["bound_by"],
        "library_ms": None,       # no PyTorch call computes K1's function
        "shapes": shapes,
        "frame_ms": ms,
        "plain_frame_ms": plain_ms,
        "stress_frame_ms": stress_ms,
        "stress_plain_frame_ms": stress_plain_ms,
        "stress_peak_mib": peak / 2**20,
        "demo_bands4_frame_ms": float(np.median(demo_ms[4])),
        "stress_bands4_frame_ms": float(np.median(stress_turn_ms[4])),
        "stress_bands8_frame_ms": float(np.median(stress_turn_ms[8])),
        # phase 10 (d): one band a card (null with one card)
        "cards": cards,
        "build_s": rk.K1.build_seconds,
        # phase 11: ms/frame graph against eager (medians in turns),
        # host syncs a steady-state frame, K1 inside the graph
        "graph": graph,
        # phase 12: graphs captured and pool MiB per behaviour scene, and
        # K1 against the full-frame oracle
        "behaviour_scenes": scenes["scenes"],
        "oracle_check": oracle,
    }, {
        "name": "K2 setup_pack",
        "route": "cuda",
        "source": "myrenderer_tpu_torch/csrc/setup_pack.cu",
        # no Pallas kernel: the JAX frame's per-batch setup + pack, which
        # XLA fuses
        "replaces": "myrenderer_tpu/renderer/draw.py:327",
        "launches": sum(k2_by_path.values()),
        "launches_by_path": k2_by_path,
        "max_abs_err": k2["max_abs_err"],
        # the main path's shapes (the 1080p demo's frame 1: its one
        # launch); the stress frame's under "shapes"
        "ms": k2["shapes"]["demo_1080p"]["ms"],
        "plain_ms": k2["shapes"]["demo_1080p"]["plain_ms"],
        "bound_ms": k2["shapes"]["demo_1080p"]["bound_ms"],
        "bound_by": k2["shapes"]["demo_1080p"]["bound_by"],
        "library_ms": None,       # no PyTorch call computes K2's function
        "shapes": k2["shapes"],
        "random_batches": k2["random_batches"],
        "graph_replays": k2["graph_replays"],
        "build_s": sp.K2.build_seconds,
    }, {
        "name": "K3 terrain_vertex",
        "route": "cuda",
        "source": "myrenderer_tpu_torch/csrc/terrain_vertex.cu",
        # no Pallas kernel: the JAX package's whole-stream terrain vertex
        # function, which XLA fuses
        "replaces": "myrenderer_tpu/content/terrain.py:84",
        "launches": sum(k3_by_path.values()),
        "launches_by_path": k3_by_path,
        "max_abs_err": k34["max_abs_err"]["K3"],
        # the main path's shapes (the 1080p demo's frame 1); the stress
        # frame's under "shapes"
        "ms": k34["shapes"]["K3"]["demo_1080p"]["ms"],
        "plain_ms": k34["shapes"]["K3"]["demo_1080p"]["plain_ms"],
        "bound_ms": k34["shapes"]["K3"]["demo_1080p"]["bound_ms"],
        "bound_by": k34["shapes"]["K3"]["demo_1080p"]["bound_by"],
        "library_ms": None,       # no PyTorch call computes K3's function
        "shapes": k34["shapes"]["K3"],
        "build_s": tv.K3.build_seconds,
    }, {
        "name": "K4 straddlers",
        "route": "cuda",
        "source": "myrenderer_tpu_torch/csrc/straddlers.cu",
        # no Pallas kernel: the JAX package's select_straddlers, which XLA
        # fuses
        "replaces": "myrenderer_tpu/ops/raster_common.py:347",
        "launches": sum(k4_by_path.values()),
        "launches_by_path": k4_by_path,
        "max_abs_err": k34["max_abs_err"]["K4"],
        # the main path's shapes (the 1080p demo's frame 1: its 2 batches);
        # the stress frame's under "shapes"
        "ms": k34["shapes"]["K4"]["demo_1080p"]["ms"],
        "plain_ms": k34["shapes"]["K4"]["demo_1080p"]["plain_ms"],
        "bound_ms": k34["shapes"]["K4"]["demo_1080p"]["bound_ms"],
        "bound_by": k34["shapes"]["K4"]["demo_1080p"]["bound_by"],
        "library_ms": None,       # no PyTorch call computes K4's function
        "shapes": k34["shapes"]["K4"],
        "build_s": st.K4.build_seconds,
    }, {
        "name": "K5 bin_tiles",
        "route": "cuda",
        "source": "myrenderer_tpu_torch/csrc/bin_tiles.cu",
        # no Pallas kernel: the JAX package's bin_packed, whose sort XLA
        # runs
        "replaces": "myrenderer_tpu/ops/raster_pallas.py:321",
        # one launch a raster pass
        "launches": sum(k5_by_path.values()),
        "launches_by_path": k5_by_path,
        "max_abs_err": k5["max_abs_err"],
        # the main path's shapes (the 1080p demo's frame 1: its one pass);
        # the stress frame's under "shapes"
        "ms": k5["shapes"]["demo_1080p"]["ms"],
        "plain_ms": k5["shapes"]["demo_1080p"]["plain_ms"],
        "bound_ms": k5["shapes"]["demo_1080p"]["bound_ms"],
        "bound_by": k5["shapes"]["demo_1080p"]["bound_by"],
        "library_ms": None,       # no PyTorch call computes K5's function
        # torch.sort over the pass's int64 tile keys: the sort K5 replaces
        "sort_keys_ms": k5["shapes"]["demo_1080p"]["sort_keys_ms"],
        "shapes": k5["shapes"],
        "random_cases": k5["random_cases"],
        "resident_blocks": k5["resident_blocks"],
        "phases_ms": k5["phases_ms"],
        "build_s": binning.K5.build_seconds,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
