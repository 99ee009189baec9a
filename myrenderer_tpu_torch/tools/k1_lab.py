"""K1 lab on one NVIDIA card: variants of K1 timed against its source,
and a per-CTA timeline of the kernel.

Run from the repository root:

    python -m myrenderer_tpu_torch.tools.k1_lab [--variants a,b,...]

Each variant is a copy of ``csrc/raster_tile.cu`` with a few text edits
(``VARIANTS``); the source as it stands is ``source``. All are built with
K1's own nvcc flags, in parallel, into ``build/k1_lab/``. At the frame-1
inputs of the 1920x1080 demo, the 3840x2160 stress scene and the
7680x4320 demo, every variant's output is held bit for bit against the
source's, then all are timed in turn (three rounds of 200, 50 and 50
back-to-back launches, CUDA events), and call by call with a 256 MiB
write flushing the 50 MB L2 before each call (the median of as many). The variants record designs that
were measured and not kept: an edit that no longer applies to the source
raises, and is then updated or dropped.

First, on 12 sets of 50,000 thin slivers (``utils.trisets.band_slivers``)
in the last 270-row band of a 7680x4320 frame (y0 = 4050), the source is
held bit for bit against K1's plain version, and each of ``FAULTS``, a
reject fault planted at the band offset, reports the pixels it changes;
a fault in ``MUST_CATCH`` that changes none raises.

The timeline is the source with a stamp of the card's global timer at
the start and end of every CTA: per shape, the kernel's span, the CTAs'
durations (empty tiles, the longest tile), and how many CTAs, and how
many heavy ones (>= 128 records), are running through each twentieth of
the span.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..ops import raster_cuda as rk
from ..ops.cuda_build import BUILD_DIR, NVCC_FLAGS

LAB_DIR = os.path.join(BUILD_DIR, "k1_lab")


def _edit(src: str, old: str, new: str) -> str:
    if old not in src:
        raise ValueError(f"a variant's edit no longer applies: {old!r}")
    return src.replace(old, new)


def _edits(*pairs):
    def apply(src):
        for old, new in pairs:
            src = _edit(src, old, new)
        return src
    return apply


# output stores marked evict-first (st.global.cs)
_STREAM_STORES = [
    ("*reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);",
     "__stcs(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));"),
    ("fused[pix + k] = best_z[k];", "__stcs(fused + pix + k, best_z[k]);"),
    ("fused[hw + pix + k] = den[k];", "__stcs(fused + hw + pix + k, den[k]);"),
    ("fused[(2 + ch) * hw + pix + k] = num[ch][k];",
     "__stcs(fused + (2 + ch) * hw + pix + k, num[ch][k]);"),
    ("winner[pix + k] = best_id[k];", "__stcs(winner + pix + k, best_id[k]);"),
]

# the design before the thresholds were staged: the walk works out each
# record's three top-left thresholds and zhi - 1 itself, and the registers
# are not capped (56 without a cap)
_WALK_THRESHOLDS = [
    ("__launch_bounds__(THREADS, 9)", "__launch_bounds__(THREADS)"),
    ("constexpr int SLOT_W = RAW + 4;", "constexpr int SLOT_W = RAW;"),
    ("""        if (keep) {
          *reinterpret_cast<float4*>(raw[c % SLOTS][r] + RAW) = make_float4(
              threshold(q[0], q[1]), threshold(q[3], q[4]),
              threshold(q[6], q[7]), __fsub_rn(q[15], 1.0f));
        }
""", ""),
    ("const float4 q0 = q[0], q1 = q[1], q2 = q[2], t = q[4];",
     "const float4 q0 = q[0], q1 = q[1], q2 = q[2];\n"
     "      const float4 t = make_float4(threshold(q0.x, q0.y),\n"
     "          threshold(q0.w, q1.x), threshold(q1.z, q1.w), 0.0f);"),
    ("const float lo = q[4].w;", "const float lo = __fsub_rn(q3.w, 1.0f);"),
]

# the next two list entries read one iteration ahead
_PREFETCH_LIST = [
    ("""    for (int i = 0; i < nmax; i += 2) {
      if (i >= nt) continue;
      const int r0 = list[i];
      const int r1 = list[min(i + 1, nt - 1)];
""", """    int next0 = list[0], next1 = list[min(1, max(nt - 1, 0))];
    for (int i = 0; i < nmax; i += 2) {
      if (i >= nt) continue;
      const int r0 = next0;
      const int r1 = next1;
      next0 = list[min(i + 2, nt - 1)];
      next1 = list[min(i + 3, nt - 1)];
"""),
]

# the step before: every warp tests each record of the chunk against its
# own 4 sub-blocks after the chunk's barrier, and stages the thresholds of
# the records it keeps
_LIST_STAGING = [
    ("  __shared__ unsigned short keeps[SLOTS][CHUNK];  // sub-blocks kept, per record\n",
     ""),
    ("""\
    cp_async_wait_all();        // this thread's copies of chunk c
    // thread t tests record t, its own copy, against the 16 sub-blocks
    // and stages its constants, while other warps may still walk c - 1
    {
      unsigned keep = 0;
      if (c * CHUNK + tid < n) {
        const float* q = raw[c % SLOTS][tid];
        if (q[15] > 0.0f) keep = (1u << SUBS) - 1u;
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          const float a = q[3 * e], b = q[3 * e + 1], cc = q[3 * e + 2];
          const float lim = reject_limit(a, b, cc, xmax, ymax);
#pragma unroll
          for (int sb = 0; sb < SUBS; ++sb) {
            const float xc = __int2float_rn(blockIdx.x * TILE_W +
                                            (sb % SUBS_X) * SUB) + 0.5f * SUB;
            const float yc = __int2float_rn(y0 + blockIdx.y * TILE_H +
                                            (sb / SUBS_X) * SUB) + 0.5f * SUB;
            if (plane(a, b, cc, xc, yc) < lim) keep &= ~(1u << sb);
          }
        }
        if (keep) {
          *reinterpret_cast<float4*>(raw[c % SLOTS][tid] + RAW) = make_float4(
              threshold(q[0], q[1]), threshold(q[3], q[4]),
              threshold(q[6], q[7]), __fsub_rn(q[15], 1.0f));
        }
      }
      keeps[c % SLOTS][tid] = static_cast<unsigned short>(keep);
    }
    __syncthreads();            // everyone's; chunk c - 1's slot is free
    if (c + 1 < nchunks) issue(c + 1);
    const int m = min(CHUNK, n - c * CHUNK);
    const float (*slot)[SLOT_W] = raw[c % SLOTS];
    const int* rows = srow[c % SLOTS];
    // this warp's lists, from the kept sub-blocks of each record
    int cnt[WARP_SUBS] = {0, 0, 0, 0};
    for (int g = 0; g * 32 < m; ++g) {
      const int r = g * 32 + lane;
      const unsigned keep =
          r < m ? (keeps[c % SLOTS][r] >> (warp * WARP_SUBS)) & 0xfu : 0u;
""", """\
    cp_async_wait_all();        // this thread's copies of chunk c
    __syncthreads();            // everyone's; chunk c - 1's slot is free
    if (c + 1 < nchunks) issue(c + 1);
    const int m = min(CHUNK, n - c * CHUNK);
    const float (*slot)[SLOT_W] = raw[c % SLOTS];
    const int* rows = srow[c % SLOTS];
    // this warp's lists: lane r of each 32-record group tests record
    // g * 32 + r against the warp's sub-blocks
    int cnt[WARP_SUBS] = {0, 0, 0, 0};
    for (int g = 0; g * 32 < m; ++g) {
      const int r = g * 32 + lane;
      unsigned keep = 0;
      if (r < m) {
        const float* q = slot[r];
        if (q[15] > 0.0f) keep = (1u << WARP_SUBS) - 1u;
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          const float a = q[3 * e], b = q[3 * e + 1], cc = q[3 * e + 2];
          const float lim = reject_limit(a, b, cc, xmax, ymax);
#pragma unroll
          for (int j = 0; j < WARP_SUBS; ++j) {
            const int sb = warp * WARP_SUBS + j;
            const float xc = __int2float_rn(blockIdx.x * TILE_W +
                                            (sb % SUBS_X) * SUB) + 0.5f * SUB;
            const float yc = __int2float_rn(y0 + blockIdx.y * TILE_H +
                                            (sb / SUBS_X) * SUB) + 0.5f * SUB;
            if (plane(a, b, cc, xc, yc) < lim) keep &= ~(1u << j);
          }
        }
        if (keep) {
          *reinterpret_cast<float4*>(raw[c % SLOTS][r] + RAW) = make_float4(
              threshold(q[0], q[1]), threshold(q[3], q[4]),
              threshold(q[6], q[7]), __fsub_rn(q[15], 1.0f));
        }
      }
"""),
]

# stores evict-first, and depth in and the index read evict-first too
_STREAM_ALL = _STREAM_STORES + [
    ("const float2 t = *reinterpret_cast<const float2*>(p);",
     "const float2 t = __ldcs(reinterpret_cast<const float2*>(p));"),
    ("const int row = __ldg(index + start + r);",
     "const int row = __ldcs(index + start + r);"),
]

def _tile_order(bx: str, by: str, prologue: str = "", host: str = ""):
    """CTA (blockIdx.x, blockIdx.y) works on tile (bx, by) instead; with
    ``host``, the launch passes one more argument, ``stride``."""
    def apply(src):
        src = src.replace("blockIdx.x", "bx_").replace("blockIdx.y", "by_")
        src = _edit(src, "  const int tid = threadIdx.x;\n",
                    "  const int tid = threadIdx.x;\n" + prologue
                    + f"  const int bx_ = {bx};\n  const int by_ = {by};\n")
        if host:
            src = _edit(src, "int nty, int vec) {",
                        "int nty, int vec, int stride) {")
            src = _edit(src, " ntx, nty, vec);", " ntx, nty, vec, stride);")
            src = _edit(src, "  if (ntx > 0 && nty > 0) {\n",
                        host + "  if (ntx > 0 && nty > 0) {\n")
        return src
    return apply


def _scatter(group: int):
    """Groups of ``group`` consecutive tiles (raster order) launched in a
    golden-ratio stride over the frame: every wave of CTAs mixes all of
    its regions, and each group keeps its neighbours."""
    g = group
    prologue = f"""  int tile_ = blockIdx.y * ntx + blockIdx.x;
  if (tile_ < (ntx * nty) / {g} * {g})
    tile_ = (int)((long long)(tile_ / {g}) * stride % ((ntx * nty) / {g})) * {g} + tile_ % {g};
"""
    host = f"""  const int groups = (ntx * nty) / {g};
  int stride = groups > 1 ? (int)(groups * 0.6180339887) : 1;
  auto gcd = [](int a, int b) {{ while (b) {{ const int t = a % b; a = b; b = t; }} return a; }};
  while (groups > 1 && gcd(stride, groups) != 1) ++stride;
"""
    return _tile_order("tile_ % ntx", "tile_ / ntx", prologue, host)


# K1 without row bands: pixel rows and the reject's sub-block centres
# band-local (the same output at y0 = 0)
_NO_Y0 = [
    ("__int2float_rn(y0 + y)", "__int2float_rn(y)"),
    ("__int2float_rn(y0 + blockIdx.y * TILE_H +",
     "__int2float_rn(blockIdx.y * TILE_H +"),
]

# the reject's bounds converted in the kernel from ints, as first written
# for row bands (a 4-byte spill at the 56-register cap)
_BOUNDS_IN_KERNEL = [
    ("int y0, float xmax,\n                   float ymax, int ntx,",
     "int y0, int ymax_rows,\n                   int ntx,"),
    ("  const unsigned below = (1u << lane) - 1u;\n",
     "  const float xmax = __int2float_rn(ntx * TILE_W);\n"
     "  const float ymax = __int2float_rn(ymax_rows);\n"
     "  const unsigned below = (1u << lane) - 1u;\n"),
    ("""        width, y0, static_cast<float>(ntx * TILE_W),
        static_cast<float>(ymax), ntx, nty, vec);""",
     "        width, y0, ymax, ntx, nty, vec);"),
]

VARIANTS = {
    "source": lambda src: src,
    "no_y0": _edits(*_NO_Y0),
    "bounds_in_kernel": _edits(*_BOUNDS_IN_KERNEL),
    "stream_stores": _edits(*_STREAM_STORES),
    "stream_all": _edits(*_STREAM_ALL),
    "list_staging": _edits(*_LIST_STAGING),
    "walk_thresholds": _edits(*_LIST_STAGING, *_WALK_THRESHOLDS),
    "uncapped": _edits(_WALK_THRESHOLDS[0]),
    "prefetch_list": _edits(*_PREFETCH_LIST),
    "reverse_order": _tile_order("ntx - 1 - (int)blockIdx.x",
                                 "nty - 1 - (int)blockIdx.y"),
    "halves_order": _tile_order(
        "(int)blockIdx.x",
        "(blockIdx.y % 2) ? nty - 1 - (int)blockIdx.y / 2 : (int)blockIdx.y / 2"),
    "scatter4_order": _scatter(4),
    "scatter16_order": _scatter(16),
}

# reject faults at a band offset, run on the last-band slivers (each
# planted fault either changes their pixels or is reported as not caught):
# the sub-block centres band-local, which rejects sub-blocks that hold
# passing pixels and must be caught; and `ymax` band-local (y0 left out
# of the rounding-error bound), which no set has caught
FAULTS = {
    "reject_rows_band_local": _edits(_NO_Y0[1]),
    "ymax_band_local": _edits(("static_cast<float>(ymax), ntx",
                               "static_cast<float>(ymax - y0), ntx")),
}
MUST_CATCH = ("reject_rows_band_local",)
# the last 270-row band of a 7680x4320 frame: sliver sets (seeds) x size
SLIVER_FRAME, SLIVER_BAND, SLIVER_SETS, SLIVERS = (4320, 7680), 270, 12, 50000

# the source with a global-timer stamp at each CTA's start and end
_TIMELINE = [
    ("namespace {\n", """namespace {
__device__ unsigned long long g_stamps[2 * 1048576];
__device__ __forceinline__ unsigned long long global_timer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
"""),
    ("  const int tid = threadIdx.x;\n",
     "  const int tid = threadIdx.x;\n"
     "  const unsigned long long t_start = global_timer();\n"),
    ("  if (!row_in) return;\n", "  if (row_in) {\n"),
    ("\n}\n\n}  // namespace", """
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int t = blockIdx.y * gridDim.x + blockIdx.x;
    g_stamps[2 * t] = t_start;
    g_stamps[2 * t + 1] = global_timer();
  }
}

}  // namespace

extern "C" int k1_lab_stamps(void* dst, int tiles) {
  return (int)cudaMemcpyFromSymbol(dst, g_stamps, (size_t)tiles * 16);
}"""),
]


def _build(name: str, src: str):
    from torch.utils.cpp_extension import CUDA_HOME
    os.makedirs(LAB_DIR, exist_ok=True)
    cu = os.path.join(LAB_DIR, f"{name}.cu")
    so = os.path.join(LAB_DIR, f"{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    proc = subprocess.run([os.path.join(CUDA_HOME, "bin", "nvcc"),
                           *NVCC_FLAGS, "-o", so, cu],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    regs = [ln.split(":", 1)[-1].strip()
            for ln in (proc.stdout + proc.stderr).splitlines()
            if "registers" in ln or "spill" in ln]
    lib = ctypes.CDLL(so)
    p = ctypes.c_void_p
    lib.raster_tile_launch.argtypes = [p] * 7 + [ctypes.c_int] * 4 + [p]
    lib.raster_tile_launch.restype = ctypes.c_int
    return name, lib, regs


def _launch(lib, inputs, y0=0):
    packed, index, starts, counts, depth = inputs
    H, W = depth.shape
    fused = torch.empty((6, H, W), device=depth.device)
    winner = torch.empty((H, W), dtype=torch.int32, device=depth.device)
    err = lib.raster_tile_launch(
        packed.data_ptr(), index.data_ptr(), starts.data_ptr(),
        counts.data_ptr(), depth.data_ptr(), fused.data_ptr(),
        winner.data_ptr(), H, W, y0, y0 + -(-H // rk.TILE_H) * rk.TILE_H,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return fused, winner


def _time(fn, n: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _time_flushed(fn, n: int, flush) -> float:
    """Median of ``n`` calls, each timed alone after a write of ``flush``
    has evicted the L2."""
    pairs = []
    for _ in range(n):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def _frame1_inputs(make_app):
    """The arguments of the first K1 call of the app's first frame, run
    eagerly (no CUDA graph is captured)."""
    from ..ops import raster
    store, orig = [], raster.rasterize_tiles

    def capture(*inputs, **kw):
        store.append(inputs)
        return orig(*inputs, **kw)

    raster.rasterize_tiles = capture
    try:
        app = make_app()
        app.draw._eager_frames = True
        app.tick()
    finally:
        raster.rasterize_tiles = orig
    torch.cuda.synchronize()
    return store[0]


def _sliver_inputs(seed):
    """y0 and K1's inputs for a set of ``band_slivers`` in the last band
    of the sliver frame."""
    from ..ops import raster
    from ..ops import raster_common as rc
    from ..utils.trisets import band_slivers
    (H, W), band = SLIVER_FRAME, SLIVER_BAND
    y0, dev = H - band, torch.device("cuda")
    clip, vary = band_slivers(SLIVERS, seed, H, W, y0)
    clip_t = torch.from_numpy(clip).to(dev)
    tc = rc.triangle_setup(clip_t, torch.from_numpy(vary).to(dev),
                           torch.ones(SLIVERS, dtype=torch.bool, device=dev),
                           W, H, "none")
    packed = rc.pack_coeffs_full(tc)
    index, starts, counts, overflow = raster.bin_packed(
        packed, tc.valid, raster.viewport_bbox(clip_t, W, H), band, W, y0=y0)
    if bool(overflow):
        raise AssertionError("the sliver set outgrew the pair capacity")
    return y0, (packed, index, starts, counts,
                torch.ones((band, W), device=dev))


def _faults(libs):
    """The source against K1's plain version, and each planted fault
    against both, on every sliver set: the pixels (winner or any plane
    bit) that each fault changes."""
    changed = dict.fromkeys(FAULTS, 0)
    pairs = 0
    for seed in range(SLIVER_SETS):
        y0, inputs = _sliver_inputs(seed)
        pairs += int(inputs[3].sum())
        rfused, rwinner = rk.rasterize_tiles_reference(*inputs, y0=y0)
        fused, winner = _launch(libs["source"], inputs, y0)
        if not (torch.equal(winner, rwinner) and torch.equal(
                fused.view(torch.int32), rfused.view(torch.int32))):
            raise AssertionError(f"the source differs from K1's plain "
                                 f"version on sliver set {seed}")
        for name in FAULTS:
            fused, winner = _launch(libs[name], inputs, y0)
            diff = (winner != rwinner) | (fused.view(torch.int32)
                                          != rfused.view(torch.int32)).any(0)
            changed[name] += int(diff.sum())
    print(f"sliver sets: {SLIVER_SETS} x {SLIVERS} slivers at y0 {y0} of "
          f"{SLIVER_FRAME[1]}x{SLIVER_FRAME[0]} ({pairs} (tile, record) "
          f"pairs), the source bit-equal to K1's plain version")
    for name, pixels in changed.items():
        print(f"fault {name}: {pixels} pixels changed "
              f"({'caught' if pixels else 'not caught'})", flush=True)
        if name in MUST_CATCH and not pixels:
            raise AssertionError(f"the sliver sets do not catch {name}")


def _timeline(lib, label, inputs):
    lib.k1_lab_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    counts = inputs[3].cpu().numpy()
    tiles = counts.shape[0]
    for _ in range(3):
        _launch(lib, inputs)
    torch.cuda.synchronize()
    stamps = np.zeros((tiles, 2), np.uint64)
    if lib.k1_lab_stamps(stamps.ctypes.data, tiles):
        raise RuntimeError("reading the stamps failed")
    start = stamps[:, 0].astype(np.int64)
    end = stamps[:, 1].astype(np.int64)
    end -= start.min()
    start -= start.min()
    span = int(end.max())
    dur = end - start
    top = int(dur.argmax())
    print(f"timeline {label}: span {span / 1e3:.1f} us; CTA duration mean "
          f"{dur.mean() / 1e3:.2f} us, empty tiles "
          f"{dur[counts == 0].mean() / 1e3:.2f} us, longest {dur[top] / 1e3:.1f}"
          f" us (tile {top}, {int(counts[top])} records, started at "
          f"{start[top] / 1e3:.1f} us); sum of CTA durations over the span: "
          f"{dur.sum() / span:.0f} CTAs running on average")
    edges = np.linspace(0, span, 21)
    heavy = counts >= 128
    running = [(start < b) & (end > a) for a, b in zip(edges[:-1], edges[1:])]
    print(f"  CTAs running in each twentieth of the span: "
          f"{[int(r.sum()) for r in running]}")
    print(f"  of them heavy (>= 128 records): "
          f"{[int((r & heavy).sum()) for r in running]}")
    ntx = -(-inputs[4].shape[1] // rk.TILE_W)
    rows = np.bincount(np.arange(tiles) // ntx, weights=counts)
    bands = np.add.reduceat(rows, np.linspace(0, len(rows), 11).astype(int)[:-1])
    print(f"  records by tenth of the frame's height: "
          f"{[int(x) for x in bands]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated names of VARIANTS to time")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the K1 lab needs an NVIDIA card", file=sys.stderr)
        return 1
    names = ["source"] + [v for v in args.variants.split(",")
                          if v and v != "source"]
    with open(rk._SOURCE) as f:
        src = f.read()
    sources = {n: VARIANTS[n](src) for n in names}
    sources.update((n, fault(src)) for n, fault in FAULTS.items())
    sources["timeline"] = _edits(*_TIMELINE)(src)
    with ThreadPoolExecutor(8) as pool:
        built = list(pool.map(lambda kv: _build(*kv), sources.items()))
    for name, _lib, regs in built:
        print(f"  {name}: {regs}", flush=True)
    libs = {name: lib for name, lib, _regs in built}
    _faults(libs)

    from ..app.demo import DemoApp
    from ..app.stress import StressApp
    shapes = {
        "1080p": (200, _frame1_inputs(lambda: DemoApp(1920, 1080))),
        "4k": (50, _frame1_inputs(lambda: StressApp())),
        "8k": (50, _frame1_inputs(lambda: DemoApp(7680, 4320))),
    }
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    for label, (n, inputs) in shapes.items():
        rfused, rwinner = _launch(libs["source"], inputs)
        times = {}
        for name in names:
            fused, winner = _launch(libs[name], inputs)
            if not (torch.equal(winner, rwinner) and torch.equal(
                    fused.view(torch.int32), rfused.view(torch.int32))):
                raise AssertionError(f"{name} differs from the source at "
                                     f"{label}")
            times[name] = []
        for _round in range(3):
            for name in names:
                times[name].append(_time(
                    lambda: _launch(libs[name], inputs), n))
        flushed = {name: _time_flushed(lambda: _launch(libs[name], inputs),
                                       n, flush) for name in names}
        for name in names:
            print(f"{label:6s} {name:18s} {min(times[name]):.4f} ms "
                  f"(rounds {', '.join(f'{t:.4f}' for t in times[name])}), "
                  f"L2 flushed {flushed[name]:.4f} ms; bit-equal to the "
                  f"source", flush=True)
    for label, (_n, inputs) in shapes.items():
        _timeline(libs["timeline"], label, inputs)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
