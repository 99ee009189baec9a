"""K5 lab on one NVIDIA card: variants of K5 timed against its source on
the binning calls of both benchmark cells.

Run from the repository root:

    python -m myrenderer_tpu_torch.tools.k5_lab

Each variant is a copy of ``csrc/bin_tiles.cu`` with a few text edits
(``VARIANTS``); the source as it stands is ``source``. Each is built with
the kernels' nvcc flags (``cuda_build.build_library``, all at once) and
stands in for K5's library behind the same wrapper (its grid from its own
``kBlocksAnSM`` and ``kRecordsABlock``). On the binning calls
of the 1080p demo's and the 4K stress scene's eager frame 1 (captured at
``binning.bin_tiles``) every variant is held bit for bit against K5's
plain version, then timed in turns (the source, the variants, the
variants again in reverse, the source): a frame's calls back to back,
each frame queued behind a spin on the card so that the host's launch
rate does not count (warm: the same input read again), frame by frame
with a 256 MiB write flushing the 50 MB L2 before each, and inside the
cell's CUDA graph replay (the profiler's K5 kernels over 20 frames of an
app built with the variant), and the seven phases of one launch on the
cell's largest call (``K5.phase_times``). Each variant takes out one of
the source's forks (or tries a form that was not kept), so its times say
what the fork buys in each cell; an edit that no longer applies to the
source raises, and is then updated or dropped.
"""

from __future__ import annotations

import gc
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..ops import binning
from ..ops.cuda_build import BUILD_DIR, build_library

LAB_DIR = os.path.join(BUILD_DIR, "k5_lab")
SPIN_CYCLES = 1_000_000   # torch.cuda._sleep ahead of each timed frame
_BLOCKS = "constexpr int kBlocksAnSM = 4;"
_RECORDS = "constexpr int kRecordsABlock = 512;"
_BEFORE = "  before = block_sum(before);\n"
_PAIR_SPLIT = """  const long long lo = (long long)b * K / G;
  const long long hi = (long long)(b + 1) * K / G;
"""
_EXPAND = "constexpr int kExpand = 4;"


def _edit(*pairs: str):
    """Text edits (old, new, old, new, ...), each of which must apply."""
    def apply(src: str) -> str:
        for old, new in zip(pairs[::2], pairs[1::2]):
            if old not in src:
                raise ValueError(f"a variant's edit no longer applies: "
                                 f"{old!r}")
            src = src.replace(old, new)
        return src
    return apply


VARIANTS = {
    "source": lambda src: src,
    # two blocks an SM at most: fewer arrivals at each grid barrier, fewer
    # warps to hide the searches' and atomics' latency
    "blocks_an_sm_2": _edit(_BLOCKS, _BLOCKS.replace("4", "2")),
    # a block for each 128 records (the demo's pass on 161 blocks, not one
    # an SM) for each 512
    "records_a_block_128": _edit(_RECORDS, _RECORDS.replace("512", "128")),
    # each block takes the pairs of its own records (the record split)
    # instead of an equal range of the pairs
    "record_split": _edit(
        _BEFORE, _BEFORE + "  const long long own = block_sum(\n"
        "      t == 0 ? (long long)__ldcg(g.rec_sum + b) : 0ll);\n",
        _PAIR_SPLIT, "  const long long lo = before < K ? before : K;\n"
        "  const long long hi = before + own < K ? before + own : K;\n"),
    # chunks of 512 pairs (two a thread) for 1,024
    "expand_2": _edit(_EXPAND, _EXPAND.replace("4", "2")),
    # a warp sorts the rows of every tile of more than 32 rows and more
    # than one run, not merging up to 64 runs
    "warp_sort_all": _edit("  if (k > kMaxRuns) {", "  if (true) {"),
    # one register network of kWarpRows rows for every many-run tile, in
    # place of the smallest of three that holds the tile
    "one_sort_size": _edit(
        "    if (n <= 128) sort_warp_rows<4>(seg, s.rows, n);\n"
        "    else if (n <= 256) sort_warp_rows<8>(seg, s.rows, n);\n"
        "    else sort_warp_rows", "    sort_warp_rows"),
    # phase 2 reads every box again instead of the rects phase 1 kept
    "no_record_cache": _edit("const bool cached = r1 - r0 <= kCache;",
                             "const bool cached = false;"),
    # an ordinary launch of the same grid (its blocks resident in practice,
    # not by the runtime's check)
    "plain_launch": _edit("cudaLaunchCooperativeKernel(", "cudaLaunchKernel("),
}


def _build(name: str, src: str):
    os.makedirs(LAB_DIR, exist_ok=True)
    path = os.path.join(LAB_DIR, f"{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    return build_library(path, f"K5 variant {name}")


def _load(lib, log: str):
    ref = binning.K5.build()
    for fn in ("bin_tiles_scratch_words", "bin_tiles_launch",
               "bin_tiles_setup", "bin_tiles_occupancy", "bin_tiles_grid"):
        getattr(lib, fn).argtypes = getattr(ref, fn).argtypes
        getattr(lib, fn).restype = getattr(ref, fn).restype
    err = lib.bin_tiles_setup()
    if err != 0:
        raise RuntimeError(f"a K5 variant's set-up failed: CUDA error {err}")
    return lib, [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                 if "registers" in ln]


def _make(cell: str):
    from ..app.demo import DemoApp
    from ..app.stress import StressApp
    if cell == "demo_1080p":
        return DemoApp(1920, 1080)
    return StressApp()


def _frame1_calls(cell: str):
    """The arguments of every bin_tiles call of the cell's eager frame 1."""
    calls, orig = [], binning.bin_tiles

    def record(valid, bbox, height, width, y0, capacity):
        calls.append((valid, tuple(bbox), height, width, y0, capacity))
        return orig(valid, bbox, height, width, y0, capacity)

    binning.bin_tiles = record
    try:
        app = _make(cell)
        app.draw._eager_frames = True
        app.tick()
    finally:
        binning.bin_tiles = orig
    torch.cuda.synchronize()
    return calls


def _warm(fn, n: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(n * SPIN_CYCLES)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _flushed(fn, n: int, flush) -> float:
    pairs = []
    for _ in range(n):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def _in_replay(cell: str, frames: int = 20) -> float:
    """K5's device ms a frame inside the cell's graph replay."""
    from ..utils.profiling import profile_frames
    app = _make(cell)
    for _ in range(5):
        app.tick()
    _wall, _busy, _ops, by_name, _ = profile_frames(app, frames,
                                                   "k5_lab_trace")
    del app
    gc.collect()
    torch.cuda.empty_cache()
    return sum(t for name, (t, _n) in by_name.items()
               if "bin_tiles_" in name) / 1e3 / frames


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("the K5 lab needs an NVIDIA card", file=sys.stderr)
        return 1
    with open(binning._SOURCE) as f:
        src = f.read()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(
            lambda kv: _build(kv[0], kv[1](src)), VARIANTS.items())))
    libs = {}
    for name, (lib, _seconds, log) in built.items():
        libs[name], regs = _load(lib, log)
        print(f"  {name}: {regs}", flush=True)
    source_lib = binning.K5.lib
    cells = ("demo_1080p", "stress_4k")
    calls = {cell: _frame1_calls(cell) for cell in cells}
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    launches = binning.K5.launches
    times = {(name, cell): {"warm": [], "flushed": [], "replay": [],
                            "phases": []}
             for name in libs for cell in cells}
    order = list(libs) + list(reversed(list(libs)))
    try:
        for name in order:
            binning.K5.lib = libs[name]
            binning.K5._occupancy.clear()
            for cell in cells:
                for args in calls[cell]:
                    got = binning.K5(*args)
                    want = binning.bin_tiles_reference(*args)
                    if not all(torch.equal(a, b) for a, b in zip(got, want)):
                        raise AssertionError(f"{name} differs from K5's "
                                             f"plain version ({cell})")

                def frame(cell=cell):
                    for args in calls[cell]:
                        binning.K5(*args)
                t = times[name, cell]
                t["warm"].append(_warm(frame, 100))
                t["flushed"].append(_flushed(frame, 50, flush))
                t["replay"].append(_in_replay(cell))
                big = max(calls[cell], key=lambda a: a[0].shape[0])
                t["phases"].append(binning.K5.phase_times(*big))
    finally:
        binning.K5.lib = source_lib
        binning.K5._occupancy.clear()
        binning.K5.launches = launches

    def runs(xs):
        return ", ".join(f"{x:.4f}" for x in xs)

    for (name, cell), t in times.items():
        print(f"{name:15s} {cell:10s} ({len(calls[cell])} call): warm "
              f"{min(t['warm']):.4f} ms ({runs(t['warm'])}), L2 flushed "
              f"{min(t['flushed']):.4f} ({runs(t['flushed'])}), in the "
              f"replay {runs(t['replay'])}; bit-equal to the plain "
              f"version", flush=True)
        print("      phases (ms, one launch a turn): " + "; ".join(
            f"{k} {', '.join(f'{p[k]:.4f}' for p in t['phases'])}"
            for k in binning.PHASES), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
