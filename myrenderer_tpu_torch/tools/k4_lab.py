"""K4 lab on one NVIDIA card: variants of K4 timed against its source on
the 4K stress scene's own K4 calls.

Run from the repository root:

    python -m myrenderer_tpu_torch.tools.k4_lab

Each variant is a copy of ``csrc/straddlers.cu`` with a few text edits
(``VARIANTS``); the source as it stands is ``source``. Each is built with
the kernels' nvcc flags (``cuda_build.build_library``) and stands in for
K4's library behind the same wrapper. On the calls of the stress scene's
eager frame 1 (captured at ``select_straddlers``) every variant is held
bit for bit against K4's plain version, then timed in turns (the source,
the variants, the variants again in reverse, the source): the frame's
calls back to back, each frame queued behind a spin on the card so that
the host's launch rate does not count (warm: the same input read again),
frame by frame with a 256 MiB write flushing the 50 MB L2 before each,
and inside the stress frame's CUDA graph replay (the profiler's K4 group
over 20 frames of a ``StressApp`` built with the variant). The variants
record designs that were measured and not kept: an edit that no longer
applies to the source raises, and is then updated or dropped.
"""

from __future__ import annotations

import gc
import os
import subprocess
import sys

import numpy as np
import torch

from ..ops import raster_common as rc
from ..ops import straddlers as st
from ..ops.cuda_build import BUILD_DIR, build_library

LAB_DIR = os.path.join(BUILD_DIR, "k4_lab")
SPIN_CYCLES = 1_000_000   # torch.cuda._sleep ahead of each timed frame
_LOAD = 'asm volatile("ld.global.nc.L1::no_allocate.f32 %0, [%1];"'
_LDG = 'v = __ldg(p);\n  if (false) asm volatile(""'
_ITEMS = "constexpr int kItems = 2;"


def _edit(old: str, new: str):
    def apply(src: str) -> str:
        if old not in src:
            raise ValueError(f"a variant's edit no longer applies: {old!r}")
        return src.replace(old, new)
    return apply


def _edits(*pairs):
    steps = [_edit(old, new) for old, new in pairs]

    def apply(src: str) -> str:
        for step in steps:
            src = step(src)
        return src
    return apply


VARIANTS = {
    "source": lambda src: src,
    # the w lanes through the read-only cache, each taking an L1 line
    "ldg": _edit(_LOAD, _LDG),
    # no L1 line, and each L2 miss fetching 256 bytes
    "l2_256B": _edit(_LOAD, _LOAD.replace(".f32", ".L2::256B.f32")),
    # chunks of 256, 1,024 and 2,048 triangles (2,048 with __ldg too)
    "items1": _edit(_ITEMS, _ITEMS.replace("2", "1")),
    "items4": _edit(_ITEMS, _ITEMS.replace("2", "4")),
    "items8": _edit(_ITEMS, _ITEMS.replace("2", "8")),
    "items8_ldg": _edits((_ITEMS, _ITEMS.replace("2", "8")), (_LOAD, _LDG)),
    # eight status words in flight a thread for the helpers' total
    "loads8": _edit("constexpr int kTotalLoads = 4;",
                    "constexpr int kTotalLoads = 8;"),
}


def _build(name: str, src: str):
    os.makedirs(LAB_DIR, exist_ok=True)
    path = os.path.join(LAB_DIR, f"{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    lib, _seconds, log = build_library(path, f"K4 variant {name}")
    ref = st.K4.build()
    for fn in ("straddlers_launch", "straddlers_blocks",
               "straddlers_max_channels"):
        getattr(lib, fn).argtypes = getattr(ref, fn).argtypes
        getattr(lib, fn).restype = getattr(ref, fn).restype
    regs = [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
            if "registers" in ln]
    return lib, regs


def _frame1_calls():
    """The arguments of every select_straddlers call of the stress scene's
    eager frame 1."""
    from ..app.stress import StressApp
    calls, orig = [], rc.select_straddlers

    def record(*args):
        calls.append(args)
        return orig(*args)

    rc.select_straddlers = record
    try:
        app = StressApp()
        app.draw._eager_frames = True
        app.tick()
    finally:
        rc.select_straddlers = orig
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


def _in_replay(frames: int = 20) -> float:
    """K4's device ms a frame inside the stress scene's graph replay."""
    from ..app.stress import StressApp
    from ..utils.profiling import profile_frames
    app = StressApp()
    for _ in range(5):
        app.tick()
    _wall, _busy, _ops, by_name, _ = profile_frames(app, frames,
                                                   "k4_lab_trace")
    del app
    gc.collect()
    torch.cuda.empty_cache()
    return sum(t for name, (t, _n) in by_name.items()
               if "straddle_" in name) / 1e3 / frames


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("the K4 lab needs an NVIDIA card", file=sys.stderr)
        return 1
    with open(st._SOURCE) as f:
        src = f.read()
    libs = {}
    for name, variant in VARIANTS.items():
        libs[name], regs = _build(name, variant(src))
        print(f"  {name}: {regs}", flush=True)
    source_lib = st.K4.lib
    calls = _frame1_calls()
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")

    def frame():
        for args in calls:
            st.K4(*args)

    launches = st.K4.launches
    times = {name: {"warm": [], "flushed": [], "replay": []}
             for name in libs}
    order = list(libs) + list(reversed(list(libs)))
    try:
        for name in order:
            st.K4.lib = libs[name]
            for args in calls:
                got = st.K4(*args)
                want = rc.select_straddlers_reference(*args)
                for a, b in zip(got, want):
                    if a.is_floating_point():
                        a, b = a.view(torch.int32), b.view(torch.int32)
                    if not torch.equal(a, b):
                        raise AssertionError(f"{name} differs from K4's "
                                             "plain version")
            times[name]["warm"].append(_warm(frame, 100))
            times[name]["flushed"].append(_flushed(frame, 50, flush))
            times[name]["replay"].append(_in_replay())
    finally:
        st.K4.lib = source_lib
        st.K4.launches = launches

    def runs(xs):
        return ", ".join(f"{x:.4f}" for x in xs)

    for name, t in times.items():
        print(f"{name:8s} the stress frame's {len(calls)} calls: warm "
              f"{min(t['warm']):.4f} ms ({runs(t['warm'])}), L2 flushed "
              f"{min(t['flushed']):.4f} ({runs(t['flushed'])}), in the "
              f"replay {runs(t['replay'])}; bit-equal to the plain "
              f"version", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
