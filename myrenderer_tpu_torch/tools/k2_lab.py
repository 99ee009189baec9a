"""K2 lab on one NVIDIA card: variants of K2 timed against its source on
the 1080p demo's and the 4K stress scene's own K2 passes.

Run from the repository root:

    python -m myrenderer_tpu_torch.tools.k2_lab

Each variant is a copy of ``csrc/setup_pack.cu`` with a few text edits
(``VARIANTS``); the source as it stands is ``source``. Each is built with
the kernels' nvcc flags (``cuda_build.build_library``) and stands in for
K2's library behind the same wrapper. On the pass of each cell's eager
frame 1 (captured at ``setup_pack_pass``) every variant is held bit for
bit against K2's plain version, then timed in turns (the source, the
variants, the variants again in reverse, the source): the pass back to
back, each launch queued behind a spin on the card so that the host's
launch rate does not count (warm: the same input read again), launch by
launch with a 256 MiB write flushing the 50 MB L2 before each, and inside
the cell's CUDA graph replay (the profiler's K2 group over 20 frames of
an app built with the variant). The variants record designs that were
measured and not kept: an edit that no longer applies to the source
raises, and is then updated or dropped.
"""

from __future__ import annotations

import gc
import os
import subprocess
import sys

import numpy as np
import torch

from ..ops import setup_pack as sp
from ..ops.cuda_build import BUILD_DIR, build_library
from ..utils.profiling import k2_pass_against_plain, profile_frames

LAB_DIR = os.path.join(BUILD_DIR, "k2_lab")
SPIN_CYCLES = 1_000_000   # torch.cuda._sleep ahead of each timed launch
_BOUNDS = "__launch_bounds__(kBlock)\nsetup_pack_kernel"
_CHUNK = "constexpr int kBlock = 64;"


def _edit(old: str, new: str):
    def apply(src: str) -> str:
        if old not in src:
            raise ValueError(f"a variant's edit no longer applies: {old!r}")
        return src.replace(old, new)
    return apply


VARIANTS = {
    "source": lambda src: src,
    # every input read per thread through its strides: no staging
    "no_staging": _edit("    p.seg[i].first_chunk = chunks;\n",
                        "    p.seg[i].first_chunk = chunks;\n"
                        "    p.seg[i].mode &= ~(kStageClip | kStageVary);\n"),
    # registers capped for 20 blocks an SM (48 registers)
    "bounds20": _edit(_BOUNDS, _BOUNDS.replace("(kBlock)", "(kBlock, 20)")),
    # chunks of 32, 128 and 256 triangles
    "chunk32": _edit(_CHUNK, _CHUNK.replace("64", "32")),
    "chunk128": _edit(_CHUNK, _CHUNK.replace("64", "128")),
    "chunk256": _edit(_CHUNK, _CHUNK.replace("64", "256")),
}
CELLS = ("demo_1080p", "stress_4k")


def _build(name: str, src: str):
    os.makedirs(LAB_DIR, exist_ok=True)
    path = os.path.join(LAB_DIR, f"{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    kernel = sp.SetupPackKernel()
    lib, _seconds, log = build_library(path, f"K2 variant {name}")
    ref = sp.K2.build()
    for fn in ("setup_pack_launch", "setup_pack_segment_bytes",
               "setup_pack_max_segments"):
        getattr(lib, fn).argtypes = getattr(ref, fn).argtypes
        getattr(lib, fn).restype = getattr(ref, fn).restype
    kernel.lib = lib
    regs = [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
            if "registers" in ln]
    return kernel, regs


def _app(cell: str):
    from ..app.demo import DemoApp
    from ..app.stress import StressApp
    return DemoApp(1920, 1080) if cell == "demo_1080p" else StressApp()


def _frame1_pass(cell: str) -> list:
    """The segments of the one K2 pass of ``cell``'s eager frame 1."""
    passes, orig = [], sp.setup_pack_pass

    def record(segments):
        passes.append(list(segments))
        return orig(passes[-1])

    sp.setup_pack_pass = record
    try:
        app = _app(cell)
        app.draw._eager_frames = True
        app.tick()
    finally:
        sp.setup_pack_pass = orig
    torch.cuda.synchronize()
    if len(passes) != 1:
        raise AssertionError(f"{cell} frame 1 made {len(passes)} K2 passes")
    return passes[0]


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
    """K2's device ms a frame inside ``cell``'s graph replay."""
    app = _app(cell)
    for _ in range(5):
        app.tick()
    _wall, _busy, _ops, by_name, _ = profile_frames(app, frames,
                                                   "k2_lab_trace")
    del app
    gc.collect()
    torch.cuda.empty_cache()
    return sum(t for name, (t, _n) in by_name.items()
               if "setup_pack_kernel" in name) / 1e3 / frames


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("the K2 lab needs an NVIDIA card", file=sys.stderr)
        return 1
    with open(sp._SOURCE) as f:
        src = f.read()
    kernels = {}
    for name, variant in VARIANTS.items():
        kernels[name], regs = _build(name, variant(src))
        print(f"  {name}: {regs}", flush=True)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    source = sp.K2
    names = list(kernels)
    order = names + list(reversed(names))
    try:
        for cell in CELLS:
            segments = _frame1_pass(cell)
            times = {name: {"warm": [], "flushed": [], "replay": []}
                     for name in names}
            for name in order:
                sp.K2 = kernels[name]
                bad = k2_pass_against_plain(segments)[0]
                if bad:
                    raise AssertionError(f"{name} differs from K2's plain "
                                         f"version in {bad} values")
                times[name]["warm"].append(
                    _warm(lambda: sp.K2(segments), 100))
                times[name]["flushed"].append(
                    _flushed(lambda: sp.K2(segments), 50, flush))
                times[name]["replay"].append(_in_replay(cell))
            sp.K2 = source
            _report(cell, segments, times)
            del segments
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        sp.K2 = source
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    return 0


def _report(cell: str, segments: list, times: dict):
    def runs(xs):
        return ", ".join(f"{x:.4f}" for x in xs)

    tris = sum(s.tri_clip.shape[0] for s in segments)
    for name, t in times.items():
        print(f"{cell} {name:10s} one pass of {len(segments)} "
              f"segments, {tris} triangles: warm {min(t['warm']):.4f} ms "
              f"({runs(t['warm'])}), L2 flushed {min(t['flushed']):.4f} "
              f"({runs(t['flushed'])}), in the replay "
              f"{runs(t['replay'])}; bit-equal to the plain version",
              flush=True)


if __name__ == "__main__":
    sys.exit(main())
