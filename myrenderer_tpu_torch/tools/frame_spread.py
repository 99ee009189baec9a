"""Where a benchmark cell's frame time spreads between processes, on one
NVIDIA card.

Run from the repository root:

    python -m myrenderer_tpu_torch.tools.frame_spread [--cell stress_4k_1m]
        [--procs change,change,change] [--parent DIR]

Each entry of ``--procs`` is one fresh process, run in turn: ``change``
runs this checkout, ``parent`` the checkout at ``--parent`` (this file
is run by its path there, so the other checkout needs only its package).
Each process builds the cell's app as ``bench_torch.py`` does, ticks 5
warm-up frames and then measures, on the same graph replays:

- ``runs_ms``: 5 runs of back-to-back ticks, each fenced by a sync, as
  ``bench_torch.py``'s ``fps`` runs (20 frames for the stress cell, 120
  for the demo);
- ``host_ms``: the host's time a tick while the card is held busy by a
  spin queued ahead, so that no tick waits for the card (6 ticks, under
  the overflow window of 8 flags; median of 10 rounds);
- ``device_ms``: the same rounds' ticks on the card back to back behind
  the spin (CUDA events), with no gap left by the host;
- from ``torch.profiler`` over 20 frames: each frame's kernel time
  (``busy_ms``, frames split at K1's launch), and K5's time in each
  replay (its one kernel a raster pass): min, median and max;
- the card's SM clock, power draw and temperature, sampled by
  ``nvidia-smi`` every 50 ms through the timed runs.

The last line is one JSON object: each process's numbers and, per
number, the largest relative spread over the processes of each kind.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

CELLS = {"stress_4k_1m": 20, "demo_1080p": 120}
SAMPLE = ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
          "--format=csv,noheader,nounits", "-lms", "50"]


def _make(cell: str):
    if cell == "demo_1080p":
        from myrenderer_tpu_torch.app.demo import DemoApp
        return DemoApp(1920, 1080)
    from myrenderer_tpu_torch.app.stress import StressApp
    return StressApp()


def _spread(xs) -> float:
    return (max(xs) - min(xs)) / min(xs) if xs else 0.0


def child(cell: str) -> dict:
    """One process's numbers (see the module docstring)."""
    import torch
    from myrenderer_tpu_torch.utils.profiling import on_device, trace
    frames = CELLS[cell]
    app = _make(cell)
    for _ in range(5):
        app.tick()
        torch.cuda.synchronize()
    sampler = subprocess.Popen(SAMPLE, stdout=subprocess.PIPE,
                               stderr=subprocess.DEVNULL, text=True)
    try:
        runs = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(frames):
                app.tick()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3 / frames)
    finally:
        sampler.terminate()
        samples, _ = sampler.communicate(timeout=60)
    clocks, power, temp = [], [], []
    for line in samples.splitlines():
        try:
            c, p, t = (float(x) for x in line.split(","))
        except ValueError:
            continue
        clocks.append(c)
        power.append(p)
        temp.append(t)
    host, device = [], []
    for _ in range(10):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)           # some 25 ms of spin
        start.record()
        t0 = time.perf_counter()
        for _ in range(6):
            app.tick()
        host.append((time.perf_counter() - t0) * 1e3 / 6)
        end.record()
        torch.cuda.synchronize()
        device.append(start.elapsed_time(end) / 6)
    torch.cuda.synchronize()
    with trace(os.path.join("build", "frame_spread_trace")) as prof:
        for _ in range(20):
            app.tick()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events() if on_device(e)),
                     key=lambda e: e.time_range.start)
    busy, k5, frame = [], [], None
    for e in kernels:
        us = e.time_range.elapsed_us()
        if "raster_tile_kernel" in e.name:
            if frame is not None:
                busy.append(frame / 1e3)
            frame = 0.0
        if frame is not None:
            frame += us
        if "bin_tiles_" in e.name:
            k5.append(us / 1e3)

    def summary(xs):
        return [min(xs), statistics.median(xs), max(xs)] if xs else None

    return {"runs_ms": runs, "fps_ms": sum(runs) / len(runs),
            "host_ms": statistics.median(host),
            "device_ms": statistics.median(device),
            "busy_ms": summary(busy), "k5_ms": summary(k5),
            "sm_mhz": summary(clocks), "power_w": summary(power),
            "temp_c": summary(temp)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", default="stress_4k_1m", choices=list(CELLS))
    ap.add_argument("--procs", default="change,change,change")
    ap.add_argument("--parent", default=None,
                    help="root of the parent checkout (for 'parent')")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("frame_spread needs an NVIDIA card", file=sys.stderr)
        return 1
    if args.child:
        print(json.dumps(child(args.cell)))
        return 0
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    out = []
    for kind in args.procs.split(","):
        root = here if kind == "change" else os.path.abspath(args.parent)
        env = dict(os.environ, PYTHONPATH=root)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             "--cell", args.cell], cwd=root, env=env, capture_output=True,
            text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        row["kind"] = kind
        out.append(row)
        print(f"{kind:7s} fps runs {['%.4f' % r for r in row['runs_ms']]} "
              f"host {row['host_ms']:.4f} device {row['device_ms']:.4f} "
              f"busy {row['busy_ms']} k5 {row['k5_ms']} sm MHz "
              f"{row['sm_mhz']} W {row['power_w']} C {row['temp_c']}",
              flush=True)
    spread = {}
    for kind in sorted({r["kind"] for r in out}):
        rows = [r for r in out if r["kind"] == kind]
        spread[kind] = {
            k: _spread([r[k] if not isinstance(r[k], list) else r[k][1]
                        for r in rows if r[k] is not None])
            for k in ("fps_ms", "host_ms", "device_ms", "busy_ms", "k5_ms",
                      "sm_mhz")}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    print(json.dumps({"cell": args.cell, "procs": out, "spread": spread}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
