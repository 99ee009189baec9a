"""Profiling helpers: a ``torch.profiler`` trace around a block, and
rolling frame-time statistics.

Port of ``myrenderer_tpu/utils/profiling.py``; the trace is PyTorch's
(Chrome trace format) in place of ``jax.profiler``'s.
"""

from __future__ import annotations

import contextlib
import os
import time


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
