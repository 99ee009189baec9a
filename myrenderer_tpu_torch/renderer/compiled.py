"""The frame as a CUDA graph (torch).

The JAX package compiles each frame plan once (``jax.jit`` in
``Draw._get_plan``) and dispatches that one program a frame. On the card
the counterpart of that executable is a CUDA graph: :class:`CompiledFrame`
holds one ``torch.cuda.CUDAGraph`` of one frame plan at one capacity
rung (``Draw.big_scale``). Like XLA, a graph needs static shapes and no
host read inside the frame, which the static clip and pair capacities
and their device overflow flags give the frame.

- **Capture.** :meth:`CompiledFrame.capture` first runs the frame once
  eagerly on a side stream (the warm-up PyTorch's graph documentation
  prescribes; its result is the frame the caller publishes), then
  captures it into a graph with its own memory pool. A capture that
  fails raises: there is no quiet fall back to an eager frame.
- **Inputs.** Every input leaf gets a static buffer. The host leaves
  (numpy f32: node transforms, perspectives, clear colours) go to the
  card each frame as ONE copy from pinned memory into one static flat
  buffer; a device leaf (bounds, vertex buffers, bindings, the incoming
  framebuffer) is copied into its buffer when the tensor is a new one.
- **Outputs.** :meth:`CompiledFrame.replay` copies the framebuffer, the
  winners and the overflow flags out of the graph's buffers: the next
  replay overwrites them, and a published frame never changes.
- **Traced once.** The frame's Python (vertex and fragment functions
  included) runs at capture only; replays run the recorded kernels.
  Python-side values read by a vertex function are baked in, as
  ``jax.jit`` bakes them into its trace.
- **Launch counting.** K1's launches recorded in the graph are taken
  back out of ``K1.launches`` at capture (nothing ran) and added at each
  replay.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops.raster_cuda import K1
from ..parallel.sharding import Banded


def tree_map(fn, tree):
    """``fn`` over the leaves of nested dicts, lists and tuples (a
    :class:`Banded` maps its bands)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if isinstance(tree, Banded):
        return Banded(fn(b) for b in tree.bands)
    return fn(tree)


def leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def device_args(args, device: torch.device):
    """``args`` with every numpy leaf on ``device``: one flat f32 array,
    on the card one non-blocking copy from pinned memory, and a view of
    it for each leaf."""
    host = [a for a in leaves(args) if isinstance(a, np.ndarray)]
    if not host:
        return args
    flat = torch.from_numpy(np.concatenate([a.reshape(-1) for a in host]))
    if device.type == "cuda":
        flat = flat.pin_memory().to(device, non_blocking=True)
    views = iter(_views(flat, host))
    return tree_map(lambda a: next(views) if isinstance(a, np.ndarray)
                    else a, args)


def _views(flat: torch.Tensor, host: list) -> list:
    out, at = [], 0
    for a in host:
        if a.dtype != np.float32:
            raise TypeError(f"host frame inputs are f32, got {a.dtype}")
        out.append(flat[at:at + a.size].view(a.shape))
        at += a.size
    return out


def _copy_out(out):
    return tree_map(lambda t: None if t is None else t.clone(), out)


class CompiledFrame:
    """One frame plan's CUDA graph at one capacity rung: its static
    inputs, the graph and its output buffers. ``k1_launches`` is the K1
    launches a replay makes, ``capture_seconds`` the capture's wall time
    and ``pool_bytes`` the device memory its pool reserved."""

    def __init__(self, device: torch.device):
        self.device = device
        self.graph = None
        self.k1_launches = 0
        self.capture_seconds = None
        self.pool_bytes = None
        self._static = None       # the static input tree
        self._flat = None         # static buffer of the host leaves
        self._sources = []        # the device leaf last copied to each slot
        self._out = None

    @classmethod
    def capture(cls, fn, args, device: torch.device):
        """Warm ``fn(args)`` up eagerly on a side stream, then capture it.
        Returns (the CompiledFrame, the warm-up frame's outputs)."""
        self = cls(device)
        host = [a for a in leaves(args) if isinstance(a, np.ndarray)]
        self._flat = torch.empty(sum(a.size for a in host),
                                 dtype=torch.float32, device=device)
        views = iter(_views(self._flat, host))

        def static(a):
            if isinstance(a, np.ndarray):
                return next(views)
            return None if a is None else torch.empty_like(a)

        self._static = tree_map(static, args)
        self._sources = [None] * len(leaves(args))
        with torch.cuda.device(device):
            self._load(args)
            cur = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                out = fn(self._static)
            cur.wait_stream(side)
            for t in leaves(out):
                if t is not None:
                    t.record_stream(cur)
            t0 = time.perf_counter()
            # the capture empties the allocator's cache first as well
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved()
            graph = torch.cuda.CUDAGraph()
            before = K1.launches
            try:
                with torch.cuda.graph(graph):
                    self._out = fn(self._static)
            finally:
                # nothing was launched while capturing
                self.k1_launches = K1.launches - before
                K1.launches = before
            self.pool_bytes = torch.cuda.memory_reserved() - reserved
            self.capture_seconds = time.perf_counter() - t0
        self.graph = graph
        return self, out

    def _load(self, args) -> None:
        """Copy this frame's inputs into the static buffers."""
        host = []
        for i, (a, s) in enumerate(zip(leaves(args), leaves(self._static))):
            if isinstance(a, np.ndarray):
                host.append(a.reshape(-1))
            elif a is not None and a is not self._sources[i]:
                if a.shape != s.shape or a.dtype != s.dtype:
                    raise ValueError(
                        f"a frame input changed from {s.dtype}"
                        f"{list(s.shape)} to {a.dtype}{list(a.shape)} "
                        "without a new frame plan")
                s.copy_(a, non_blocking=True)
                self._sources[i] = a
        if host:
            self._flat.copy_(torch.from_numpy(np.concatenate(host))
                             .pin_memory(), non_blocking=True)

    def replay(self, args):
        """Run the graph on ``args``; returns copies of its outputs."""
        with torch.cuda.device(self.device):
            self._load(args)
            self.graph.replay()
            K1.launches += self.k1_launches
            return _copy_out(self._out)
