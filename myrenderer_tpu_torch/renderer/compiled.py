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
  fails raises: there is no quiet fall back to an eager frame. K4's and
  K5's zeroed scratch is made by the warm-up and belongs to the graph
  (:func:`graph_scratch`); a mesh frame's graphs share one store.
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
- **Launch counting.** The launches of the port's kernels (K1-K5)
  recorded in the graph are taken back out of their counts at capture
  (nothing ran) and added at each replay.
- **A mesh frame** (:class:`CompiledMeshFrame`) is one program across
  cards in JAX; here it is cut at its all-gather into two segments, the
  shards' pre-kernel stage and the bands' raster stage, and each segment
  is captured once per distinct card of the mesh, on that card's stream
  into that card's graph (the two share a pool). A replay launches the
  first segment on every card, then the gather's peer copies (ordered
  by events on both cards' streams), then the second segment on every
  card, all from the host without a sync. A CUDA graph holds one
  device's work, and PyTorch exposes no capture of a wait on another
  card's event, so the cross-card edge stays outside the graphs. Over
  several cards the shards' graph also writes its pieces into one byte
  buffer, so the gather is one peer copy for each pair of cards (not
  one for each of some 70 small tensors a card). A mesh whose bands
  repeat one card runs the same machinery, with no copy.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from ..ops import binning, straddlers
from ..ops.binning import K5
from ..ops.raster_cuda import K1
from ..ops.setup_pack import K2
from ..ops.straddlers import K4
from ..ops.terrain_vertex import K3
from ..parallel.sharding import all_gather, leaves, tree_map


# the kernels whose launches a replay counts
KERNELS = (K1, K2, K3, K4, K5)


@contextlib.contextmanager
def graph_scratch(store: dict):
    """K4's and K5's scratch taken from ``store`` (kept as long as the
    graph) inside the block: one a kernel and device, made by the eager
    warm-up and reused by the capture."""
    with straddlers.graph_scratch(store.setdefault("K4", {})), \
            binning.graph_scratch(store.setdefault("K5", {})):
        yield


@contextlib.contextmanager
def _captured_launches(counts: dict):
    """Fill ``counts`` with each kernel's launches recorded inside the
    block and take them back out of its count: a capture runs nothing."""
    before = {k: k.launches for k in KERNELS}
    try:
        yield
    finally:
        for k, n in before.items():
            counts[k] = k.launches - n
            k.launches = n


def _count_replay(counts: dict):
    for k, n in counts.items():
        k.launches += n


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


def _byte_views(buf: torch.Tensor, tree) -> list:
    """A view of ``buf`` (u8) for each leaf of ``tree``, with the leaf's
    dtype and shape, at 16-byte aligned offsets in leaf order."""
    out, at = [], 0
    for t in leaves(tree):
        out.append(buf[at:at + t.nbytes].view(t.dtype).view(t.shape))
        at += -(-t.nbytes // 16) * 16
    return out


def _byte_size(tree) -> int:
    return sum(-(-t.nbytes // 16) * 16 for t in leaves(tree))


def _copy_out(out):
    return tree_map(lambda t: None if t is None else t.clone(), out)


class _StaticInputs:
    """Static buffers of a frame's inputs on one device: ``tree`` is the
    input tree with every host leaf a view of one flat buffer and every
    device leaf a buffer of its own (the leaves of a view on a mesh card
    lie on that card)."""

    def __init__(self, args, device: torch.device):
        host = [a for a in leaves(args) if isinstance(a, np.ndarray)]
        self.flat = torch.empty(sum(a.size for a in host),
                                dtype=torch.float32, device=device)
        views = iter(_views(self.flat, host))

        def static(a):
            if isinstance(a, np.ndarray):
                return next(views)
            return None if a is None else torch.empty_like(a)

        self.tree = tree_map(static, args)
        self._sources = [None] * len(leaves(args))

    def load(self, args) -> None:
        """Copy this frame's inputs into the static buffers: the host
        leaves as one copy from pinned memory, a device leaf when the
        tensor is a new one."""
        host = []
        for i, (a, s) in enumerate(zip(leaves(args), leaves(self.tree))):
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
            self.flat.copy_(torch.from_numpy(np.concatenate(host))
                            .pin_memory(), non_blocking=True)


class CompiledFrame:
    """One frame plan's CUDA graph at one capacity rung: its static
    inputs, the graph and its output buffers. ``launches`` holds the
    launches of each kernel (:data:`KERNELS`) a replay makes,
    ``k1_launches`` K1's, ``capture_seconds`` the capture's wall time and
    ``pool_bytes`` the device memory its pool reserved."""

    def __init__(self, device: torch.device):
        self.device = device
        self.graph = None
        self.launches = {}
        self.k1_launches = 0
        self.capture_seconds = None
        self.pool_bytes = None
        self._inputs = None
        self._out = None
        self._scratch = {}      # K4's and K5's, zeroed by the warm-up

    @classmethod
    def capture(cls, fn, args, device: torch.device):
        """Warm ``fn(args)`` up eagerly on a side stream, then capture it.
        Returns (the CompiledFrame, the warm-up frame's outputs)."""
        self = cls(device)
        self._inputs = _StaticInputs(args, device)
        static = self._inputs.tree
        with torch.cuda.device(device):
            self._inputs.load(args)
            cur = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(cur)
            with torch.cuda.stream(side), graph_scratch(self._scratch):
                out = fn(static)
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
            with _captured_launches(self.launches), \
                    graph_scratch(self._scratch):
                with torch.cuda.graph(graph):
                    self._out = fn(static)
            self.k1_launches = self.launches[K1]
            self.pool_bytes = torch.cuda.memory_reserved() - reserved
            self.capture_seconds = time.perf_counter() - t0
        self.graph = graph
        return self, out

    def replay(self, args):
        """Run the graph on ``args``; returns copies of its outputs."""
        with torch.cuda.device(self.device):
            self._inputs.load(args)
            self.graph.replay()
            _count_replay(self.launches)
            return _copy_out(self._out)


class CompiledMeshFrame:
    """One mesh frame plan's CUDA graphs at one capacity rung. The frame
    is three functions of the renderer (``stages``): ``shard_stage(view,
    device)`` -> {key: piece} (the pre-kernel stage of the shards on a
    device), ``band_stage(view, pieces, device)`` (every raster pass of
    the bands on a device, from every shard's pieces on it) and
    ``outputs([band_stage result per device])`` -> the frame. ``args``
    holds ``views``, one input tree per distinct device of the mesh
    (``devices``). ``launches`` (``k1_launches`` K1's),
    ``capture_seconds`` and ``pool_bytes`` are summed over the cards,
    ``segments`` lists (device, "shards" or "bands", capture seconds,
    pool bytes) of each graph; ``gather_bytes`` is what the all-gather
    copies between cards a frame."""

    def __init__(self, devices: list):
        self.devices = list(devices)
        self.graphs = []          # per device: [shard graph, band graph]
        self.launches = {}
        self.k1_launches = 0
        self.capture_seconds = None
        self.pool_bytes = None
        self.gather_bytes = 0
        self.segments = []
        self._inputs = None
        self._pieces = []         # per device: the shard graph's outputs
        self._copies = []         # (buffer, source) of each peer copy
        self._out = None
        self._outputs = None
        self._scratch = {}        # K5's, zeroed by the warm-up

    @classmethod
    def capture(cls, stages, args, devices: list):
        """Warm the frame up eagerly on a side stream of each card, then
        capture each segment on each card. Returns (the
        CompiledMeshFrame, the warm-up frame's outputs)."""
        shard_stage, band_stage, outputs = stages
        self = cls(devices)
        self._outputs = outputs
        views = args["views"]
        self._inputs = [_StaticInputs(v, d) for v, d in zip(views, devices)]
        static = [inp.tree for inp in self._inputs]
        for inp, v in zip(self._inputs, views):
            inp.load(v)
        cur = [torch.cuda.current_stream(d) for d in devices]
        side = [torch.cuda.Stream(d) for d in devices]
        for s, c in zip(side, cur):
            s.wait_stream(c)
        with contextlib.ExitStack() as stack:
            for s in side:
                stack.enter_context(torch.cuda.stream(s))
            stack.enter_context(graph_scratch(self._scratch))
            pieces = [shard_stage(v, d) for v, d in zip(static, devices)]
            out = outputs([band_stage(v, all_gather(pieces, d), d)
                           for v, d in zip(static, devices)])
        del pieces
        for s, c in zip(side, cur):
            c.wait_stream(s)
        for t in leaves(out):
            if t is not None:
                t.record_stream(torch.cuda.current_stream(t.device))
        t0 = time.perf_counter()
        for d in devices:
            torch.cuda.synchronize(d)
        torch.cuda.empty_cache()
        reserved = [torch.cuda.memory_reserved(d) for d in devices]
        with _captured_launches(self.launches), \
                graph_scratch(self._scratch):
            for v, d in zip(static, devices):
                graph, pieces = self._capture(self._shards,
                                              (shard_stage, v, d), d)
                self.graphs.append([graph])
                self._pieces.append(pieces)
            got = [self._gather_buffers(d) for d in devices]
            self._out = []
            for v, g, d, graphs in zip(static, got, devices, self.graphs):
                graph, out_d = self._capture(band_stage, (v, g, d), d,
                                             pool=graphs[0].pool())
                graphs.append(graph)
                self._out.append(out_d)
        self.k1_launches = self.launches[K1]
        self.pool_bytes = sum(torch.cuda.memory_reserved(d) - r
                              for d, r in zip(devices, reserved))
        self.capture_seconds = time.perf_counter() - t0
        return self, out

    def _capture(self, fn, args: tuple, device, pool=None):
        """Capture ``fn(*args)`` into a new graph on ``device``'s own
        stream, in ``pool`` (the shards' graph's, for the bands' graph).
        Returns (the graph, its outputs)."""
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        reserved = torch.cuda.memory_reserved(device)
        with torch.cuda.device(device):
            with torch.cuda.graph(graph, pool=pool,
                                  stream=torch.cuda.Stream(device)):
                out = fn(*args)
        self.segments.append((device, "shards" if pool is None else "bands",
                              time.perf_counter() - t0,
                              torch.cuda.memory_reserved(device) - reserved))
        return graph, out

    def _shards(self, shard_stage, view, device):
        """The shards' stage on ``device``: (its pieces, and over several
        cards one u8 buffer holding them all for the gather)."""
        pieces = shard_stage(view, device)
        if len(self.devices) == 1:
            return pieces, None
        buf = torch.empty(_byte_size(pieces), dtype=torch.uint8,
                          device=device)
        for dst, t in zip(_byte_views(buf, pieces), leaves(pieces)):
            dst.copy_(t)
        return pieces, buf

    def _gather_buffers(self, device) -> dict:
        """Every shard's pieces on ``device``: the shard graph's own
        outputs where the shard lies there, else views of a byte buffer
        on ``device`` that each replay's peer copy fills."""
        out = {}
        for src, (pieces, buf) in zip(self.devices, self._pieces):
            if src == device:
                out.update(pieces)
                continue
            dst = torch.empty_like(buf, device=device)
            self._copies.append((dst, buf))
            self.gather_bytes += buf.nbytes
            views = iter(_byte_views(dst, pieces))
            out.update(tree_map(lambda _t: next(views), pieces))
        return out

    def replay(self, args):
        """Run the segments on ``args``; returns copies of the outputs."""
        for inp, v in zip(self._inputs, args["views"]):
            inp.load(v)
        for d, (shard_graph, _band_graph) in zip(self.devices, self.graphs):
            with torch.cuda.device(d):
                shard_graph.replay()
        for buf, src in self._copies:
            buf.copy_(src, non_blocking=True)
        for d, (_shard_graph, band_graph) in zip(self.devices, self.graphs):
            with torch.cuda.device(d):
                band_graph.replay()
        _count_replay(self.launches)
        return self._outputs([_copy_out(o) for o in self._out])
