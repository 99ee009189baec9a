"""Row-band rendering over a mesh of torch devices (torch).

Port of ``myrenderer_tpu/parallel/sharding.py``. The framebuffer is cut
into bands of rows along the mesh's ``rows`` axis and each band is
rendered on its own device, against the full triangle set, with a
band-local depth buffer: rasterization needs no reduction across bands,
and a band is bit-identical to the same rows of the frame rendered on
one device. The frame stays banded (:class:`Banded`) until the host asks
for it.

The triangles are split over the same axis, as the JAX frame pins its
pre-kernel stage to ``P("rows")``: :func:`shard_ranges` gives shard k
the triangles ``[k * ceil(T / rows), ...)`` of a batch, on band k's
device, and the renderer runs each shard's vertex stage, clip, setup
and pack there. :func:`all_gather` then assembles the records of every
raster pass on every band's device, once a frame (the JAX frame's
collective, one a pass): peer copies between cards (``Tensor.copy_``,
which orders itself with events on both cards' current streams),
nothing where the shard already lies on the band's device (a mesh whose
bands repeat one card gathers by ``torch.cat`` alone). A frame replayed
as CUDA graphs (``renderer/compiled.py``) gathers the same pieces with
one copy for each pair of cards.

One Python process drives every device, as the JAX package's
single-controller mesh does: the bands of a frame may share one card,
spread over several, or lie on the CPU (the tests). The ``tris`` axis is
accepted for the JAX package's mesh shapes and replicates, as in JAX:
band k and shard k run on ``devices[k][0]``. :func:`sharded_render_step`
keeps the JAX step's contract, which does not shard setup: its
triangles are set up once, on the mesh's first device.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..ops import raster
from ..ops import raster_common as rc


class Mesh:
    """A named array of torch devices, ``rows x tris`` by default (the
    JAX ``Mesh``'s surface: ``devices``, ``axis_names``, ``shape``)."""

    def __init__(self, devices, axis_names=("rows", "tris")):
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != len(axis_names):
            raise ValueError(f"a {arr.ndim}-d device array for axes "
                             f"{tuple(axis_names)}")
        self.devices = np.empty(arr.shape, dtype=object)
        for i, d in np.ndenumerate(arr):
            self.devices[i] = resolve_device(d)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    @property
    def first_device(self) -> torch.device:
        return self.devices.flat[0]

    def band_devices(self) -> list:
        """The device of each row band: the first of its ``rows`` row."""
        rows = self.axis_names.index("rows")
        return list(np.moveaxis(self.devices, rows, 0).reshape(
            self.shape["rows"], -1)[:, 0])


def make_mesh(n_devices: Optional[int] = None, rows: Optional[int] = None,
              tris: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """2D mesh ('rows', 'tris') of the first ``n_devices`` of ``devices``
    (default: every visible CUDA device; raises without CUDA). Defaults:
    every device on 'rows', tris = 1. A device may repeat: four bands on
    ``["cuda:0"] * 4`` share one card."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh() takes the CUDA devices and CUDA "
                               "is not available; pass devices=[...] to "
                               "band on other devices")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = n_devices or len(devices)
    rows = rows or n
    tris = tris or (n // rows)
    if rows * tris != n:
        raise ValueError(f"mesh {rows}x{tris} != {n} devices")
    if n > len(devices):
        raise ValueError(f"mesh of {n} devices from {len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(rows, tris))


def shard_ranges(tri_count: int, rows: int) -> list:
    """[lo, hi) of each of ``rows`` shards of ``tri_count`` triangles:
    shard k holds ``[k * ceil(T / rows), (k + 1) * ceil(T / rows))``
    clipped to T, as JAX's ``P("rows")`` splits an axis (with T < rows
    the last shards are empty)."""
    chunk = -(-tri_count // rows)
    return [(min(k * chunk, tri_count), min((k + 1) * chunk, tri_count))
            for k in range(rows)]


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


def all_gather(pieces: list, device) -> dict:
    """Every device's pieces on ``device``: ``pieces`` holds one dict
    {key: tree of tensors} per device; the result merges them, each
    tensor moved to ``device`` (a peer copy from another card, ordered
    by events on both cards' current streams; no copy where it already
    lies there). Reads nothing back to the host."""
    out = {}
    for part in pieces:
        for key, tree in part.items():
            out[key] = tree_map(lambda t: t.to(device, non_blocking=True),
                                tree)
    return out


class Banded:
    """A frame cut into row bands, each a tensor on its own device (the
    JAX package's row-sharded array). ``cpu()`` and ``np.asarray``
    assemble the frame on the host, ``to(device)`` on ``device``."""

    def __init__(self, bands):
        self.bands = tuple(bands)

    @property
    def shape(self) -> tuple:
        return ((sum(b.shape[0] for b in self.bands),)
                + tuple(self.bands[0].shape[1:]))

    @property
    def devices(self) -> tuple:
        return tuple(b.device for b in self.bands)

    def cpu(self) -> torch.Tensor:
        return self.to("cpu")

    def to(self, device) -> torch.Tensor:
        return torch.cat([b.to(device) for b in self.bands])

    def __array__(self, dtype=None, copy=None):
        a = self.cpu().numpy()
        return a if dtype is None else a.astype(dtype, copy=False)


def split_bands(frame, devices: list) -> list:
    """``frame`` (a tensor or a :class:`Banded`) as one band per device,
    equal in height: a banded frame of the same devices keeps its
    bands."""
    if isinstance(frame, Banded):
        if list(frame.devices) == list(devices):
            return list(frame.bands)
        frame = frame.cpu()
    band = frame.shape[0] // len(devices)
    return [frame[k * band:(k + 1) * band].to(d, non_blocking=True)
            for k, d in enumerate(devices)]


def sharded_render_step(mesh: Mesh, height: int, width: int,
                        fragment_fn=None, return_winner: bool = False,
                        clip_capacity: int = 16, tiles: bool = False):
    """A render step over the mesh's row bands.

    step(tri_clip [T,3,4], tri_vary [T,3,C], valid [T], fb [H,W,4])
      -> fb :class:`Banded` [H,W,4]   (or (fb, winner Banded i32[H,W])
      with ``return_winner``)

    The triangles are clipped at the eye plane and set up once, at the
    full frame height, on the mesh's first device, and go to every band.
    ``tiles`` renders each band with binning and K1
    (:func:`..ops.raster.rasterize_bands`, no host sync);
    otherwise each band runs the per-triangle oracle loop over its own
    pixel centres. ``winner`` is the exact comparison surface (-1 where
    nothing covers)."""
    fragment_fn = fragment_fn or (lambda c: c)
    n_rows = mesh.shape["rows"]
    if height % n_rows:
        raise ValueError(f"height {height} not divisible by mesh rows "
                         f"{n_rows}")
    band = height // n_rows
    devices = mesh.band_devices()
    dev0 = devices[0]

    def step(tri_clip, tri_vary, valid, fb):
        tris = rc.Triangles(torch.as_tensor(tri_clip).to(dev0),
                            torch.as_tensor(tri_vary).to(dev0))
        # like the reference's step, it clips at a static capacity and
        # does not surface the overflow flag
        tris, valid, _overflow = rc.clip_near_capacity(
            tris, torch.as_tensor(valid).to(dev0), clip_capacity)
        tc = rc.triangle_setup(tris.clip, tris.vary, valid, width, height)
        fbs = split_bands(fb, devices)
        outs, winners = [], []
        if tiles:
            depths = [(k * band, torch.ones((band, width), device=d))
                      for k, d in enumerate(devices)]
            passes = raster.rasterize_bands(
                rc.pack_coeffs_full(tc), tc.valid,
                raster.viewport_bbox(tris.clip, width, height), width,
                height, depths)
            for (_d, w, num, den, _ovf), f in zip(passes, fbs):
                outs.append(raster.shade_from_planes(w, num, den, f,
                                                     fragment_fn))
                winners.append(w)
        else:
            rows = rc.pack_coeffs(tc)
            for k, (d, f) in enumerate(zip(devices, fbs)):
                px, py = rc.pixel_grids(band, width, y0=k * band, device=d)
                rows_d = rows.to(d, non_blocking=True)
                depth = torch.ones((band, width), device=d)
                w = torch.full((band, width), -1, dtype=torch.int32,
                               device=d)
                for t in range(rows_d.shape[0]):
                    cov, z = rc.coverage_depth(rows_d[t], px, py)
                    depth, w = rc.depth_test_update(cov, z, depth, w, t)
                tc_d = rc.TriCoeffs(*(x.to(d, non_blocking=True)
                                      for x in tc))
                varp, covered = rc.resolve_varyings(tc_d, w, px, py)
                outs.append(torch.where(covered[..., None],
                                        fragment_fn(varp), f))
                winners.append(w)
        out = Banded(outs)
        return (out, Banded(winners)) if return_winner else out

    return step
