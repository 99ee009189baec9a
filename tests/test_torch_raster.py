"""Raster-pass parity: the port's CSR binning plus K1's plain
PyTorch version (``raster.rasterize_packed`` on CPU tensors) against the
JAX package's ``rasterize_packed`` (Pallas kernel in interpret mode) on
identical packed records. Winners exact; depth within the repo's 2-ulp
oracle-vs-Pallas bound (tests/test_raster_pallas.py); the varying planes
bit-equal.

The last test holds the CUDA kernel against the plain version on the
card (marked ``cuda``; it skips without one)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myrenderer_tpu.ops import raster_pallas as jrp
from myrenderer_tpu_torch.ops import raster, raster_cuda
from myrenderer_tpu_torch.utils.trisets import (crowded_triangles,
                                                random_triangles)
from test_torch_raster_common import assert_bits_equal, jax_setup_batch

torch.set_num_threads(1)

CFG = jrp.RasterConfig(tile_h=8, tile_w=128, max_tiles_per_tri=8,
                       big_capacity=256, stream_window=64, interpret=True)

# every case pads its records to this count (invalid rows), so the JAX
# raster pass compiles once per frame size
ROWS = 1024

jax_rasterize_packed = jax.jit(
    functools.partial(jrp.rasterize_packed, cfg=CFG),
    static_argnames=("height", "width"))


def packed_frame(batches, H, W, reverse=False):
    """Concatenated records of several batches packed as the merged pass
    packs them: batch s of S gets z bias 2*(S-1-s) and global ids from
    its base. ``batches`` holds (n, seed, dup, w_lo[, box]) per batch;
    ``dup`` appends copies of the first triangles (exact depth ties),
    ``w_lo`` < 0 makes eye-plane straddlers, and ``box`` crowds the
    batch's small triangles into one tile (:func:`crowded_triangles`).
    ``reverse`` stores the records last first, so ids fall as rows rise
    and a depth tie goes to the record that comes later in a tile."""
    S = len(batches)
    parts, base = [], 0
    for s, (n, seed, dup, w_lo, *box) in enumerate(batches):
        if box:
            clip, vary = crowded_triangles(n, seed, H, W, box[0],
                                           w_range=(w_lo, 5.0))
        else:
            clip, vary = random_triangles(n, seed, w_range=(w_lo, 5.0))
        if dup:
            clip = np.concatenate([clip, clip[:dup]])
            vary = np.concatenate([vary, vary[:dup, :, ::-1]])
        valid = np.ones(clip.shape[0], bool)
        packed, v, bbox = jax_setup_batch(
            clip, vary, valid, W, H,
            z_bias=2.0 * (S - 1 - s) if S > 1 else None, base=base)
        parts.append((np.asarray(packed), np.asarray(v),
                      [np.asarray(c) for c in bbox]))
        base += packed.shape[0]
    if reverse:
        parts = [(p[::-1], v[::-1], [c[::-1] for c in b])
                 for p, v, b in parts[::-1]]
    pad = ROWS - base
    packed = np.concatenate([p for p, _v, _b in parts]
                            + [np.zeros((pad, 32), np.float32)])
    valid = np.concatenate([v for _p, v, _b in parts]
                           + [np.zeros(pad, bool)])
    bbox = [np.concatenate([b[k] for _p, _v, b in parts]
                           + [np.zeros(pad, np.float32)]) for k in range(4)]
    return packed, valid, bbox, 2.0 * (S - 1) + 1.0


def assert_ulps(a, b, bound):
    a, b = np.asarray(a), b.numpy()
    ulps = np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))
    assert ulps.max() <= bound, f"{ulps.max()} ulps apart"


CASES = {
    "48x160 n1": ((48, 160), [(1, 0, 0, 0.8)]),
    "48x160 n7": ((48, 160), [(7, 1, 0, 0.8)]),
    "48x160 n40 ties": ((48, 160), [(40, 2, 10, 0.8)]),
    "48x160 n200 ties": ((48, 160), [(200, 3, 60, 0.8)]),
    "128x128 n200 straddlers": ((128, 128), [(200, 4, 0, -0.5)]),
    "128x128 3 batches": ((128, 128), [(120, 5, 30, -0.5), (60, 6, 0, 0.8),
                                       (9, 7, 3, 0.8)]),
    "47x161 ragged ties": ((47, 161), [(120, 10, 20, 0.8)]),
    # 400 + 300 duplicates in one tile: 6 chunks of K1's ring, ties
    # between records in different chunks
    "48x160 crowded tile ties": ((48, 160), [(400, 11, 300, 0.8,
                                              (16, 16))]),
    "48x160 n200 ties, ids falling": ((48, 160), [(200, 3, 60, 0.8)], True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_rasterize_packed_parity(case):
    (H, W), batches, *reverse = CASES[case]
    packed, valid, bbox, depth0 = packed_frame(batches, H, W, *reverse)
    depth = np.full((H, W), depth0, np.float32)
    jd, jw, jnum, jden, jovf = jax_rasterize_packed(
        jnp.asarray(packed), jnp.asarray(valid),
        tuple(jnp.asarray(c) for c in bbox), height=H, width=W,
        depth=jnp.asarray(depth))
    assert not bool(np.asarray(jovf).any())
    td, tw, tnum, tden, tovf = raster.rasterize_packed(
        torch.from_numpy(packed), torch.from_numpy(valid),
        tuple(torch.from_numpy(c) for c in bbox), H, W,
        depth=torch.from_numpy(depth))
    assert tovf.shape == () and not bool(tovf)
    np.testing.assert_array_equal(np.asarray(jw), tw.numpy())
    assert_ulps(jd, td, 2)
    assert_bits_equal(jnum, tnum)
    assert_bits_equal(jden, tden)
    assert int((tw >= 0).sum()) > 0


def test_bin_packed_is_exact():
    """Every record lands in exactly the tiles its clipped bounding box
    touches, ascending within a tile, and nowhere else: each tile's
    segment of the index names exactly those rows of ``packed``."""
    H, W = 70, 90
    packed, valid, bbox, _d = packed_frame([(80, 8, 0, -0.5)], H, W)
    index, starts, counts, overflow = raster.bin_packed(
        torch.from_numpy(packed), torch.from_numpy(valid),
        tuple(torch.from_numpy(c) for c in bbox), H, W)
    assert index.dtype == torch.int32 and not bool(overflow)
    assert index.shape[0] == raster.pair_capacity(packed.shape[0])
    TH, TW = raster_cuda.TILE_H, raster_cuda.TILE_W
    nty, ntx = -(-H // TH), -(-W // TW)
    ph = nty * TH
    index, starts, counts = index.numpy(), starts.numpy(), counts.numpy()
    assert starts[0] == 0 and 0 < counts.sum() < index.shape[0]
    np.testing.assert_array_equal(starts[1:], np.cumsum(counts)[:-1])
    live = (valid & (bbox[3] >= 0) & (bbox[2] < ph) & (bbox[1] >= 0)
            & (bbox[0] < W))
    tx0 = (np.clip(np.floor(bbox[0]), 0, W - 1) / TW).astype(int)
    tx1 = (np.clip(np.ceil(bbox[1]), 0, W - 1) / TW).astype(int)
    ty0 = (np.clip(np.floor(bbox[2]), 0, ph - 1) / TH).astype(int)
    ty1 = (np.clip(np.ceil(bbox[3]), 0, ph - 1) / TH).astype(int)
    for t in range(nty * ntx):
        ty, tx = divmod(t, ntx)
        want = np.nonzero(live & (tx0 <= tx) & (tx <= tx1) & (ty0 <= ty)
                          & (ty <= ty1))[0]
        seg = index[starts[t]:starts[t] + counts[t]]
        np.testing.assert_array_equal(want, seg)
        assert_bits_equal(packed[want], packed[seg])


def test_rasterize_packed_empty():
    H, W = 16, 40
    packed = np.zeros((3, 32), np.float32)
    d, w, num, den, overflow = raster.rasterize_packed(
        torch.from_numpy(packed), torch.zeros(3, dtype=torch.bool),
        tuple(torch.zeros(3) for _ in range(4)), H, W)
    assert bool((w == -1).all()) and bool((d == 1).all())
    assert not bool(overflow)
    assert bool((den == 1).all()) and bool((num == 0).all())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_k1_matches_plain_version_on_card(case, cuda_device):
    """K1 against its plain version on the card: winners exact, depth
    and planes bit-exact, one launch counted."""
    (H, W), batches, *reverse = CASES[case]
    packed, valid, bbox, depth0 = packed_frame(batches, H, W, *reverse)
    dev = cuda_device
    packed = torch.from_numpy(packed).to(dev)
    index, starts, counts, _overflow = raster.bin_packed(
        packed, torch.from_numpy(valid).to(dev),
        tuple(torch.from_numpy(c).to(dev) for c in bbox), H, W)
    depth = torch.full((H, W), depth0, device=dev)
    before = raster_cuda.K1.launches
    fused, winner = raster_cuda.rasterize_tiles(packed, index, starts,
                                                counts, depth)
    assert raster_cuda.K1.launches == before + 1
    rfused, rwinner = raster_cuda.rasterize_tiles_reference(
        packed, index, starts, counts, depth)
    assert torch.equal(winner, rwinner)
    assert torch.equal(fused.view(torch.int32), rfused.view(torch.int32))
