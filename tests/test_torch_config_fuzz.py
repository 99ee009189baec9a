"""Seeded fuzz of the port's own raster configuration space against the
oracle, the counterpart of ``tests/test_config_fuzz.py`` (whose
``RasterConfig`` sweep is TPU machinery the port does not have).

The port's tile path has no tile-shape knobs: what varies is the frame
(partial 16x16 tiles on both axes), the band (rows [y0, y0 + h) of a
taller frame), the pair capacity of binning (at the pair count, and one
under it, where the overflow flag must rise), and runs of more than 128
records in one tile (K1 walks records in 128-record chunks). Each trial's
winners and depth must equal the oracle's exactly (``ops/raster_ref.py``,
over the whole frame, its rows cut to the band), the oracle's must
equal the JAX oracle's (jitted), and the oracle evaluated over bounding
-box windows must equal the oracle over the whole frame."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myrenderer_tpu.ops import raster_common as jrc
from myrenderer_tpu.ops import raster_ref as jrr
from myrenderer_tpu_torch.ops import raster, raster_ref
from myrenderer_tpu_torch.ops import raster_common as rc
from myrenderer_tpu_torch.utils.trisets import (crowded_triangles,
                                                random_triangles)

torch.set_num_threads(1)

TRIALS = 8


def trial(seed):
    """(H, W, clip, vary, y0, band) of one seeded trial."""
    rng = np.random.default_rng(2026 + seed)
    H = int(rng.integers(20, 90))
    W = int(rng.integers(20, 200))
    if seed % 3 == 2:
        # more than 128 records in one tile: K1's chunk edge
        box = (int(rng.integers(0, max(1, W - 16))),
               int(rng.integers(0, max(1, H - 16))))
        clip, vary = crowded_triangles(300, seed, H, W, box)
        dup = 40                   # exact depth ties across the chunks
        clip = np.concatenate([clip, clip[:dup]])
        vary = np.concatenate([vary, vary[:dup][..., ::-1].copy()])
    else:
        clip, vary = random_triangles(int(rng.choice([40, 150])), seed)
    y0 = int(rng.integers(0, H - 1))
    band = int(rng.integers(1, H - y0 + 1))
    return H, W, clip, vary, y0, band


@pytest.mark.parametrize("seed", range(TRIALS))
def test_random_frames_match_oracle(seed):
    H, W, clip, vary, y0, band = trial(seed)
    n = clip.shape[0]
    clip_t, vary_t = torch.from_numpy(clip), torch.from_numpy(vary)
    tc = rc.triangle_setup(clip_t, vary_t, torch.ones(n, dtype=torch.bool),
                           W, H, "back")
    bbox = raster.viewport_bbox(clip_t, W, H)
    d_ref, w_ref = raster_ref.rasterize_visibility(tc, H, W, bbox=bbox)
    d_full, w_full = raster_ref.rasterize_visibility(tc, H, W)
    assert torch.equal(w_ref, w_full)
    assert torch.equal(d_ref.view(torch.int32), d_full.view(torch.int32))
    jd, jw = jax.jit(lambda c, v: jrr.rasterize_visibility(
        jrc.triangle_setup(c, v, jnp.ones(n, bool), W, H, "back"), H, W))(
            clip, vary)
    np.testing.assert_array_equal(np.asarray(jw), w_ref.numpy())
    np.testing.assert_array_equal(np.asarray(jd).view(np.int32),
                                  d_ref.numpy().view(np.int32))

    packed = rc.pack_coeffs_full(tc)
    rows = slice(y0, y0 + band)
    for h, y in ((H, 0), (band, y0)):
        d, w, _num, _den, ovf = raster.rasterize_packed(
            packed, tc.valid, bbox, h, W, y0=y, vp_height=H)
        assert not bool(ovf)
        sl = slice(y, y + h)
        np.testing.assert_array_equal(w.numpy(), w_ref[sl].numpy())
        np.testing.assert_array_equal(d.numpy().view(np.int32),
                                      d_ref[sl].numpy().view(np.int32))
    if seed % 3 == 2:
        assert int(raster.bin_packed(packed, tc.valid, bbox, H, W)[2]
                   .max()) > 128

    # the pair capacity at the band's pair count, then one under it
    pairs = int(raster.bin_packed(packed, tc.valid, bbox, band, W,
                                  y0=y0)[2].sum())
    for cap, flagged in ((pairs, False), (pairs - 1, True)):
        if cap < 1:
            continue
        raster._FORCE_PAIR_CAPACITY = cap
        try:
            _d, w, _n, _dn, ovf = raster.rasterize_packed(
                packed, tc.valid, bbox, band, W, y0=y0, vp_height=H)
        finally:
            raster._FORCE_PAIR_CAPACITY = None
        assert bool(ovf) == flagged, (cap, pairs)
        if not flagged:
            np.testing.assert_array_equal(w.numpy(), w_ref[rows].numpy())
