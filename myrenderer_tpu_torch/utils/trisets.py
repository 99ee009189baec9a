"""Triangle sets and inputs for the kernels' checks (K1-K5), made with
numpy from a seed:
the CPU parity tests (``tests/test_torch_*.py``) and ``chip_smoke.py`` on
the card draw the same sets from here. Imports numpy only."""

from __future__ import annotations

import numpy as np


def random_triangles(n, seed, w_range=(0.8, 5.0), mixed_winding=False):
    """Random clip-space triangles, clockwise on screen (the generator
    of the JAX package's tests and of ``tools/tpu_checks.py``: the same
    seed gives the same triangles); ``w_range`` reaching below zero makes
    eye-plane straddlers, ``mixed_winding`` flips half of them."""
    rng = np.random.default_rng(seed)
    ndc = rng.uniform(-1.2, 1.2, (n, 3, 2)).astype(np.float32)
    z = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
    w = rng.uniform(*w_range, (n, 3)).astype(np.float32)
    d1 = ndc[:, 1] - ndc[:, 0]
    d2 = ndc[:, 2] - ndc[:, 0]
    flip = d1[:, 0] * (-d2[:, 1]) - (-d1[:, 1]) * d2[:, 0] < 0
    if mixed_winding:
        flip ^= rng.uniform(size=n) < 0.5
    ndc[flip] = ndc[flip][:, ::-1]
    clip = np.concatenate([ndc * np.abs(w)[..., None], (z * w)[..., None],
                           w[..., None]], axis=-1)
    vary = rng.uniform(0, 1, (n, 3, 4)).astype(np.float32)
    return clip, vary


def crowded_triangles(n, seed, H, W, box, w_range=(0.8, 5.0)):
    """Clockwise triangles of 1-3 pixels whose centres lie in the 16x16
    pixel box at ``box`` = (x0, y0) of an H x W frame, lifted to clip
    space: hundreds of records in one tile of K1."""
    rng = np.random.default_rng(seed)
    centre = rng.uniform(1.0, 15.0, (n, 1, 2)) + np.asarray(box, float)
    pix = centre + rng.uniform(-1.5, 1.5, (n, 3, 2))
    ndc = np.stack([2.0 * pix[..., 0] / W - 1.0,
                    1.0 - 2.0 * pix[..., 1] / H], -1).astype(np.float32)
    d1 = ndc[:, 1] - ndc[:, 0]
    d2 = ndc[:, 2] - ndc[:, 0]
    flip = d1[:, 0] * (-d2[:, 1]) - (-d1[:, 1]) * d2[:, 0] < 0
    ndc[flip] = ndc[flip][:, ::-1]
    z = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
    w = rng.uniform(*w_range, (n, 3)).astype(np.float32)
    clip = np.concatenate([ndc * w[..., None], (z * w)[..., None],
                           w[..., None]], axis=-1)
    vary = rng.uniform(0, 1, (n, 3, 4)).astype(np.float32)
    return clip, vary


def band_slivers(n, seed, H, W, y0, w_range=(0.8, 5.0)):
    """Clockwise slivers, 8-64 pixels long and at most half a pixel wide,
    in the rows [y0, H) of an H x W frame, lifted to clip space: K1's
    reject at a band offset. Each starts on a corner of a 4x4 sub-block
    (or a pixel centre) and runs along a sub-block border, across it at
    a random angle, or along a pixel-centre row, so its edges graze the
    borders and centres that the reject and the top-left rule test."""
    rng = np.random.default_rng(seed)
    start = np.stack([4.0 * rng.integers(0, W // 4, n),
                      y0 + 4.0 * rng.integers(0, (H - y0) // 4, n)], -1)
    start += rng.choice([0.0, 0.5], (n, 1)) + rng.choice(
        [0.0, 1e-4, -1e-4, 1e-2], (n, 2))
    angle = rng.uniform(0.0, 2.0 * np.pi, n)
    kind = rng.integers(0, 3, n)
    angle = np.where(kind == 0, 0.5 * np.pi * rng.integers(0, 4, n), angle)
    angle = np.where(kind == 1, np.pi * rng.integers(0, 2, n), angle)
    direction = np.stack([np.cos(angle), np.sin(angle)], -1)
    normal = np.stack([-direction[:, 1], direction[:, 0]], -1)
    length = rng.uniform(8.0, 64.0, (n, 1))
    width = rng.uniform(1e-3, 0.5, (n, 1))
    pix = np.stack([start, start + length * direction,
                    start + 0.5 * length * direction + width * normal], 1)
    pix[..., 0] = np.clip(pix[..., 0], 0.0, W)
    pix[..., 1] = np.clip(pix[..., 1], y0, H)
    ndc = np.stack([2.0 * pix[..., 0] / W - 1.0,
                    1.0 - 2.0 * pix[..., 1] / H], -1).astype(np.float32)
    d1 = ndc[:, 1] - ndc[:, 0]
    d2 = ndc[:, 2] - ndc[:, 0]
    flip = d1[:, 0] * (-d2[:, 1]) - (-d1[:, 1]) * d2[:, 0] < 0
    ndc[flip] = ndc[flip][:, ::-1]
    z = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
    w = rng.uniform(*w_range, (n, 3)).astype(np.float32)
    clip = np.concatenate([ndc * w[..., None], (z * w)[..., None],
                           w[..., None]], axis=-1)
    vary = rng.uniform(0, 1, (n, 3, 4)).astype(np.float32)
    return clip, vary


W_EPS = np.float32(1e-6)        # raster_common.W_EPS


def setup_batch(n, seed):
    """A batch for K2 (clip + setup + pack): (clip f32[n, 3, 4], vary
    f32[n, 3, 4], valid bool[n], ids i32[n], a permutation). Both
    windings, w across the eye plane, and in each eighth of the batch
    its own hard rows: w at, just above and just below W_EPS, 0 and -0;
    a repeated vertex (zero area); three collinear vertices; subnormal
    coordinates; huge coordinates; an inf or a NaN coordinate."""
    clip, vary = random_triangles(n, seed, w_range=(-0.5, 5.0),
                                  mixed_winding=True)
    rng = np.random.default_rng(seed + 1)
    k = max(n // 8, 1)
    part = [slice(i * k, min((i + 1) * k, n)) for i in range(7)]
    near = np.asarray([W_EPS, np.nextafter(W_EPS, np.float32(1)),
                       np.nextafter(W_EPS, np.float32(0)), 0.0, -0.0, 8e-6],
                      np.float32)
    w = clip[part[0], :, 3]
    clip[part[0], :, 3] = rng.choice(near, w.shape)
    clip[part[1], 1] = clip[part[1], 0]
    clip[part[2], 2] = 0.5 * (clip[part[2], 0] + clip[part[2], 1])
    sub = clip[part[3], :, :2]
    clip[part[3], :, :2] = sub * np.float32(1e-39)
    clip[part[4], :, :3] *= np.float32(1e30)
    bad = clip[part[5]]
    rows = np.arange(bad.shape[0])
    bad[rows, rows % 3, rows % 4] = np.where(rows % 2, np.inf, np.nan)
    clip[part[5]] = bad
    valid = rng.uniform(size=n) < 0.9
    ids = rng.permutation(n).astype(np.int32)
    return clip, vary, valid, ids


# a straddler's vertices, by kind: "in" above W_EPS, "out" at or below it
# (w <= W_EPS), "nan" neither
STRADDLER_KINDS = {"one_in": ("in", "out", "out"),
                   "two_in": ("in", "in", "out"),
                   "nan": ("in", "out", "nan")}


# the straddler selection's cases: name -> (T, straddlers, cap,
# straddler_batch keywords); the CPU tests and chip_smoke.py run each
STRADDLER_CASES = {
    "none": (600, 0, 128, {}),
    "one_in": (600, 1, 128, {"kinds": ("one_in",)}),
    "two_in": (600, 1, 128, {"kinds": ("two_in",)}),
    "exactly_cap": (700, 32, 32, {}),
    "cap_plus_one": (700, 33, 32, {}),
    "fewer_triangles_than_cap": (40, 9, 128, {}),
    "one_triangle": (1, 1, 8, {}),
    "w_at_w_eps_and_nan": (900, 60, 128, {"kinds": ("nan", "one_in"),
                                          "nan_rows": 25}),
    "invalid_among_straddlers": (900, 50, 64, {"invalid": 40}),
}


def straddler_case(name):
    """(clip, vary, valid, cap) of ``STRADDLER_CASES[name]``, seeded by
    the name."""
    T, n, cap, kw = STRADDLER_CASES[name]
    clip, vary, valid = straddler_batch(T, sum(map(ord, name)), n, **kw)
    return clip, vary, valid, cap


def straddler_batch(n, seed, straddlers, kinds=tuple(STRADDLER_KINDS),
                    invalid=0, nan_rows=0):
    """A batch for the straddler selection (K4): (clip f32[n, 3, 4], vary
    f32[n, 3, 4], valid bool[n]) with exactly ``straddlers`` valid
    eye-plane straddlers at random rows, each of a kind drawn from
    ``kinds`` (``STRADDLER_KINDS``, its vertices in a random rotation),
    plus ``invalid`` rows that would straddle but are not valid and
    ``nan_rows`` rows whose three w lanes are NaN. Every other row lies
    in front of the eye plane. Outside w values are drawn from W_EPS
    itself, the float just below it, 0, -0, a subnormal and negatives;
    inside ones from the float just above W_EPS, W_CLIP and positives."""
    clip, vary = random_triangles(n, seed)
    rng = np.random.default_rng(seed + 1)
    valid = np.ones(n, bool)
    rows = rng.permutation(n)[:straddlers + invalid + nan_rows]
    out_w = np.asarray([W_EPS, np.nextafter(W_EPS, np.float32(0)), 0.0, -0.0,
                        1e-40, -1e-3, -0.5, -2.0], np.float32)
    in_w = np.asarray([np.nextafter(W_EPS, np.float32(1)), 8e-6, 0.01, 0.7,
                       3.0], np.float32)
    for j, row in enumerate(rows[:straddlers + invalid]):
        kind = STRADDLER_KINDS[kinds[rng.integers(len(kinds))]]
        turn = rng.integers(3)
        for k in range(3):
            lane = kind[(k + turn) % 3]
            clip[row, k, 3] = (np.nan if lane == "nan" else
                               rng.choice(in_w if lane == "in" else out_w))
        valid[row] = j < straddlers
    clip[rows[straddlers + invalid:], :, 3] = np.nan
    return clip, vary, valid


# the graph-replay check of K4 (``profiling.k4_graph_replays``): each
# replay rewrites its batches with the next of these (straddlers,
# straddler_batch keywords; "in_last" puts them all in the batch's last
# rows), against a cap of REPLAY_CAP: none, fewer than cap, exactly cap,
# cap + 1, spread over many of K4's blocks, all in its last block, NaN rows,
# invalid rows among them
REPLAY_CAP = 64
STRADDLER_REPLAYS = ((0, {}), (10, {}), (64, {}), (65, {}), (3000, {}),
                     (40, {"in_last": 200}), (50, {"nan_rows": 500}),
                     (64, {"invalid": 100}))


def straddler_replay(n, r):
    """Replay ``r``'s batch of ``n`` triangles: (clip, vary, valid) as
    ``straddler_batch`` makes them, by ``STRADDLER_REPLAYS[r % 8]``."""
    want, kw = STRADDLER_REPLAYS[r % len(STRADDLER_REPLAYS)]
    kw = dict(kw)
    last = kw.pop("in_last", 0)
    if not last:
        return straddler_batch(n, r, want, **kw)
    clip, vary, valid = straddler_batch(n, r, 0)
    for a, b in zip((clip, vary, valid),
                    straddler_batch(last, r + 1, min(want, last))):
        a[-last:] = b
    return clip, vary, valid


def terrain_inputs(size, instances, seed):
    """Inputs of the terrain's whole-stream vertex function (K3):
    heights f32[instances, size^2] in [0, 1] with exact 0s, 1s and
    subnormals among them (where there are at least 3 heights); uniforms f32[instances, 17] (a random data
    transform, then ``size``); worlds f32[instances, 4, 4] (random
    perspective-like matrices)."""
    rng = np.random.default_rng(seed)
    s2 = size * size
    heights = rng.uniform(0, 1, (instances, s2)).astype(np.float32)
    # a fifth of the heights (at least 5, or all) take these in turn
    special = np.asarray([0.0, 1.0, 1e-40, 3e-39, -0.0], np.float32)
    pick = rng.permutation(heights.size)[:max(5, heights.size // 5)]
    heights.flat[pick] = np.resize(special, pick.size)
    uniforms = np.zeros((instances, 17), np.float32)
    uniforms[:, :16] = (np.eye(4, dtype=np.float32).reshape(-1)
                        + rng.normal(0, 0.3, (instances, 16)))
    uniforms[:, 16] = size
    worlds = rng.normal(0, 1, (instances, 4, 4)).astype(np.float32)
    return heights, uniforms, worlds


def bin_boxes(n, seed, H, W, big=0.05, off=0.0, nan=0.0, invalid=0.0,
              full=0, crowd=0.0, inverted=0.0, giant=0):
    """Inputs of K5 (binning) for an H x W frame: (valid bool[n], bbox
    f32[4, n] as min u, max u, min v, max v). Most boxes are a few pixels
    wide, a fraction ``big`` up to one and a half frames; a fifth sit on
    whole pixels and a tenth on tile borders (the floor and ceil edges);
    a fraction ``off`` lies wholly outside the frame (left, right, above
    or below), ``nan`` has one NaN coordinate, ``invalid`` is flagged
    invalid, ``full`` records spread over the set cover every tile, and a
    fraction ``crowd`` are boxes of a pixel or two inside the 16x16 tile
    at the frame's centre (thousands of records in one tile). A fraction
    ``inverted`` has its min and max swapped on one axis or both, and
    with it the last box is one inverted on both axes across many tiles
    (rects empty on an axis: no pair). ``giant`` boxes from the middle of
    the set on cover 92 % of the frame's width and 90 % of its height (a
    triangle over most of the frame, as the demo's near terrain)."""
    rng = np.random.default_rng(seed)
    cx = rng.uniform(-0.05 * W, 1.05 * W, n)
    cy = rng.uniform(-0.05 * H, 1.05 * H, n)
    large = rng.uniform(size=n) < big
    w = np.where(large, rng.uniform(0, 1.5 * W, n), rng.exponential(6.0, n))
    h = np.where(large, rng.uniform(0, 1.5 * H, n), rng.exponential(6.0, n))
    box = np.stack([cx - w / 2, cx + w / 2, cy - h / 2, cy + h / 2])
    packed = rng.uniform(size=n) < crowd
    corner = np.asarray([[W // 32 * 16], [H // 32 * 16]], np.float64)
    lo = corner + rng.uniform(0.5, 14.0, (2, n))
    hi = lo + rng.uniform(0.0, 1.5, (2, n))
    box[:, packed] = np.stack([lo[0], hi[0], lo[1], hi[1]])[:, packed]
    snap = rng.uniform(size=n)
    box[:, snap < 0.2] = np.round(box[:, snap < 0.2])
    box[:, snap < 0.1] = np.round(box[:, snap < 0.1] / 16.0) * 16.0
    gone = np.nonzero(rng.uniform(size=n) < off)[0]
    side = rng.integers(0, 4, gone.size)
    for k, (lo, hi, extent) in enumerate(((0, 1, W), (0, 1, W),
                                          (2, 3, H), (2, 3, H))):
        g = gone[side == k]
        shift = (-box[hi, g] - 1.0) if k % 2 == 0 else (extent - box[lo, g])
        box[lo, g] += shift
        box[hi, g] += shift
    bad = np.nonzero(rng.uniform(size=n) < nan)[0]
    box[rng.integers(0, 4, bad.size), bad] = np.nan
    if inverted:
        flip = np.nonzero(rng.uniform(size=n) < inverted)[0]
        axes = rng.integers(0, 3, flip.size)       # u, v or both
        for a, (lo, hi) in enumerate(((0, 1), (2, 3))):
            g = flip[(axes == a) | (axes == 2)]
            box[lo, g], box[hi, g] = box[hi, g].copy(), box[lo, g].copy()
        box[:, -1] = [0.8 * W, 0.2 * W, 0.7 * H, 0.3 * H]
    if giant:
        at = np.linspace(n // 2, n - 1, giant).astype(np.int64)
        box[:, at] = np.asarray([[0.04 * W], [0.96 * W], [0.05 * H],
                                 [0.95 * H]])
    if full:
        every = rng.choice(n, size=min(full, n), replace=False)
        box[:, every] = np.asarray([[-3.5], [W + 2.5], [-7.0], [H + 1.0]])
    valid = rng.uniform(size=n) >= invalid
    return valid, box.astype(np.float32)


# K5's cases (``tests/test_torch_binning.py``, ``chip_smoke.py``): name ->
# (records, seed, frame (H, W), band (height, y0) or None for the frame,
# ``bin_boxes`` keywords)
BIN_CASES = {
    "random": (3000, 1, (200, 300), None, {}),
    "off the frame, NaN and invalid": (3000, 2, (200, 300), None,
                                       {"off": 0.2, "nan": 0.1,
                                        "invalid": 0.2}),
    "a box over every tile": (500, 3, (200, 300), None, {"full": 1}),
    "ragged frame": (2000, 4, (93, 161), None, {"big": 0.2, "full": 2}),
    "band at y0 = 64": (3000, 5, (256, 300), (64, 64), {"nan": 0.05}),
    "last band, ragged": (3000, 6, (250, 300), (58, 192), {"off": 0.1}),
    "one record": (1, 7, (64, 64), None, {}),
    "crowded": (5000, 8, (48, 48), None, {"big": 0.5}),
    "one tile of 5,000": (8000, 10, (96, 128), None, {"big": 0.0,
                                                     "crowd": 0.65}),
    "inverted boxes": (3000, 11, (200, 300), None, {"big": 0.3,
                                                    "inverted": 0.3}),
    "one big triangle among 20,000": (20000, 13, (1080, 1920), None,
                                      {"big": 0.0, "giant": 1}),
}


def bin_case(name):
    """(valid, bbox, height, width, y0) of ``BIN_CASES[name]``: the band
    to bin and the frame's boxes."""
    n, seed, (H, W), band, kw = BIN_CASES[name]
    valid, bbox = bin_boxes(n, seed, H, W, **kw)
    height, y0 = (H, 0) if band is None else band
    return valid, bbox, height, W, y0


# the graph-replay check of K5 (``profiling.k5_graph_replays``): each
# replay rewrites its boxes with the next of these ``bin_boxes`` keywords:
# small boxes, a few big ones and a crowded tile,
# off-frame and NaN boxes, every row invalid, boxes over every tile, a
# tile past the block's shared memory, inverted boxes, and the default
# (overflowing)
BIN_REPLAYS = ({"big": 0.0}, {"big": 0.002, "crowd": 0.05},
               {"off": 0.5, "nan": 0.2}, {"invalid": 1.0},
               {"full": 3, "big": 0.0}, {"big": 0.0, "crowd": 0.3},
               {"big": 0.05, "inverted": 0.3}, {})
