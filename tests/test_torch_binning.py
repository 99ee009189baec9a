"""K5, binning (``ops/binning.py``) behind ``raster.bin_packed`` and
``raster.bin_bands``.

On the CPU ``bin_tiles`` runs K5's plain version, ``bin_tiles_reference``;
these tests hold it to a numpy model of the contract written here (each
record's tile rect, its pairs in record order, the first C kept, a stable
order by tile, the dead slots holding R - 1): boxes on and off the frame,
NaN boxes, invalid rows, inverted boxes (min past max: no pair), a box
over every tile, ragged frames, bands with
y0 > 0, one record and none, a crowded frame, a starved capacity (through
``raster._FORCE_PAIR_CAPACITY``) and a span sum above 2^31. The JAX
package bins into another layout (its stream and big-triangle list), so
the binning reaches it through ``rasterize_packed``'s parity tests
(``tests/test_torch_raster.py``, ``tests/test_torch_parallel.py``). The
tests marked ``cuda`` hold K5 to its plain version with ``torch.equal``
on all four results, eagerly, inside the renderer's frames and as a CUDA
graph replayed with its inputs rewritten (``profiling.k5_graph_replays``),
and on grids set by hand (the card's whole residency, one block an SM),
and skip without a card."""

import numpy as np
import pytest
import torch

from myrenderer_tpu_torch.ops import binning, raster
from myrenderer_tpu_torch.utils import profiling
from myrenderer_tpu_torch.utils.trisets import (BIN_CASES, BIN_REPLAYS,
                                                bin_boxes, bin_case)

torch.set_num_threads(1)

TILE = 16


def model_bins(valid, bbox, height, width, y0, capacity):
    """The contract in numpy: (index, starts, counts, overflow, pairs)."""
    nty, ntx = -(-height // TILE), -(-width // TILE)
    ph = nty * TILE
    b0, b1, b2, b3 = (np.asarray(c, np.float32) for c in bbox)
    with np.errstate(invalid="ignore"):
        live = (np.asarray(valid) & (b3 >= y0) & (b2 < y0 + ph) & (b1 >= 0)
                & (b0 < width))
    rect = np.zeros((4, live.size), np.int64)
    for k, (v, lo, hi, off) in enumerate(
            ((np.floor(b0), 0, width - 1, 0), (np.ceil(b1), 0, width - 1, 0),
             (np.floor(b2), 0, ph - 1, y0), (np.ceil(b3), 0, ph - 1, y0))):
        c = np.clip(v[live] - np.float32(off), lo, hi)
        rect[k, live] = (c / np.float32(TILE)).astype(np.int64)
    tx0, tx1, ty0, ty1 = rect
    sx, sy = tx1 - tx0 + 1, ty1 - ty0 + 1
    # a rect empty on an axis (min past max) has no pair
    span = np.where(live & (sx > 0) & (sy > 0), sx * sy, 0)
    first = np.cumsum(span) - span
    kept = np.clip(capacity - first, 0, span)
    tiles, recs = [np.zeros(0, np.int64)], [np.zeros(0, np.int64)]
    for r in np.nonzero(kept)[0]:
        k = np.arange(kept[r])
        tiles.append((ty0[r] + k // sx[r]) * ntx + tx0[r] + k % sx[r])
        recs.append(np.full(kept[r], r))
    tiles, recs = np.concatenate(tiles), np.concatenate(recs)
    order = np.argsort(tiles, kind="stable")
    counts = np.bincount(tiles, minlength=nty * ntx)
    R = live.size
    index = np.full(capacity, max(R - 1, 0), np.int64)
    index[:tiles.size] = recs[order]
    return (index.astype(np.int32), (np.cumsum(counts) - counts)
            .astype(np.int32), counts.astype(np.int32),
            int(span.sum()) > capacity, int(span.sum()))


def assert_model(got, valid, bbox, height, width, y0, capacity):
    index, starts, counts, overflow, total = model_bins(
        valid, bbox, height, width, y0, capacity)
    g_index, g_starts, g_counts, g_overflow = got
    assert g_index.dtype == g_starts.dtype == g_counts.dtype == torch.int32
    assert g_overflow.dtype == torch.bool and g_overflow.shape == ()
    np.testing.assert_array_equal(index, g_index.numpy())
    np.testing.assert_array_equal(starts, g_starts.numpy())
    np.testing.assert_array_equal(counts, g_counts.numpy())
    assert bool(g_overflow) == overflow
    return total


def args_of(name):
    valid, bbox, height, width, y0 = bin_case(name)
    return (torch.from_numpy(valid), torch.from_numpy(bbox), height, width,
            y0)


@pytest.mark.parametrize("name", list(BIN_CASES))
def test_plain_version_matches_model(name):
    """bin_tiles (the plain version on the CPU) against the model at the
    pass's pair capacity: no overflow, every pair kept."""
    valid, bbox, height, width, y0 = args_of(name)
    cap = raster.pair_capacity(valid.shape[0])
    got = binning.bin_tiles(valid, bbox, height, width, y0, cap)
    total = assert_model(got, valid.numpy(), bbox.numpy(), height, width,
                         y0, cap)
    assert 0 < total <= cap
    for a, b in zip(got, binning.bin_tiles_reference(valid, bbox, height,
                                                     width, y0, cap)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", list(BIN_CASES))
def test_overflow_keeps_pairs_in_record_order(name, monkeypatch):
    """A starved capacity (raster._FORCE_PAIR_CAPACITY) through
    raster.bin_packed: the first C pairs in record order are kept and
    binned as the model bins them, the flag is set where the pairs
    outgrow C, and every segment lies in [0, C]."""
    valid, bbox, height, width, y0 = args_of(name)
    pairs = model_bins(valid.numpy(), bbox.numpy(), height, width, y0,
                       0)[4]
    cap = max(pairs // 3, 1)
    monkeypatch.setattr(raster, "_FORCE_PAIR_CAPACITY", cap)
    packed = torch.zeros((valid.shape[0], 32))
    got = raster.bin_packed(packed, valid, tuple(bbox), height, width,
                            y0=y0)
    assert got[0].shape == (cap,)
    assert_model(got, valid.numpy(), bbox.numpy(), height, width, y0, cap)
    assert bool(got[3]) == (pairs > cap)
    assert int((got[1] + got[2]).max()) <= cap and int(got[1].min()) >= 0


def test_bands_match_model():
    """bin_bands over four bands of a 256-row frame (y0 = 0, 64, 128,
    192), each against the model of its band."""
    valid, bbox = bin_boxes(4000, 9, 256, 200, big=0.1, nan=0.05,
                            off=0.1, invalid=0.1)
    v, b = torch.from_numpy(valid), torch.from_numpy(bbox)
    bins = raster.bin_bands([(v, tuple(b), 64, y0)
                             for y0 in (0, 64, 128, 192)], 200)
    for y0, got in zip((0, 64, 128, 192), bins):
        assert_model(got, valid, bbox, 64, 200, y0,
                     raster.pair_capacity(4000))


def test_no_records_gives_zeros():
    """R = 0: a zero index of C slots, zero starts and counts, no flag."""
    got = binning.bin_tiles(torch.zeros(0, dtype=torch.bool),
                            torch.zeros((4, 0)), 40, 70, 0, 4096)
    assert [tuple(t.shape) for t in got] == [(4096,), (15,), (15,), ()]
    assert not any(bool(t.any()) for t in got)
    assert_model(got, np.zeros(0, bool), np.zeros((4, 0), np.float32), 40,
                 70, 0, 4096)


def test_every_tile_box():
    """One box over every tile of a 37 x 70 frame lands once in each of
    its 15 tiles; a second one behind it follows it in every segment."""
    bbox = np.asarray([[-5.0, 3.0], [80.0, 90.0], [-1.0, -2.0],
                       [40.0, 37.5]], np.float32)
    got = binning.bin_tiles(torch.ones(2, dtype=torch.bool),
                            torch.from_numpy(bbox), 37, 70, 0, 4096)
    assert got[2].tolist() == [2] * 15
    assert got[0][:30].tolist() == [0, 1] * 15
    assert_model(got, np.ones(2, bool), bbox, 37, 70, 0, 4096)


def big_spans():
    """524,289 records, each over all 4,096 tiles of a 1024 x 1024 frame:
    their spans sum to 2^31 + 4,096."""
    R = 2**31 // 4096 + 1
    bbox = np.tile(np.asarray([[-1.0], [1030.0], [-1.0], [1030.0]],
                              np.float32), (1, R))
    return np.ones(R, bool), bbox


def test_span_sum_above_two_to_the_31():
    """Spans summing past 2^31 on a small frame: the prefix stays 64-bit,
    the first C pairs (those of the first C / 4,096 records) are kept in
    record order, and the flag is set."""
    valid, bbox = big_spans()
    cap = raster.pair_capacity(valid.size)
    got = binning.bin_tiles(torch.from_numpy(valid), torch.from_numpy(bbox),
                            1024, 1024, 0, cap)
    total = assert_model(got, valid, bbox, 1024, 1024, 0, cap)
    assert total == 2**31 + 4096 and bool(got[3])
    assert int(got[2].sum()) == cap


@pytest.mark.parametrize("bad", ["valid dtype", "box dtype", "box shape",
                                 "box device", "three boxes", "capacity",
                                 "band", "tiles"])
def test_check_raises(bad):
    """bin_tiles refuses arguments K5 does not take."""
    valid, bbox = torch.ones(5, dtype=torch.bool), list(torch.zeros(4, 5))
    height, cap = 32, 4096
    if bad == "valid dtype":
        valid = valid.int()
    elif bad == "box dtype":
        bbox[1] = bbox[1].double()
    elif bad == "box shape":
        bbox[2] = bbox[2][:4]
    elif bad == "box device":
        bbox[3] = bbox[3].to("meta")
    elif bad == "three boxes":
        bbox = bbox[:3]
    elif bad == "capacity":
        cap = 2**31
    elif bad == "tiles":
        height = 16 * (binning.MAX_TILES // 2 + 1)
    else:
        height = 0
    with pytest.raises((TypeError, ValueError)):
        binning.bin_tiles(valid, bbox, height, 32, 0, cap)


def test_graph_replay_inputs_cover_the_cases():
    """The boxes profiling.k5_graph_replays writes before its replays
    hold the kinds the model tests cover: boxes off the frame and NaN
    ones, invalid rows, boxes over every tile, crowded tiles, inverted
    boxes, and sets of no live record."""
    kinds = set()
    for r, kw in enumerate(BIN_REPLAYS):
        valid, bbox = bin_boxes(2000, r, 1080, 1920, **kw)
        kinds.update(k for k in kw if kw[k])
        cap = raster.pair_capacity(2000)
        for height, y0 in ((1080, 0), (270, 540)):
            assert_model(binning.bin_tiles(torch.from_numpy(valid),
                                           torch.from_numpy(bbox), height,
                                           1920, y0, cap),
                         valid, bbox, height, 1920, y0, cap)
    assert {"big", "off", "nan", "invalid", "full", "crowd",
            "inverted"} <= kinds


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def card_against_plain(valid, bbox, height, width, y0, cap, dev):
    """K5 and its plain version on the card: one launch, the four results
    equal."""
    v = torch.from_numpy(valid).to(dev)
    b = torch.from_numpy(bbox).to(dev)
    before = binning.K5.launches
    got = binning.bin_tiles(v, b, height, width, y0, cap)
    assert binning.K5.launches == before + (valid.size > 0)
    want = binning.bin_tiles_reference(v, b, height, width, y0, cap)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert a.device == w.device and torch.equal(a, w)
    return want


def card_on_grid(valid, bbox, height, width, y0, cap, dev, blocks):
    """K5 on a grid of ``blocks`` blocks against its plain version: the
    four results equal; returns the plain version's."""
    v = torch.from_numpy(valid).to(dev)
    b = torch.from_numpy(bbox).to(dev)
    got = binning.K5(v, tuple(b), height, width, y0, cap, blocks=blocks)
    want = binning.bin_tiles_reference(v, b, height, width, y0, cap)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    return want


def scratch_dirty():
    """Non-zero words left in K5's eager scratches."""
    return sum(int(t.count_nonzero())
               for t in binning.K5.scratch._eager.values())


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(BIN_CASES))
def test_k5_matches_plain_version_on_card(name, cuda_device):
    """K5 against its plain version at the pass's capacity and starved to
    a third of the pairs."""
    valid, bbox, height, width, y0 = bin_case(name)
    want = card_against_plain(valid, bbox, height, width, y0,
                              raster.pair_capacity(valid.size), cuda_device)
    pairs = int(want[2].sum())
    card_against_plain(valid, bbox, height, width, y0, max(pairs // 3, 1),
                       cuda_device)


@pytest.mark.cuda
def test_k5_edge_cases_on_card(cuda_device):
    """No record, a span sum past 2^31, and four bands of one frame."""
    card_against_plain(np.zeros(0, bool), np.zeros((4, 0), np.float32), 40,
                       70, 0, 4096, cuda_device)
    valid, bbox = big_spans()
    card_against_plain(valid, bbox, 1024, 1024, 0,
                       raster.pair_capacity(valid.size), cuda_device)
    valid, bbox = bin_boxes(4000, 9, 256, 200, big=0.1, nan=0.05, off=0.1,
                            invalid=0.1)
    for y0 in (0, 64, 128, 192):
        card_against_plain(valid, bbox, 64, 200, y0,
                           raster.pair_capacity(4000), cuda_device)


@pytest.mark.cuda
def test_k5_band_at_the_residency_limit(cuda_device):
    """The grid at the card's whole residency (every block the SMs hold at
    once, past the kernel's own cap where the card holds more) bins the 8K
    frame (129,600 tiles, 127 chunks of 1,024) and a band of MAX_TILES
    tiles as the plain version does, and leaves the scratch zeroed."""
    resident = binning.K5.resident_blocks(cuda_device)
    assert resident >= binning.K5.blocks(cuda_device, 20000) > 0
    for height, width in ((4320, 7680), (16 * 1024, 16 * 1024)):
        valid, bbox = bin_boxes(20000, 12, height, width, big=0.01, full=1)
        card_on_grid(valid, bbox, height, width, 0,
                     raster.pair_capacity(valid.size), cuda_device, resident)
    assert scratch_dirty() == 0


@pytest.mark.cuda
def test_k5_records_past_the_block_cache(cuda_device):
    """One block an SM, so that each block holds more records than it
    keeps in shared memory from phase 1 to 2 (2,048) and its compaction
    reads the boxes again a round at a time: spans past 2^31 (524,289
    records, about 3,970 a block on 132 SMs) and a 4K frame of a million
    boxes, each at its capacity and starved to a third of its pairs."""
    sms = binning.K5.occupancy(cuda_device)[1]
    big = big_spans() + (1024, 1024)
    frame = bin_boxes(1_000_000, 14, 2160, 3840, big=0.0) + (2160, 3840)
    for valid, bbox, height, width in (big, frame):
        assert valid.size / sms > 2048
        cap = raster.pair_capacity(valid.size)
        want = card_on_grid(valid, bbox, height, width, 0, cap, cuda_device,
                            sms)
        card_on_grid(valid, bbox, height, width, 0,
                     max(int(want[2].sum()) // 3, 1), cuda_device, sms)
    assert scratch_dirty() == 0


@pytest.mark.cuda
def test_k5_refuses_a_grid_past_the_resident_blocks(cuda_device):
    """One block more than the card holds at once: the cooperative launch
    is refused (no kernel runs, nothing is counted, the scratch stays
    zeroed), the wrapper raises, and the next launch runs as before."""
    valid, bbox, height, width, y0 = bin_case("random")
    v = torch.from_numpy(valid).to(cuda_device)
    b = tuple(torch.from_numpy(bbox).to(cuda_device))
    cap = raster.pair_capacity(valid.size)
    before = binning.K5.launches
    with pytest.raises(RuntimeError, match="launch"):
        binning.K5(v, b, height, width, y0, cap,
                   blocks=binning.K5.resident_blocks(cuda_device) + 1)
    assert binning.K5.launches == before
    torch.cuda.synchronize()
    assert scratch_dirty() == 0
    card_against_plain(valid, bbox, height, width, y0, cap, cuda_device)


@pytest.mark.cuda
def test_k5_big_triangle_pass(cuda_device):
    """The demo's case: one triangle over most of a 1920 x 1080 frame
    among 20,000 small ones, its thousands of pairs shared out over the
    blocks by pair ranges. K5 equals its plain version at the pass's
    capacity, starved to a third of its pairs (the cut inside the big
    triangle's pairs), and on four bands; and the launch's phase times
    are stamped in order."""
    valid, bbox, height, width, y0 = bin_case(
        "one big triangle among 20,000")
    cap = raster.pair_capacity(valid.size)
    want = card_against_plain(valid, bbox, height, width, y0, cap,
                              cuda_device)
    pairs = int(want[2].sum())
    card_against_plain(valid, bbox, height, width, y0, pairs // 3,
                       cuda_device)
    for k in range(4):
        card_against_plain(valid, bbox, height // 4, width, k * height // 4,
                           cap, cuda_device)
    phases = binning.K5.phase_times(
        torch.from_numpy(valid).to(cuda_device),
        tuple(torch.from_numpy(bbox).to(cuda_device)), height, width, y0,
        cap)
    assert list(phases) == list(binning.PHASES)
    assert all(ms >= 0 for ms in phases.values())


@pytest.mark.cuda
def test_k5_graph_replays_match_plain_version(cuda_device):
    """K5 in a CUDA graph of two passes, replayed 30 times with its boxes
    rewritten: every replay equal to the plain version, the scratch left
    zeroed."""
    assert profiling.k5_graph_replays(cuda_device, replays=30) == 0


@pytest.mark.cuda
def test_k5_one_chain_a_pass(cuda_device):
    """The demo's frame is one raster pass: one K5 launch a frame, eagerly
    and as graph replays, one bin_tiles_ kernel in a replay's trace, and
    no pass bins with the plain version."""
    from myrenderer_tpu_torch.app.demo import DemoApp
    app = DemoApp(256, 192, device="cuda")
    app.tick()                            # the capture
    plain = binning.bin_tiles_reference
    calls = []
    binning.bin_tiles_reference = lambda *a: calls.append(a) or plain(*a)
    try:
        before = binning.K5.launches
        for _ in range(5):
            app.tick()
        assert binning.K5.launches == before + 5
        by_name = profiling.profile_frames(app, 3, "k5_one_launch")[3]
        kernels = {k: n for k, (_t, n) in by_name.items()
                   if "bin_tiles_" in k}
        assert sum(kernels.values()) == 3, kernels
        app.draw._eager_frames = True
        app.tick()
        assert binning.K5.launches == before + 9
    finally:
        binning.bin_tiles_reference = plain
    assert not calls
