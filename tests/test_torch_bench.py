"""``bench_torch.py``, the port's benchmark, on the CPU.

The overflow guard of ``bench.py`` (``tests/test_bench.py``'s five
cases) against ``bench_torch._guarded_row`` with a stub app that holds
torch flags and ``big_scale``; the smoke run in a subprocess, its last
line parsed; no card and no ``--device cpu``: a non-zero exit; no JAX
imported; the helpers the benchmark reads its numbers with; and
``BENCHMARK.json``'s cells. Whether a card is present is decided inside
each test, never at import."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _StubDraw:
    def __init__(self, big_scale=1, pending=(), last=None):
        self.big_scale = big_scale
        self._pending_overflow = list(pending)
        self.last_overflow = last


class _StubApp:
    """tick() is a no-op; the draw attrs are poked per test case."""

    def __init__(self, draw):
        self.draw = draw
        self.ticks = 0

    def tick(self):
        self.ticks += 1


FLAG_CLEAN = torch.zeros((2,), dtype=torch.bool)
FLAG_HIT = torch.tensor([False, True])


def _row(app, latency_frames=0):
    return bench_torch._guarded_row("m", app, frames=2, runs=2, triangles=7,
                                    latency_frames=latency_frames)


def test_clean_run_keeps_value_and_spread():
    app = _StubApp(_StubDraw(last=FLAG_CLEAN, pending=[FLAG_CLEAN]))
    row = _row(app, latency_frames=20)
    assert row["metric"] == "m" and row["value"] is not None
    assert "error" not in row
    assert len(row["runs_ms"]) == 2
    assert row["runs_ms"] == sorted(row["runs_ms"])
    assert {"median_ms", "max_ms", "mtri_per_sec", "frame_ms_p50",
            "frame_ms_p99"} <= row.keys()
    assert row["samples"] == 20 and app.ticks == 2 * 2 + 20
    # every frame of every run over the runs' total time
    assert row["value"] == pytest.approx(2e3 / sum(row["runs_ms"]))
    assert row["ms_per_frame"] == pytest.approx(1e3 / row["value"])


def test_final_frame_flag_nulls_value():
    app = _StubApp(_StubDraw(last=FLAG_HIT))
    row = _row(app)
    assert row["value"] is None and row["error"]


def test_queued_async_flag_nulls_value():
    """An overflow whose flag is still in the queue (not yet polled
    within the last OVERFLOW_WINDOW frames) must not read as clean."""
    app = _StubApp(_StubDraw(last=FLAG_CLEAN,
                             pending=[FLAG_CLEAN, FLAG_HIT]))
    row = _row(app)
    assert row["value"] is None and row["error"]


def test_midloop_capacity_bump_nulls_value():
    """A detected-and-repaired overflow leaves clean flags behind; the
    capacity ladder's scale before and after is the witness."""
    draw = _StubDraw(last=FLAG_CLEAN)

    class BumpingApp(_StubApp):
        def tick(self):
            super().tick()
            if self.ticks == 3:      # inside the guarded window
                self.draw.big_scale *= 4

    row = _row(BumpingApp(draw))
    assert row["value"] is None and row["error"]


def test_oracle_backend_without_flags_is_clean():
    """last_overflow=None (no raster plan yet) must not crash the
    guard."""
    app = _StubApp(_StubDraw(last=None))
    row = _row(app)
    assert row["value"] is not None and "error" not in row


def test_bump_during_single_frames_nulls_value():
    """The single-frame loop is inside the guarded window too."""
    class LateBump(_StubApp):
        def tick(self):
            super().tick()
            if self.ticks == 2 * 2 + 5:
                self.draw.big_scale *= 4

    row = _row(LateBump(_StubDraw(last=FLAG_CLEAN)), latency_frames=10)
    assert row["value"] is None and row["error"]


@pytest.mark.parametrize("n, q, want", [(1000, 0.99, 989), (1000, 0.5, 499),
                                        (20, 0.99, 19), (1, 0.99, 0)])
def test_nearest_rank(n, q, want):
    """p99 of 1,000 samples leaves 10 beyond it."""
    assert bench_torch._nearest_rank(list(range(n)), q) == want


def test_idle_gaps_name_the_host_op_and_span():
    """Gaps between merged device intervals, longest first, each with the
    innermost host op and span running at its middle."""
    device = [(0, 10), (5, 20), (40, 50), (110, 120)]
    host = [("frame (app.tick)", 0, 200), ("graph replay", 25, 35),
            ("cudaGraphLaunch", 26, 34), ("overflow flag poll", 55, 105),
            ("cudaEventQuery", 60, 90)]
    spans = {"frame (app.tick)", "graph replay", "overflow flag poll"}
    gaps = bench_torch._idle_gaps(device, host, spans, n=2)
    assert [g["ms"] for g in gaps] == [0.06, 0.02]
    assert gaps[0]["host_op"] == "cudaEventQuery"
    assert gaps[0]["span"] == "overflow flag poll"
    assert gaps[1]["host_op"] == "cudaGraphLaunch"
    assert gaps[1]["span"] == "graph replay"


def _sliver_set():
    """201 band slivers at 256x512, the last a degenerate one (two
    vertices on one point) whose edge tests pass pixel (151, 378), 140
    pixels from its box."""
    from myrenderer_tpu_torch.utils.trisets import band_slivers
    clip, vary = band_slivers(20000, 3, 256, 512, 0)
    keep = list(range(0, 20000, 100)) + [14987]
    return clip[keep], vary[keep]


def _reference(clip, vary, H, W, cull="none"):
    """``bench_torch.reference_frame`` over one batch of triangles in a
    cleared frame, shaded with their varyings."""
    import types

    from myrenderer_tpu_torch.ops import raster_common as rc
    b = types.SimpleNamespace(pipeline=types.SimpleNamespace(
        cull_mode=cull, fragment_fn=lambda v: v))
    plan = types.SimpleNamespace(height=H, width=W, surfaces=[[b]],
                                 clear_flags=[True])
    args = {"surfaces": [{"clear": torch.zeros(4)}]}
    tris = rc.Triangles(torch.from_numpy(clip), torch.from_numpy(vary))
    valid = torch.ones(clip.shape[0], dtype=torch.bool)
    return bench_torch.reference_frame(plan, args, [(0, b, (tris, valid),
                                                     None)], None, 0)


def test_oracle_on_the_tiles_equals_k1_plain_where_a_sliver_spills():
    """The reference's coverage rule (each triangle on the 16x16 tiles
    its box reaches) is the tile rasterizers' in both packages: on a
    degenerate sliver whose edge tests pass a pixel 140 pixels from its
    box, the JAX package's tile pass (its own setup, Pallas in interpret
    mode, 8x128 tiles), the port's K1 plain version and the reference
    give the same winners, while the JAX and the port's full-frame
    oracles both give that pixel to the sliver."""
    import jax
    import jax.numpy as jnp
    from myrenderer_tpu.ops import raster_common as jrc
    from myrenderer_tpu.ops import raster_ref as jrr
    from myrenderer_tpu_torch.ops import raster
    from myrenderer_tpu_torch.ops import raster_common as rc
    from myrenderer_tpu_torch.ops import raster_cuda as rk
    from myrenderer_tpu_torch.utils.profiling import (oracle_frame, trimmed,
                                                      unpack_records)
    from test_torch_raster import jax_rasterize_packed
    from test_torch_raster_common import jax_setup_batch
    H, W = 256, 512
    clip, vary = _sliver_set()
    ones = np.ones(clip.shape[0], bool)
    tc = rc.triangle_setup(torch.from_numpy(clip), torch.from_numpy(vary),
                           torch.from_numpy(ones), W, H, "none")
    packed = rc.pack_coeffs_full(tc)
    bbox = raster.viewport_bbox(torch.from_numpy(clip), W, H)
    index, starts, counts, overflow = raster.bin_packed(packed, tc.valid,
                                                        bbox, H, W)
    assert not bool(overflow)
    _, winner = rk.rasterize_tiles_reference(
        *trimmed((packed, index, starts, counts, torch.ones((H, W)))))
    whole = oracle_frame(packed, bbox, H, W, 1.0)[3]
    ref = _reference(clip, vary, H, W)
    jpacked, jvalid, jbox = jax_setup_batch(clip, vary, ones, W, H, "none")
    _jd, jwin, *_ = jax_rasterize_packed(
        jpacked, jvalid, tuple(jbox), height=H, width=W,
        depth=jnp.ones((H, W), jnp.float32))
    # the JAX oracle over the same records (id order is array order here)
    tc_ids = unpack_records(packed)[0]
    jtc = jrc.TriCoeffs(**{k: jnp.asarray(v.numpy())
                           for k, v in tc_ids._asdict().items()})
    _jd, jwhole = jax.jit(jrr.rasterize_visibility,
                          static_argnums=(1, 2))(jtc, H, W)
    assert int((winner >= 0).sum()) > 1000
    np.testing.assert_array_equal(np.asarray(jwin), winner.numpy())
    assert torch.equal(ref[1], winner)
    sliver = clip.shape[0] - 1
    assert (winner != whole).nonzero().tolist() == [[151, 378]]
    assert int(whole[151, 378]) == int(packed[-1, 16]) == sliver
    # the JAX oracle evaluates every pixel: the sliver spills at two
    # (the port's oracle windows its chunks by the boxes and sees one)
    jwhole = np.asarray(jwhole)
    spills = np.argwhere(jwhole != winner.numpy()).tolist()
    assert spills == [[151, 378], [252, 289]]
    assert all(jwhole[y, x] == sliver for y, x in spills)
    assert float(bbox[0][-1]) > 500.0 and float(bbox[3][-1]) < 9.0


@pytest.mark.parametrize("lanes, shift", [
    ((20, 32), "ulp"),           # the varying planes
    ((9, 12), "ulp"),            # the depth numerator plane
    ((2, 3), "half pixel"),      # edge 0's constant
])
def test_reference_check_fails_on_wrong_records(monkeypatch, lanes, shift):
    """A setup or pack that writes wrong records agrees with itself,
    graph against eager, but not with the reference: check (b) raises."""
    from myrenderer_tpu_torch.ops import setup_pack as sp
    orig = sp.setup_pack_pass

    def wrong(segments):
        # each batch's and appendee block's rows of the pass's table,
        # edited in place once the pass has written them
        segments = list(segments)
        orig(segments)
        lo, hi = lanes
        for s in segments:
            packed = s.table.packed[s.row0:s.row0 + s.tri_clip.shape[0]]
            part = packed[:, lo:hi]
            if shift == "ulp":
                part.copy_(torch.nextafter(part,
                                           torch.full_like(part, np.inf)))
            else:
                part += 0.5 * packed[:, 0:1].abs()

    monkeypatch.setattr(sp, "setup_pack_pass", wrong)
    cell = bench_torch._smoke_cell("cpu")
    with pytest.raises(AssertionError, match="differs from the reference"):
        bench_torch._checks(cell, "cpu", 0, {})


@pytest.mark.parametrize("seed", [0, 361])
def test_smoke_run_on_the_cpu(seed):
    """``--smoke --device cpu``: the demo at 64x64 through the checks and
    the timed loops; the last line is the result, its row correct and
    free of device metrics. Seed 361 first turns the orbit one frame."""
    out = subprocess.run(
        [sys.executable, "bench_torch.py", "--smoke", "--device", "cpu",
         "--seed", str(seed)], cwd=REPO,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    row = json.loads(lines[-1])
    assert row["metric"] == "demo_64x64_fps"
    assert row["value"] > 0 and row["correct"] is True
    assert len(row["runs_ms"]) == 2 and row["samples"] == 20
    assert row["frame_ms_p99"] >= row["frame_ms_p50"] > 0
    assert row["device"] == "cpu" and row["card"] is None
    ref = row["checks"]["reference"]
    assert ref["winner_diffs"] == ref["fb_bit_diffs"] == 0
    assert ref["plane_bit_diffs"] == 0 and ref["covered"] > 1000
    assert row["checks"]["orbit_frames"] == seed % 360
    assert row["vs_baseline"] > 0 and row["baseline"]["fps"] > 0
    for key in ("device_busy_ms", "k1_ms", "k1_bound_share",
                "peak_mem_mib", "capture_s"):
        assert key not in row
    # the frame after the timed loops, checked against an eager twin
    assert 0 < row["pairs"] <= row["pair_slots"]
    assert row["pair_slot_occupancy"] == row["pairs"] / row["pair_slots"]
    assert "(a) frames 1-3" in out.stdout and "(b) frame 3" in out.stdout
    assert "0 winner diffs" in out.stdout


def test_no_card_exits_nonzero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_torch.main([]) != 0
    assert bench_torch.main(["--smoke"]) != 0
    captured = capsys.readouterr()
    assert "CUDA is not available" in captured.err
    assert captured.out == ""


def test_cpu_needs_smoke(capsys):
    assert bench_torch.main(["--device", "cpu"]) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("module", ["bench_torch", "chip_smoke"])
def test_import_leaves_no_jax(module):
    """Neither script imports JAX, the JAX package, ``bench`` or the
    other script."""
    other = {"bench_torch": "chip_smoke", "chip_smoke": "bench_torch"}[module]
    code = (f"import sys, {module}; "
            "bad = sorted(m for m in sys.modules if m in ('jax', 'bench', "
            f"'myrenderer_tpu', {other!r}) or m.startswith(('jax.', "
            "'myrenderer_tpu.'))); print(bad); sys.exit(bool(bad))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_benchmark_json_names_the_two_cells():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    assert set(cells) == set(bench_torch.CELLS) == {"demo_1080p",
                                                    "stress_4k_1m"}
    for name, w in cells.items():
        assert w["chips"] == 1
        assert w["traffic"]["single_frames"] == bench_torch.CELLS[name].single
        assert w["row"] == bench_torch.CELLS[name].metric
        assert len(w["source"]) <= 200
        cell = bench_torch.CELLS[name]
        assert (w["traffic"]["frames"], w["traffic"]["runs"]) == (
            cell.frames, cell.runs)
    metrics = {m["name"]: m for m in bench["metrics"]}
    assert set(metrics) == {"fps", "frame_ms_p99"}
    for name, floor in (("fps", 3.0), ("frame_ms_p99", 5.0)):
        by_cell = metrics[name]["bound_pct_by_cell"]
        assert set(by_cell) == set(cells)
        assert min(by_cell.values()) >= floor
        assert metrics[name]["bound_pct"] == max(by_cell.values())
    assert metrics["frame_ms_p99"]["samples"] == bench_torch.LATENCY_FRAMES
    for m in bench["layer_metrics"] + bench["setup_metrics"]:
        assert set(m["cells"]) <= set(cells)
