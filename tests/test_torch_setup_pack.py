"""K2, clip + setup + pack (``ops/setup_pack.py``), and the record table a
raster pass now reads (``draw._merged_pass``).

On the CPU ``setup_pack_into`` runs K2's plain version; these tests hold
it, and the frame built on it, to the code it replaced: each batch's
``triangle_setup`` + ``pack_coeffs_full`` + ``viewport_bbox`` and the
``torch.cat`` of batch, appendee block and batches, bit for bit in every
lane. A raster pass's segments go to one ``setup_pack_pass``, which
equals one ``setup_pack_into`` a segment. The card's tests hold K2's one
launch a pass to its plain version."""

import re

import numpy as np
import pytest
import torch

from myrenderer_tpu_torch.app.demo import DemoApp
from myrenderer_tpu_torch.app.stress import StressApp
from myrenderer_tpu_torch.ops import raster
from myrenderer_tpu_torch.ops import raster_common as rc
from myrenderer_tpu_torch.ops import setup_pack as sp
from myrenderer_tpu_torch.parallel import make_mesh
from myrenderer_tpu_torch.renderer import draw
from myrenderer_tpu_torch.utils.scenes import SCRIPTED
from myrenderer_tpu_torch.utils.trisets import setup_batch

CAP = draw.CLIP_CAPACITY
W, H = 160, 48


def parent_setup_batch(plan, tris, valid, cull_mode, z_bias=None,
                       base_index=0, cap=CAP):
    """``draw._setup_batch`` as it was before K2: two setups, two packs,
    two boxes, concatenated."""
    W, H = plan.width, plan.height
    app_clip, app_vary, app_valid, _sel, overflow = rc.select_straddlers(
        tris.clip, tris.vary, valid, cap)
    T = tris.clip.shape[0]
    tc = rc.triangle_setup(tris.clip, tris.vary, valid, W, H, cull_mode,
                           z_bias=z_bias, planar=tris.planar)
    tc_app = rc.triangle_setup(app_clip, app_vary, app_valid, W, H,
                               cull_mode, z_bias=z_bias)
    packed = torch.cat([
        rc.pack_coeffs_full(tc, base=base_index, ids=tris.ids),
        rc.pack_coeffs_full(tc_app, base=base_index + T)])
    bbox = tuple(torch.cat(c) for c in zip(
        raster.viewport_bbox(tris.clip, W, H),
        raster.viewport_bbox(app_clip, W, H)))
    return packed, torch.cat([tc.valid, tc_app.valid]), bbox, overflow


def parent_merged_pass(plan, args, products, layout, fb, cap, flags, setup):
    """``draw._merged_pass`` as it was before K2 (one device): every
    batch set up by :func:`parent_setup_batch`, then the batches
    concatenated into the pass's records."""
    if plan.clear_flags and plan.clear_flags[0]:
        fb = draw._band_clear(plan, layout, args["surfaces"][0]["clear"])
    if not products:
        return fb, None
    S = len(plan.surfaces)
    packs, valids, bboxes, ranges = [], [], [], []
    for (s_i, b, data, fctx), (bias, base) in zip(
            products, draw._batch_ids(plan, cap)):
        packed, v, bbox, ovf = parent_setup_batch(
            plan, *data, b.pipeline.cull_mode, z_bias=bias, base_index=base,
            cap=cap)
        flags["clip"].append(ovf)
        packs.append(packed)
        valids.append(v)
        bboxes.append(bbox)
        end = base + packed.shape[0]
        fn = b.pipeline.fragment_fn
        if (fctx is None and ranges and ranges[-1][2] is fn
                and ranges[-1][3] is None and ranges[-1][1] == base):
            ranges[-1] = (ranges[-1][0], end, fn, None)
        else:
            ranges.append((base, end, fn, fctx))
    depth = draw._band_fill(plan, layout, 2.0 * (S - 1) + 1.0)
    _depth, fb, winner = draw._raster_pass(
        plan, layout, torch.cat(packs), torch.cat(valids),
        tuple(torch.cat(cs) for cs in zip(*bboxes)), depth, fb, ranges,
        flags)
    return fb, winner


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32) if t.is_floating_point() else t


def assert_same(a, b, what: str):
    assert a.shape == b.shape, (what, a.shape, b.shape)
    bad = bits(a) != bits(b)
    assert not bool(bad.any()), (f"{what}: {int(bad.sum())} values differ, "
                                 f"first at {bad.nonzero()[:3].tolist()}")


def make_tris(T, seed, planar, with_ids):
    clip, vary, valid, ids = setup_batch(T, seed)
    return (rc.Triangles(torch.from_numpy(clip), torch.from_numpy(vary),
                         torch.from_numpy(ids) if with_ids else None,
                         planar), torch.from_numpy(valid))


def _table(rows):
    """A CPU table whose every row holds a sentinel."""
    return sp.RecordTable(torch.full((rows, rc.FULL_LANES), -7.0),
                          torch.ones(rows, dtype=torch.bool),
                          torch.full((4, rows), -7.0))


def _assert_only_rows_written(table, before, lo, hi):
    outside = torch.ones(table.valid.shape[0], dtype=torch.bool)
    outside[lo:hi] = False
    assert_same(table.packed[outside], before.packed[outside], "other rows")
    assert_same(table.valid[outside], before.valid[outside], "other flags")
    assert_same(table.bbox[:, outside], before.bbox[:, outside],
                "other boxes")


@pytest.mark.parametrize("T", [0, 5, 300])
@pytest.mark.parametrize("with_ids", [False, True])
@pytest.mark.parametrize("z_bias", [None, 0.0, 2.0])
@pytest.mark.parametrize("planar", [False, True])
@pytest.mark.parametrize("cull_mode", ["back", "front", "none"])
def test_setup_pack_into_the_table_equals_the_cat_built_records(
        cull_mode, planar, z_bias, with_ids, T):
    """The dispatching function on CPU tensors, into rows [37, 37 + T) of
    a larger table, against ``triangle_setup`` + ``pack_coeffs_full`` +
    ``viewport_bbox``; then (T > 0) a whole batch's segments
    (``_batch_segments``: its records, then its appendee block, from row
    1000, its first id) written by one ``setup_pack_pass``
    against the cat-built setup it replaced. Every lane, valid flag and box bit for bit, the clip flag
    equal, and no row outside written. The batches
    (``trisets.setup_batch``) hold both windings, straddlers, w at and
    around W_EPS, zero-area and collinear triangles, subnormal, huge and
    non-finite coordinates; T = 0 and T < cap included."""
    tris, valid = make_tris(T, 11 + T, planar, with_ids)
    row0 = 37
    table = _table(row0 + T + 2 * CAP + 9)
    before = sp.RecordTable(*(t.clone() for t in table))
    sp.setup_pack_into(table, row0, tris.clip, tris.vary, valid, W, H,
                       cull_mode, z_bias, planar, 1000, tris.ids)
    tc = rc.triangle_setup(tris.clip, tris.vary, valid, W, H, cull_mode,
                           z_bias=z_bias, planar=planar)
    rows = slice(row0, row0 + T)
    assert_same(table.packed[rows],
                rc.pack_coeffs_full(tc, base=1000, ids=tris.ids), "records")
    assert_same(table.valid[rows], tc.valid, "valid")
    for k, box in enumerate(raster.viewport_bbox(tris.clip, W, H)):
        assert_same(table.bbox[k, rows], box, f"box {k}")
    _assert_only_rows_written(table, before, row0, row0 + T)
    if T == 0:
        return
    plan = type("Plan", (), {"width": W, "height": H})()
    want = parent_setup_batch(plan, tris, valid, cull_mode, z_bias=z_bias,
                              base_index=1000)
    # a batch's rows start at its first id
    row0 = 1000
    table = _table(row0 + T + 2 * CAP + 9)
    before = sp.RecordTable(*(t.clone() for t in table))
    segments, ovf = draw._batch_segments(plan, tris, valid, cull_mode,
                                         table, z_bias=z_bias,
                                         base_index=1000)
    sp.setup_pack_pass(segments)
    got = (*table.rows(row0, row0 + T + 2 * CAP), ovf)
    assert_same(got[0], want[0], "batch records")
    assert_same(got[1], want[1], "batch valid")
    for k in range(4):
        assert_same(got[2][k], want[2][k], f"batch box {k}")
    assert bool(got[3]) == bool(want[3])
    # the results are views of the table's rows
    assert got[0].data_ptr() == table.packed[row0].data_ptr()
    _assert_only_rows_written(table, before, row0, row0 + T + 2 * CAP)
    if T == 300:
        assert 0 < int(got[1][:T].sum()) < T
        assert int(got[1][T:].sum()) > 0


def _capture_tables(store):
    orig = raster.rasterize_bands

    def bands(packed, valid, bbox, *a, **kw):
        store.append((packed.clone(), valid.clone(),
                      tuple(c.clone() for c in bbox)))
        return orig(packed, valid, bbox, *a, **kw)
    return bands


def _scene(name):
    if name == "demo":
        app = DemoApp(64, 64, device="cpu")
        return app, app.tick, app.draw
    if name == "stress":
        app = StressApp(96, 96, 48, 16, device="cpu")
        return app, app.tick, app.draw
    scene = SCRIPTED["straddler"]("cpu", "auto")
    frames = iter(range(100))
    return scene, lambda: scene.step(next(frames)), scene.draw


@pytest.mark.parametrize("name", ["demo", "stress", "straddler"])
def test_merged_pass_table_and_frames_equal_the_cat_built_pass(
        monkeypatch, name):
    """The 64x64 demo, the small stress scene (terrain with its permuted
    ids, instanced markers) and the scripted eye-plane straddler scene,
    3 frames each: the one table a pass now writes equals the
    concatenated records of the cat-built pass, lane for lane, and the
    framebuffers and winners equal bit for bit."""
    runs = {}
    for parent in (True, False):
        tables, frames = [], []
        with monkeypatch.context() as m:
            m.setattr(raster, "rasterize_bands", _capture_tables(tables))
            if parent:
                m.setattr(draw, "_merged_pass", parent_merged_pass)
            app, tick, drw = _scene(name)
            app.renderer.debug_winner = True
            for _ in range(3):
                tick()
                frames.append((app.window.framebuffer.clone(),
                               [w.clone() for w in drw.last_winners]))
        runs[parent] = (tables, frames)
    (t_old, f_old), (t_new, f_new) = runs[True], runs[False]
    assert len(t_old) == len(t_new) == 3
    for (p0, v0, b0), (p1, v1, b1) in zip(t_old, t_new):
        assert_same(p1, p0, "records")
        assert_same(v1, v0, "valid")
        for k in range(4):
            assert_same(b1[k], b0[k], f"box {k}")
    for (fb0, w0), (fb1, w1) in zip(f_old, f_new):
        assert_same(fb1, fb0, "framebuffer")
        assert len(w0) == len(w1) == 1
        assert_same(w1[0], w0[0], "winners")
    assert int((f_new[-1][1][0] >= 0).sum()) > 0
    if name == "straddler":
        # the scene's straddlers reach the appendee block
        assert bool(t_new[0][1][-2 * CAP:].any())


def strided(clip, vary):
    """The same batch through strided views: varyings stored
    channel-major, clip positions inside a wider array."""
    vary = vary.transpose(1, 2).contiguous().transpose(1, 2)
    wide = torch.zeros((clip.shape[0], 3, 8), device=clip.device)
    wide[..., 2:6] = clip
    return wide[..., 2:6], vary


PASS_CASES = {
    # segments, of them empty (every other), tables
    "mixed": (7, False, 1),
    "empty": (7, True, 1),
    "two_tables": (7, False, 2),
    "many": (sp.MAX_SEGMENTS + 7, False, 1),
}


def pass_segments(case, seed, tables, device="cpu"):
    """A pass's segments over ``tables`` (:data:`PASS_CASES`) on
    ``device``: cull modes, planar and biased forms, ids and none, strided
    views, sizes that are no multiple of a 64-triangle chunk, made from
    ``seed``; rows taken one after another from row 3, ids from 1000 +
    the row. Returns (segments, rows taken)."""
    count, empty, _n = PASS_CASES[case]
    sizes = np.random.default_rng(seed).integers(1, 300, count)
    if empty:
        sizes[::2] = 0
    segments, row = [], 3
    for i, T in enumerate(int(t) for t in sizes):
        planar, with_ids = bool(i % 2), i % 4 >= 2
        tris, valid = make_tris(T, seed * 100 + i, planar, with_ids)
        clip, vary, valid = (t.to(device) for t in (tris.clip, tris.vary,
                                                     valid))
        ids = None if tris.ids is None else tris.ids.to(device)
        if i % 3 == 1:
            clip, vary = strided(clip, vary)
        segments.append(sp.Segment(
            tables[i % len(tables)], row, clip, vary, valid, W, H,
            ("back", "front", "none")[i % 3], (None, 0.0, 2.0)[i // 2 % 3],
            planar, 1000 + row, ids))
        row += T
    return segments, row


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("case", list(PASS_CASES))
def test_setup_pack_pass_equals_setup_pack_into_per_segment(case, seed):
    """A pass's segments written by one :func:`sp.setup_pack_pass` equal
    the same segments written one :func:`sp.setup_pack_into` each, bit
    for bit in every lane, flag and box of every table, rows outside the
    segments untouched; the launches a card would make
    (:func:`sp.launch_groups`): one, two past MAX_SEGMENTS segments, and
    no empty segment in any."""
    n_tables = PASS_CASES[case][2]
    _segs, rows = pass_segments(case, seed, [None] * n_tables)
    got = [_table(rows + 9) for _ in range(n_tables)]
    want = [_table(rows + 9) for _ in range(n_tables)]
    before = _table(rows + 9)
    segments, _rows = pass_segments(case, seed, got)
    sp.setup_pack_pass(segments)
    for s in pass_segments(case, seed, want)[0]:
        sp.setup_pack_into(*s)
    for g, w in zip(got, want):
        for a, b, what in zip(g, w, ("records", "valid", "boxes")):
            assert_same(a, b, what)
    for t in got:
        written = torch.zeros(rows + 9, dtype=torch.bool)
        for s in segments:
            if s.table is t:
                written[s.row0:s.row0 + s.tri_clip.shape[0]] = True
        assert bool(written.any())
        assert_same(t.packed[~written], before.packed[~written], "rest")
        assert_same(t.valid[~written], before.valid[~written], "rest")
        assert_same(t.bbox[:, ~written], before.bbox[:, ~written], "rest")
    groups = sp.launch_groups(segments)
    assert len(groups) == (2 if case == "many" else 1)
    assert all(s.tri_clip.shape[0] for grp in groups for s in grp)


@pytest.mark.parametrize("sizes", [[], [0, 0], [5], [0, 0, 0] + [7] * 24,
                                   [1] * 25, [3, 0] * 30])
def test_launch_groups_take_the_segments_with_triangles_in_order(sizes):
    segments = [sp.Segment(None, i, torch.zeros((T, 3, 4)), None, None, W,
                           H) for i, T in enumerate(sizes)]
    groups = sp.launch_groups(segments)
    live = [s.row0 for s in segments if s.tri_clip.shape[0]]
    assert [s.row0 for g in groups for s in g] == live
    assert all(0 < len(g) <= sp.MAX_SEGMENTS for g in groups)
    assert len(groups) == -(-len(live) // sp.MAX_SEGMENTS)


def test_the_wrapper_and_the_source_agree_on_a_launch():
    """The segment's fields in the source's order, the segments a launch
    takes and the mode bits are the wrapper's (the card checks the
    segment's size when it loads the library)."""
    with open(sp._SOURCE) as f:
        src = f.read()
    body = re.sub(r"//[^\n]*", "", re.search(r"struct Segment \{(.*?)\};",
                                             src, re.S).group(1))
    names = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        first, *rest = decl.split(",")
        names += [re.match(r"\**(\w+)", tok.split()[-1]).group(1)
                  for tok in [first] + rest]
    assert names == [name for name, _t in sp._SegmentArgs._fields_]
    consts = dict(re.findall(r"constexpr int (k\w+) = ([^;]+);", src))
    assert int(consts["kMaxSegments"]) == sp.MAX_SEGMENTS
    assert eval(consts["kFormsShift"]) == sp._FORMS_SHIFT
    assert eval(consts["kBiased"]) == sp._BIASED
    assert eval(consts["kStageClip"]) == sp._STAGE_CLIP
    assert eval(consts["kStageVary"]) == sp._STAGE_VARY


def _frame_passes(name):
    """(app or scene, tick, expected K2 passes of one frame as lists of
    segment sizes) for the path ``name``."""
    if name == "demo":
        app = DemoApp(64, 64, device="cpu")
        return app.tick, [[20000, 2 * CAP, 7, 2 * CAP]]
    if name == "mesh":
        app = DemoApp(64, 64, device="cpu",
                      mesh=make_mesh(devices=["cpu"] * 8))
        shards = [2500] * 8 + [1] * 7 + [0]
        # the shards' stage on the one distinct device, then the pass's
        # appendee blocks
        return app.tick, [shards, [2 * CAP, 2 * CAP]]
    scene = SCRIPTED["sequential"]("cpu", "auto")
    return (lambda: scene.step(0)), [[1, 2 * CAP]] * 3


@pytest.mark.parametrize("name", ["demo", "mesh", "sequential"])
def test_a_raster_pass_sets_up_in_one_k2_pass(monkeypatch, name):
    """Every segment of a raster pass goes to one ``setup_pack_pass``,
    after every batch's straddler selection, and a card launches K2 once
    for it: the merged demo frame's two batches and their appendee
    blocks in one pass; on a mesh the shards' stage of a device in one and
    each raster pass's appendee blocks in one; one a sequential pass."""
    calls, order = [], []
    orig_pass, orig_select = sp.setup_pack_pass, rc.select_straddlers

    def setup_pack_pass(segments):
        segments = list(segments)
        calls.append([s.tri_clip.shape[0] for s in segments])
        order.append("K2")
        assert len(sp.launch_groups(segments)) == 1
        return orig_pass(segments)

    def select_straddlers(*a, **kw):
        order.append("K4")
        return orig_select(*a, **kw)

    monkeypatch.setattr(sp, "setup_pack_pass", setup_pack_pass)
    monkeypatch.setattr(rc, "select_straddlers", select_straddlers)
    tick, want = _frame_passes(name)
    calls.clear()
    order.clear()
    tick()
    assert calls == want
    if name == "demo":
        assert order == ["K4", "K4", "K2"]
    if name == "sequential":
        assert order == ["K4", "K2"] * 3


def test_plane_form_bits_follow_the_setup_forms():
    """K2's mask holds ``_plane_forms``' 9 forms for every cull mode,
    layout and bias (setup's, not the oracle's)."""
    for cull in ("back", "front", "none"):
        for planar in (False, True):
            for biased in (False, True):
                mask = sp.plane_form_bits(cull, planar, biased)
                forms = rc._plane_forms(cull, planar, biased)
                assert [[(mask >> (3 * p + c)) & 1 for c in range(3)]
                        for p in range(3)] == [list(f) for f in forms]


def test_cpu_runs_the_plain_version_and_counts_no_launch():
    before = sp.K2.launches
    tris, valid = make_tris(20, 3, False, False)
    table = sp.new_table(20, "cpu")
    sp.setup_pack_into(table, 0, tris.clip, tris.vary, valid, W, H)
    ref = sp.new_table(20, "cpu")
    sp.setup_pack_reference(ref, 0, tris.clip, tris.vary, valid, W, H)
    assert sp.K2.launches == before
    for a, b in zip(table, ref):
        assert_same(a, b, "table")


def test_setup_pack_into_checks_its_inputs():
    """Types, shapes, devices, the cull mode and the rows are checked
    before anything is written; off the CPU nothing reaches the plain
    version."""
    tris, valid = make_tris(6, 4, False, True)
    table = sp.new_table(10, "cpu")
    args = (tris.clip, tris.vary, valid, W, H)
    with pytest.raises(TypeError, match="tri_clip"):
        sp.setup_pack_into(table, 0, tris.clip.double(), *args[1:])
    with pytest.raises(TypeError, match="ids"):
        sp.setup_pack_into(table, 0, *args, ids=tris.ids.long())
    with pytest.raises(ValueError, match="tri_vary"):
        sp.setup_pack_into(table, 0, tris.clip, tris.vary[..., :3], valid,
                           W, H)
    with pytest.raises(ValueError, match="not inside"):
        sp.setup_pack_into(table, 5, *args)
    with pytest.raises(ValueError, match="cull_mode"):
        sp.setup_pack_into(table, 0, *args, cull_mode="sideways")
    with pytest.raises(ValueError, match="is on"):
        sp.setup_pack_into(sp.new_table(10, "meta"), 0, *args)
    with pytest.raises(ValueError, match="cuda or cpu"):
        sp.setup_pack_into(sp.new_table(10, "meta"), 0,
                           *(t.to("meta") for t in args[:3]), W, H)


def test_k2_wrapper_raises_instead_of_falling_back():
    """Without the CUDA toolkit K2 cannot be built: its wrapper raises
    and counts nothing."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is not None:
        pytest.skip("the CUDA toolkit is present")
    kernel = sp.SetupPackKernel()
    tris, valid = make_tris(6, 4, False, False)
    with pytest.raises(RuntimeError, match="CUDA toolkit"):
        kernel([sp.Segment(sp.new_table(6, "cpu"), 0, tris.clip, tris.vary,
                           valid, W, H)])
    assert kernel.launches == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cull_mode", ["back", "front", "none"])
def test_k2_matches_plain_version_on_card(cuda_device, cull_mode):
    """K2 against its plain version on the card, every planar / bias /
    ids combination of a cull mode, from row 37 of a larger table: every
    lane, flag and box bit for bit (NaN against NaN), one launch each."""
    for planar in (False, True):
        for z_bias in (None, 0.0, 2.0):
            for with_ids in (False, True):
                tris, valid = make_tris(4000, 5, planar, with_ids)
                args = [t.to(cuda_device) for t in (tris.clip, tris.vary,
                                                     valid)]
                ids = None if tris.ids is None else tris.ids.to(cuda_device)
                tables = [sp.RecordTable(
                    torch.zeros((4100, rc.FULL_LANES), device=cuda_device),
                    torch.zeros(4100, dtype=torch.bool, device=cuda_device),
                    torch.zeros((4, 4100), device=cuda_device))
                    for _ in range(2)]
                before = sp.K2.launches
                sp.setup_pack_into(tables[0], 37, *args, W, H, cull_mode,
                                   z_bias, planar, 500, ids)
                assert sp.K2.launches == before + 1
                sp.setup_pack_reference(tables[1], 37, *args, W, H,
                                        cull_mode, z_bias, planar, 500, ids)
                torch.cuda.synchronize()
                for a, b in zip(*tables):
                    same = (bits(a) == bits(b)) | (
                        torch.isnan(a) & torch.isnan(b)
                        if a.is_floating_point() else False)
                    assert bool(same.all()), (planar, z_bias, with_ids)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(PASS_CASES))
def test_k2_pass_matches_plain_version_on_card(cuda_device, case):
    """A pass's segments (:data:`PASS_CASES`: strided views, empty
    segments, two tables, more segments than a launch takes) through
    ``setup_pack_pass`` (one launch; two past MAX_SEGMENTS), against the
    plain version: every lane, flag and box bit for bit (NaN against
    NaN)."""
    from myrenderer_tpu_torch.utils import profiling
    n_tables = PASS_CASES[case][2]
    rows = pass_segments(case, 4, [None] * n_tables)[1]
    tables = [sp.new_table(rows + 5, cuda_device) for _ in range(n_tables)]
    segments = pass_segments(case, 4, tables, cuda_device)[0]
    want = 2 if case == "many" else 1
    before = sp.K2.launches
    sp.setup_pack_pass(segments)
    assert sp.K2.launches == before + want
    bad, _err, launches = profiling.k2_pass_against_plain(segments)
    assert (bad, launches) == (0, want)


@pytest.mark.cuda
def test_k2_graph_replays_match_plain_version(cuda_device):
    """Two K2 passes in one CUDA graph (a merged pass into one table, a
    pass into two), replayed 30 times with every input rewritten in place:
    each replay bit-equal to the plain version."""
    from myrenderer_tpu_torch.utils import profiling
    assert profiling.k2_graph_replays(cuda_device, replays=30) == 0
