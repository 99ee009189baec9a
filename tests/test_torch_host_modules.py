"""Host-module parity: the cases of ``tests/test_math3d.py``,
``tests/test_triangulation.py`` and ``tests/test_native.py`` (the native
triangulator and the PNG codec, round trips included) run through both
``myrenderer_tpu`` and ``myrenderer_tpu_torch``. Each case is
parametrised over the two packages: it checks its property in the
package under test and requires its outputs to equal the other
package's exactly."""

import importlib
import io
import math
import os
import subprocess
import tempfile

import numpy as np
import pytest

from test_triangulation import (HEPTAGON, SQUARE, random_simple_polygons,
                                shoelace)

PACKAGES = ("myrenderer_tpu", "myrenderer_tpu_torch")


def module(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def other(pkg: str) -> str:
    return PACKAGES[1 - PACKAGES.index(pkg)]


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return request.param


def assert_same(fn, pkg):
    """fn(package name) in ``pkg`` and in the other package: exactly
    equal (arrays by value and dtype). Returns ``pkg``'s result."""
    mine, theirs = fn(pkg), fn(other(pkg))
    if isinstance(mine, (list, tuple)) and mine and isinstance(
            mine[0], np.ndarray):
        assert len(mine) == len(theirs)
        for a, b in zip(mine, theirs):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    elif isinstance(mine, np.ndarray):
        assert mine.dtype == theirs.dtype
        np.testing.assert_array_equal(mine, theirs)
    else:
        assert mine == theirs
    return mine


# --------------------------------------------------------------------------
# math3d (tests/test_math3d.py)
# --------------------------------------------------------------------------

def m3(pkg):
    return module(pkg, "math3d")


def test_identity(pkg):
    m = assert_same(lambda p: m3(p).identity(), pkg)
    np.testing.assert_array_equal(m, np.eye(4, dtype=np.float32))


def test_look_at_matches_reference_construction(pkg):
    cam = np.array([10.0, 6.0, 0.0], np.float32)
    tgt = np.zeros(3, np.float32)
    up = np.array([0.0, 1.0, 0.0], np.float32)
    m = assert_same(lambda p: m3(p).look_at(cam, tgt, up), pkg)
    fwd = (tgt - cam) / np.linalg.norm(tgt - cam)
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    up2 = np.cross(fwd, right)
    up2 /= np.linalg.norm(up2)
    np.testing.assert_allclose(m[0, :3], right, rtol=1e-6)
    np.testing.assert_allclose(m[1, :3], up2, rtol=1e-6)
    np.testing.assert_allclose(m[2, :3], fwd, rtol=1e-6)
    np.testing.assert_allclose(m[3], [0, 0, 0, 1], rtol=0)
    v = assert_same(lambda p: m3(p).mul_vec(m, cam), pkg)
    np.testing.assert_allclose(v[:3], 0.0, atol=1e-5)
    v = assert_same(lambda p: m3(p).mul_vec(m, tgt), pkg)
    assert v[2] > 0
    np.testing.assert_allclose(v[:2], 0.0, atol=1e-5)


def test_look_at_orthonormal(pkg):
    m = assert_same(lambda p: m3(p).look_at([3.0, -2.0, 7.0],
                                            [1.0, 1.0, 1.0],
                                            [0.0, 1.0, 0.0]), pkg)
    r = m[:3, :3]
    np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-5)


def test_perspective_formula(pkg):
    fovy, aspect, near, far = 90.0, 1.0, 0.1, 200.0
    m = assert_same(lambda p: m3(p).perspective(fovy, aspect, near, far),
                    pkg)
    halftan = math.tan(fovy / 2.0)
    assert m[0, 0] == pytest.approx(1.0 / (aspect * halftan))
    assert m[1, 1] == pytest.approx(1.0 / halftan)
    assert m[2, 2] == pytest.approx(far / (far - near))
    assert m[2, 3] == pytest.approx(-far * near / (far - near))
    assert m[3, 2] == 1.0
    assert m[3, 3] == 0.0


def test_perspective_depth_range(pkg):
    m = assert_same(lambda p: m3(p).perspective(1.2, 1.5, 0.5, 100.0), pkg)
    for z, expect in [(0.5, 0.0), (100.0, 1.0)]:
        v = assert_same(lambda p: m3(p).mul_vec(m, [0.0, 0.0, z]), pkg)
        assert v[3] == pytest.approx(z)
        assert v[2] / v[3] == pytest.approx(expect, abs=1e-6)


def test_projection_2d_demo_bounds(pkg):
    m = assert_same(lambda p: m3(p).projection_2d(
        left=0.0, right=200.0, bottom=200.0, top=0.0, near=0.1, far=200.0),
        pkg)
    v = assert_same(lambda p: m3(p).mul_vec(m, [0.0, 0.0, 0.1]), pkg)
    np.testing.assert_allclose(v, [-1.0, 1.0, 0.0, 1.0], atol=1e-6)
    v = assert_same(lambda p: m3(p).mul_vec(m, [200.0, 200.0, 200.0]), pkg)
    np.testing.assert_allclose(v, [1.0, -1.0, 1.0, 1.0], atol=1e-6)
    z = assert_same(lambda p: m3(p).mul_vec(m, [50.0, 50.0, 1.0]), pkg)[2]
    assert 0.0 < z < 1.0


def test_mat_mult_fold(pkg):
    a = assert_same(lambda p: m3(p).translate([1.0, 2.0, 3.0]), pkg)
    b = assert_same(lambda p: m3(p).scale([2.0, 2.0, 2.0]), pkg)
    np.testing.assert_allclose(
        assert_same(lambda p: m3(p).mat_mult([a, b]), pkg), a @ b,
        atol=1e-6)
    np.testing.assert_allclose(
        assert_same(lambda p: m3(p).mat_mult([]), pkg), np.eye(4), atol=0)


def test_mul_vec_appends_w(pkg):
    t = assert_same(lambda p: m3(p).translate([5.0, 0.0, 0.0]), pkg)
    np.testing.assert_allclose(
        assert_same(lambda p: m3(p).mul_vec(t, [1.0, 1.0, 1.0]), pkg),
        [6.0, 1.0, 1.0, 1.0])


# --------------------------------------------------------------------------
# the Seidel triangulator (tests/test_triangulation.py)
# --------------------------------------------------------------------------

def geo(pkg):
    return module(pkg, "geometry")


def triangulated(poly, pkg, seed=0):
    """``triangulate(poly, seed)`` in ``pkg``, equal to the other
    package's, checked for the contract's properties; returns the
    triangles."""
    verts = assert_same(lambda p: np.asarray(
        geo(p).triangulate(poly, seed=seed), np.float64), pkg)
    tris = [verts[i:i + 3] for i in range(0, len(verts), 3)]
    assert len(tris) == len(poly) - 2, "n-2 triangle count"
    total = sum(abs(shoelace(t)) for t in tris)
    assert total == pytest.approx(abs(shoelace(poly)), rel=1e-4)
    for t in tris:
        assert shoelace(t) >= 0, f"CW winding violated: {t}"
    return tris


def test_square(pkg):
    assert len(triangulated(SQUARE, pkg)) == 2


def test_demo_heptagon(pkg):
    triangulated(HEPTAGON, pkg)


def test_demo_heptagon_all_seeds_same_area(pkg):
    areas = {round(sum(abs(shoelace(t))
                       for t in triangulated(HEPTAGON, pkg, seed)), 3)
             for seed in range(8)}
    assert len(areas) == 1


def test_triangle_passthrough(pkg):
    tri = [(0.0, 0.0), (10.0, 0.0), (0.0, 10.0)]
    if shoelace(tri) < 0:
        tri = tri[::-1]
    assert len(triangulated(tri, pkg)) == 1


def test_concave_l_shape(pkg):
    poly = [(0.0, 0.0), (4.0, 0.0), (4.0, 2.0), (2.0, 2.0), (2.0, 4.0),
            (0.0, 4.0)]
    assert shoelace(poly) > 0
    triangulated(poly, pkg)


def test_random_polygons_properties(pkg):
    for poly in random_simple_polygons(60):
        for seed in (0, 1):
            triangulated(poly, pkg, seed)


def test_interior_coverage_exact(pkg):
    """Sampled interior points are covered by exactly one triangle,
    exterior points by none."""
    rng = np.random.default_rng(3)
    for poly in random_simple_polygons(10, seed=11):
        tris = np.asarray(triangulated(poly, pkg), np.float64)

        def inside(x, y):
            hit = False
            for i in range(len(poly)):
                (x1, y1), (x2, y2) = poly[i], poly[(i + 1) % len(poly)]
                if (y1 > y) != (y2 > y) and \
                        x1 + (y - y1) / (y2 - y1) * (x2 - x1) > x:
                    hit = not hit
            return hit

        def covers(x, y):
            n = 0
            for a, b, c in tris:
                d1 = (x - a[0]) * (b[1] - a[1]) - (y - a[1]) * (b[0] - a[0])
                d2 = (x - b[0]) * (c[1] - b[1]) - (y - b[1]) * (c[0] - b[0])
                d3 = (x - c[0]) * (a[1] - c[1]) - (y - c[1]) * (a[0] - c[0])
                n += (d1 > 0) == (d2 > 0) == (d3 > 0)
            return n

        edges = [(poly[i], poly[(i + 1) % len(poly)])
                 for i in range(len(poly))]
        edges += [(t[i], t[(i + 1) % 3]) for t in tris for i in range(3)]

        def near_edge(x, y, eps=0.35):
            p = np.array([x, y])
            for a, b in edges:
                a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
                ab = b - a
                f = np.clip((p - a).dot(ab) / max(ab.dot(ab), 1e-300), 0, 1)
                if np.linalg.norm(a + f * ab - p) < eps:
                    return True
            return False

        for x, y in zip(rng.uniform(90, 310, 120), rng.uniform(90, 310, 120)):
            if not near_edge(x, y):
                assert covers(x, y) == (1 if inside(x, y) else 0)


def test_rejects_degenerate(pkg):
    with pytest.raises(ValueError):
        geo(pkg).triangulate([(0.0, 0.0), (1.0, 1.0)])


def test_unirand_is_permutation(pkg):
    for top in (1, 2, 3, 7, 16, 100, 101):
        for seed in (0, 1, 42):
            seen = assert_same(lambda p: list(geo(p).unirand_seed(top, seed)),
                               pkg)
            assert sorted(seen) == list(range(top)), (top, seed)


def test_unirand_deterministic(pkg):
    assert list(geo(pkg).unirand_seed(17, 5)) == list(
        geo(pkg).unirand_seed(17, 5))


def test_reusable_triangulator(pkg):
    def run(p):
        t = geo(p).Triangulation(0)
        out1, out2 = [], []
        t.create_polygon(SQUARE, out1.append)
        t.create_polygon(HEPTAGON, out2.append)
        return [np.asarray(out1, np.float64), np.asarray(out2, np.float64)]

    out1, out2 = assert_same(run, pkg)
    assert len(out1) == 6 and len(out2) == 15


# --------------------------------------------------------------------------
# the native triangulator and PNG codec (tests/test_native.py)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def native_built():
    """Both packages' native bridges load the library (built from
    ``native/`` once if it is missing)."""
    for p in PACKAGES:
        nat = module(p, "geometry.native")
        if not nat.available():
            try:
                subprocess.run(["make", "-C", "native"], check=True,
                               capture_output=True)
            except Exception:
                pytest.skip("native toolchain unavailable")
            nat._checked = False
            nat._lib = None
            if not nat.available():
                pytest.skip("native library failed to build")


def python_verts(p, poly, seed=0):
    out = []
    geo(p).Triangulation(seed, use_native=False).create_polygon(
        poly, out.append)
    return np.asarray(out, np.float32)


def native_verts(p, poly, seed=0):
    order = list(geo(p).unirand_seed(len(poly), seed))
    return module(p, "geometry.native").triangulate_native(
        np.asarray(poly, np.float32), order)


@pytest.mark.parametrize("poly", ["square", "heptagon"])
def test_native_demo_polygons_identical(pkg, poly, native_built):
    poly = SQUARE if poly == "square" else HEPTAGON
    want = assert_same(lambda p: python_verts(p, poly), pkg)
    np.testing.assert_array_equal(
        want, assert_same(lambda p: native_verts(p, poly), pkg))


def test_native_random_polygons_identical(pkg, native_built):
    for poly in random_simple_polygons(40, seed=123):
        for seed in (0, 1, 7):
            want = assert_same(lambda p: python_verts(p, poly, seed), pkg)
            got = assert_same(lambda p: native_verts(p, poly, seed), pkg)
            np.testing.assert_array_equal(want, got, err_msg=f"seed={seed}")


def test_native_dispatch_through_triangulation_class(pkg, native_built):
    def run(p, use_native):
        out = []
        geo(p).Triangulation(0, use_native=use_native).create_polygon(
            HEPTAGON, out.append)
        return np.asarray(out, np.float32)

    np.testing.assert_array_equal(
        assert_same(lambda p: run(p, True), pkg),
        assert_same(lambda p: run(p, False), pkg))


def test_native_rejects_ccw(pkg, native_built):
    with pytest.raises(ValueError):
        native_verts(pkg, SQUARE[::-1])


def pn(p):
    return module(p, "utils.png_native")


def test_png_gray16_roundtrip_and_pil_parity(pkg, native_built):
    from PIL import Image
    assert pn(pkg).available()
    g = np.random.default_rng(7).integers(0, 65536, (37, 53),
                                          dtype=np.uint16)
    blob = assert_same(lambda p: np.frombuffer(pn(p).encode_gray16(g),
                                               np.uint8), pkg).tobytes()
    np.testing.assert_array_equal(
        assert_same(lambda p: pn(p).decode_gray16(blob), pkg), g)
    np.testing.assert_array_equal(
        np.array(Image.open(io.BytesIO(blob))).astype(np.uint16), g)
    buf = io.BytesIO()
    Image.fromarray(g, mode="I;16").save(buf, format="PNG")
    np.testing.assert_array_equal(
        assert_same(lambda p: pn(p).decode_gray16(buf.getvalue()), pkg), g)


def test_png_gray8_widens_like_pil_path(pkg, native_built):
    from PIL import Image
    g8 = np.random.default_rng(8).integers(0, 256, (20, 31), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(g8, mode="L").save(buf, format="PNG")
    np.testing.assert_array_equal(
        assert_same(lambda p: pn(p).decode_gray16(buf.getvalue()), pkg),
        g8.astype(np.uint16) * 257)


def test_png_rgba8_roundtrip_and_pil_parity(pkg, native_built):
    from PIL import Image
    a = np.random.default_rng(9).integers(0, 256, (25, 41, 4),
                                          dtype=np.uint8)
    blob = assert_same(lambda p: np.frombuffer(pn(p).encode_rgba8(a),
                                               np.uint8), pkg).tobytes()
    np.testing.assert_array_equal(
        assert_same(lambda p: pn(p).decode_rgba8(blob), pkg), a)
    np.testing.assert_array_equal(
        np.array(Image.open(io.BytesIO(blob)).convert("RGBA")), a)
    buf = io.BytesIO()
    Image.fromarray(a, mode="RGBA").save(buf, format="PNG")
    np.testing.assert_array_equal(
        assert_same(lambda p: pn(p).decode_rgba8(buf.getvalue()), pkg), a)


def test_png_unsupported_falls_back(pkg, native_built):
    """A palette PNG: the native bridge returns None and utils.png falls
    back to PIL, with the same pixels in both packages."""
    from PIL import Image
    a = np.random.default_rng(10).integers(0, 256, (16, 16, 3),
                                           dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(a, mode="RGB").convert("P").save(buf, format="PNG")
    assert pn(pkg).decode_rgba8(buf.getvalue()) is None
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "pal.png")
        with open(path, "wb") as f:
            f.write(buf.getvalue())
        out = assert_same(lambda p: module(p, "utils.png").load_rgba8(path),
                          pkg)
    np.testing.assert_array_equal(
        out, np.array(Image.open(io.BytesIO(buf.getvalue())).convert("RGBA")))


def test_png_codec_round_trip(pkg, native_built):
    """utils.png write/read pairs stay bit-exact, and each package reads
    the other's files to the same pixels."""
    rng = np.random.default_rng(11)
    g = rng.integers(0, 65536, (100, 100), dtype=np.uint16)
    a = rng.random((32, 45, 4)).astype(np.float32)
    with tempfile.TemporaryDirectory() as d:
        mine, theirs = module(pkg, "utils.png"), module(other(pkg),
                                                        "utils.png")
        mine.save_grayscale16(os.path.join(d, "g.png"), g)
        mine.save_rgba8(os.path.join(d, "a.png"), a)
        theirs.save_grayscale16(os.path.join(d, "g2.png"), g)
        for path in ("g.png", "g2.png"):
            for reader in (mine, theirs):
                np.testing.assert_array_equal(
                    reader.load_grayscale16(os.path.join(d, path)), g)
        expect = np.clip(np.rint(a * 255.0), 0, 255).astype(np.uint8)
        for reader in (mine, theirs):
            np.testing.assert_array_equal(
                reader.load_rgba8(os.path.join(d, "a.png")), expect)
        with open(os.path.join(d, "g.png"), "rb") as f1, \
                open(os.path.join(d, "g2.png"), "rb") as f2:
            assert f1.read() == f2.read()
