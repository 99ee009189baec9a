"""The device ear clipper of the PyTorch port against the JAX package's
on the CPU: triangle indices exactly equal on the demo polygons and on
seeded simple polygons (n = 3..32), and the Polygon module's
``device_triangulation`` option rendering the JAX module's winners."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myrenderer_tpu.content.polygon import Polygon as JPolygon
from myrenderer_tpu.geometry import device_tri as jdt
from myrenderer_tpu_torch.content.polygon import Polygon as TPolygon
from myrenderer_tpu_torch.geometry import device_tri as tdt
from myrenderer_tpu_torch.geometry import triangulate
from test_device_tri import HEPTAGON, SQUARE, star_polygon
from test_torch_sequential import JAX, TORCH

torch.set_num_threads(1)

POLYGONS = ([("heptagon", HEPTAGON), ("square", SQUARE)]
            + [(f"star{n}_{s}", star_polygon(n, s))
               for n in range(3, 33) for s in (0, 1)]
            + [("collinear", [(100.0, 50.0), (0.0, 50.0), (0.0, 0.0),
                              (25.0, 0.0), (50.0, 0.0), (75.0, 0.0),
                              (100.0, 0.0)])])


@pytest.mark.parametrize("name,poly", POLYGONS, ids=[n for n, _ in POLYGONS])
def test_indices_match_jax(name, poly):
    n, cap = len(poly), 32
    buf = np.zeros((cap, 2), np.float32)
    buf[:n] = poly
    want = np.asarray(jdt.triangulate_indices(jnp.asarray(buf),
                                              jnp.int32(n), cap))
    got = tdt.triangulate_indices(torch.from_numpy(buf), n, cap)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(want, got.numpy())
    assert (tdt.triangulate_device(poly, device="cpu")
            == jdt.triangulate_device(poly))


def test_same_area_as_seidel():
    """A valid triangulation: n - 2 clockwise triangles tiling the
    polygon (same summed area as the host Seidel path)."""
    def area(tris):
        p = np.asarray(tris, np.float64).reshape(-1, 3, 2)
        d1, d2 = p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]
        return 0.5 * (d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0])

    poly = star_polygon(17, 9)
    dev = area(tdt.triangulate_device(poly, device="cpu"))
    assert len(dev) == 15 and (dev >= 0).all()
    assert np.isclose(dev.sum(), area(triangulate(poly)).sum(), rtol=1e-5)


def test_rejects_bad_inputs():
    with pytest.raises(ValueError, match="at least 3"):
        tdt.triangulate_device([(0, 0), (1, 1)], device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        tdt.triangulate_device(star_polygon(33, 0), capacity=32,
                               device="cpu")
    with pytest.raises(ValueError, match="2 < n"):
        tdt.triangulate_indices(torch.zeros(32, 2), 2)


def render_polygons(api, backend, module):
    """The demo's polygons (heptagon and square) on its 2D surface,
    triangulated on the device; returns (winner, vertex rows)."""
    pkg = api.pkg
    core = pkg.Core(fixed_timestep=1.0 / 60.0)
    window = core.create_window(64, 64, "polygons")
    rend = api.renderer(core, backend)
    rend.adopt_window(window)
    rend.debug_winner = True
    mod = module(rend, device_triangulation=True)
    root = pkg.SceneNode.create(rend)
    handles = [mod.create_polygon(p) for p in (HEPTAGON, SQUARE)]
    for h in handles:
        root.add_child(h.get_node())
    surf = pkg.Surface.create_window_scene(rend, window, root)
    surf.set_perspective(pkg.math3d.projection_2d(
        left=0.0, right=200.0, bottom=200.0, top=0.0, near=0.1, far=200.0))
    draw = pkg.Draw.create(rend)
    draw.begin()
    draw.clear((0, 0, 0, 1))
    draw.draw_surface(surf)
    draw.end()
    rows = np.concatenate([h.vertex_buffer._staging for h in handles])
    return np.asarray(draw.last_winners[0]), rows


def test_polygon_module_device_triangulation():
    jwin, jrows = render_polygons(JAX, "pallas", JPolygon)
    twin, trows = render_polygons(TORCH, "auto", TPolygon)
    np.testing.assert_array_equal(jrows, trows)
    np.testing.assert_array_equal(jwin, twin)
    assert int((twin >= 0).sum()) > 100
