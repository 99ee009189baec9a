"""The K1 lab's variants stay edits that apply to K1's source as it
stands, and the shared triangle sets are what their docstrings say."""

import numpy as np
import pytest
import torch

from myrenderer_tpu_torch.ops import raster_cuda
from myrenderer_tpu_torch.tools import k1_lab
from myrenderer_tpu_torch.utils.trisets import (crowded_triangles,
                                                random_triangles)


@pytest.fixture(scope="module")
def source():
    with open(raster_cuda._SOURCE) as f:
        return f.read()


@pytest.mark.parametrize("name", list(k1_lab.VARIANTS) + list(k1_lab.FAULTS))
def test_variant_edits_apply(name, source):
    out = {**k1_lab.VARIANTS, **k1_lab.FAULTS}[name](source)
    assert (out == source) == (name == "source")
    assert "raster_tile_launch" in out


def test_faults_to_catch_are_planted():
    assert set(k1_lab.MUST_CATCH) <= set(k1_lab.FAULTS)
    assert not set(k1_lab.FAULTS) & set(k1_lab.VARIANTS)


def test_timeline_edits_apply(source):
    out = k1_lab._edits(*k1_lab._TIMELINE)(source)
    assert out.count("= global_timer();") == 2 and "k1_lab_stamps" in out


def test_lab_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert k1_lab.main([]) == 1


def _screen_winding(clip):
    ndc = clip[..., :2] / clip[..., 3:4]
    d1, d2 = ndc[:, 1] - ndc[:, 0], ndc[:, 2] - ndc[:, 0]
    return d1[:, 0] * (-d2[:, 1]) - (-d1[:, 1]) * d2[:, 0]


def test_crowded_triangles_lie_in_their_tile():
    H, W, box = 64, 64, (16, 16)
    clip, vary = crowded_triangles(300, 5, H, W, box)
    assert clip.shape == (300, 3, 4) and vary.shape == (300, 3, 4)
    ndc = clip[..., :2] / clip[..., 3:4]
    px = (ndc[..., 0] + 1.0) * W / 2.0
    py = (1.0 - ndc[..., 1]) * H / 2.0
    # centres in [1, 15] of the box, corners within 1.5 pixels of them
    for p, b0 in ((px, box[0]), (py, box[1])):
        assert ((p > b0 - 0.501) & (p < b0 + 16.501)).all()
    assert (_screen_winding(clip) >= 0).all()


def test_random_triangles_are_clockwise_and_seeded():
    a, va = random_triangles(50, 3)
    b, vb = random_triangles(50, 3)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(va, vb)
    assert (_screen_winding(a) >= 0).all()
