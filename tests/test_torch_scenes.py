"""The behaviour scenes of ``myrenderer_tpu_torch/utils/scenes.py`` with
their between-frame scripts, on the CPU: what ``chip_smoke.py`` phase
12 runs on the card as CUDA graph replays, eager frames and oracle
frames. Here, after every frame, the tile backend's frame-wide winners
equal the oracle's (the oracle is held to the JAX oracle in the other
parity tests), and frame plans of older scene versions are dropped."""

import numpy as np
import pytest
import torch

from myrenderer_tpu_torch.utils import scenes

torch.set_num_threads(1)


SCRIPT_FRAMES = 4


@pytest.mark.parametrize("name", list(scenes.SCRIPTED))
def test_scripted_scene_tile_equals_oracle(name):
    """Each behaviour scene's between-frame script on the CPU: after
    every frame the tile backend's frame-wide winners equal the
    oracle's and the colours agree; no overflow."""
    build = scenes.SCRIPTED[name]
    tile, oracle = build("cpu", "auto"), build("cpu", "oracle")
    for k in range(SCRIPT_FRAMES):
        tile.step(k)
        oracle.step(k)
        tw = scenes.global_winners(tile.draw)
        torch.testing.assert_close(tw, scenes.global_winners(oracle.draw),
                                   rtol=0, atol=0, msg=f"frame {k}")
        assert int((tw >= 0).sum()) > 100
        # colours to the JAX backends' tolerance (test_raster_pallas.py
        # test_demo_scene_backend_parity): the oracle rounds its varying
        # planes in forms of its own
        np.testing.assert_allclose(
            *(s.window.read_pixels(as_uint8=False) for s in (tile, oracle)),
            atol=5e-4, rtol=1e-4)
        for s in (tile, oracle):
            assert not bool(s.draw.last_overflow.any())


def test_plans_of_older_scene_versions_are_dropped():
    """A frame plan is keyed by the scene version, which only grows: a
    vertex-buffer swap or a resize makes a new plan and drops the old
    ones (on a card each holds a CUDA graph and its memory pool), while
    plans of one version (surface sets drawn in turn) stay cached."""
    swaps = scenes.SCRIPTED["swaps"]("cpu", "auto")
    surfaces = scenes.SCRIPTED["surfaces"]("cpu", "auto")
    for k in range(4):
        swaps.step(k)
        surfaces.step(k)
        assert len(swaps.draw._plans) == 1
        assert len(surfaces.draw._plans) == min(k + 1, 3)


def test_event_queue_resize_makes_one_plan():
    """A window resized through ``Core.resize_window`` (the surfaces are
    not told) makes one new frame plan, not one under the old scene
    version and another a frame later: on a card each is a capture."""
    scene = scenes.SCRIPTED["writes"]("cpu", "auto")
    scene.step(0)
    scene.renderer.core.resize_window(scene.window, 80, 48)
    plans = []
    for k in range(1, 4):
        scene.step(k)
        assert len(scene.draw._plans) == 1
        plans.append(next(iter(scene.draw._plans.values())))
    assert plans[0] is plans[1] is plans[2]
    assert scene.window.framebuffer.shape == (48, 80, 4)
