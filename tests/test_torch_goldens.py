"""The oracle half of ``tests/test_goldens.py`` through the PyTorch port:
``DemoApp(128, 128, backend="oracle")`` at frames 1 and 31 against
``tests/goldens/demo_128_frame{1,31}.png`` (the goldens rule: no value
more than 1 uint8 step off, more than 99.9 % exact). The JAX oracle is
not re-run here; the port's oracle frame 1 is held to it bit for bit in
``test_torch_content.py``. The tile half is ``test_torch_demo.py``'s
``test_demo_frame_golden``, the textured golden (both backends)
``test_torch_sampling.py``'s ``test_textured_golden``.

The demo's frame is a function of the renderer's clock (the camera
orbits with ``elapsed_time``; every frame clears), so frame k is
rendered after k - 1 clock steps without drawing the frames between:
the same ``Renderer.update`` sums, the same frame. The test of that
renders it both ways on the tile backend."""

import os

import numpy as np
import pytest
import torch

from myrenderer_tpu_torch.app.demo import DemoApp
from myrenderer_tpu_torch.utils.png import load_rgba8

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def demo_frame(frame, backend, size=128):
    """``DemoApp(size, size, backend=backend)`` at frame ``frame``: the
    clock advanced ``frame - 1`` steps, then one frame."""
    app = DemoApp(width=size, height=size, backend=backend, device="cpu")
    for _ in range(frame - 1):
        app.renderer.update()
    app.tick()
    return app


def test_clock_steps_give_the_rendered_frame():
    """Frame 31 after 30 clock steps equals the 31st rendered frame, bit
    for bit, winners included (tile backend, 48x48)."""
    ran = DemoApp(width=48, height=48, device="cpu")
    ran.renderer.debug_winner = True
    ran.run(31)
    stepped = DemoApp(width=48, height=48, device="cpu")
    stepped.renderer.debug_winner = True
    for _ in range(30):
        stepped.renderer.update()
    stepped.tick()
    assert stepped.renderer.elapsed_time == ran.renderer.elapsed_time
    assert torch.equal(stepped.window.framebuffer.view(torch.int32),
                       ran.window.framebuffer.view(torch.int32))
    assert torch.equal(stepped.draw.last_winners[0], ran.draw.last_winners[0])


@pytest.mark.parametrize("frame", [1, 31])
def test_demo_frame_golden_oracle(frame):
    got = demo_frame(frame, "oracle").window.read_pixels()
    want = load_rgba8(os.path.join(GOLDEN_DIR, f"demo_128_frame{frame}.png"))
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1
    assert (diff == 0).mean() > 0.999
