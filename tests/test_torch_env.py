"""The PyTorch port's environment contract: it never imports JAX, asks
for a device explicitly, and never falls back from the CUDA kernel to
its plain version."""

import os
import subprocess
import sys

import pytest
import torch

from myrenderer_tpu_torch.geometry import triangulate_device
from myrenderer_tpu_torch.ops import raster_cuda
from myrenderer_tpu_torch.renderer import Core, Renderer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT_MODULES = [
    "myrenderer_tpu_torch",
    "myrenderer_tpu_torch.app.demo",
    "myrenderer_tpu_torch.app.stress",
    "myrenderer_tpu_torch.content",
    "myrenderer_tpu_torch.device",
    "myrenderer_tpu_torch.geometry",
    "myrenderer_tpu_torch.geometry.device_tri",
    "myrenderer_tpu_torch.ops",
    "myrenderer_tpu_torch.ops.binning",
    "myrenderer_tpu_torch.ops.raster_ref",
    "myrenderer_tpu_torch.ops.sampling",
    "myrenderer_tpu_torch.parallel",
    "myrenderer_tpu_torch.renderer",
    "myrenderer_tpu_torch.renderer.compiled",
    "myrenderer_tpu_torch.state",
    "myrenderer_tpu_torch.tools.k1_lab",
    "myrenderer_tpu_torch.tools.k4_lab",
    "myrenderer_tpu_torch.utils.png",
    "myrenderer_tpu_torch.utils.profiling",
    "myrenderer_tpu_torch.utils.scenes",
    "myrenderer_tpu_torch.utils.trisets",
]


def test_port_imports_no_jax():
    """Importing every module of the port in a fresh interpreter leaves
    jax out of sys.modules."""
    code = ("import importlib, sys\n"
            f"for m in {PORT_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m.startswith('myrenderer_tpu.'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_renderer_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Renderer(Core(fixed_timestep=1 / 60), device="cuda")


@pytest.mark.parametrize("entry", ["Renderer", "triangulate_device"])
def test_entry_points_default_to_the_card(entry):
    """Built without a device, the library's entry points run on the
    card: without CUDA they raise instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "Renderer":
            Renderer(Core(fixed_timestep=1 / 60))
        else:
            triangulate_device([(0.0, 0.0), (10.0, 0.0), (0.0, 10.0)])


def test_renderer_turns_tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    Renderer(Core(fixed_timestep=1 / 60), device="cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def _k1_inputs(device):
    H, W = 20, 36
    nt = -(-H // raster_cuda.TILE_H) * -(-W // raster_cuda.TILE_W)
    return (torch.zeros((0, 32), device=device),
            torch.zeros(0, dtype=torch.int32, device=device),
            torch.zeros(nt, dtype=torch.int32, device=device),
            torch.zeros(nt, dtype=torch.int32, device=device),
            torch.ones((H, W), device=device))


def test_k1_wrapper_raises_instead_of_falling_back():
    """Off the CPU the wrapper launches K1 or raises: a tensor on
    another device never reaches the plain version, and without the
    CUDA toolkit the kernel cannot be built (no silent fallback)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(ValueError):
        raster_cuda.rasterize_tiles(*_k1_inputs("meta"))
    kernel = raster_cuda.RasterTileKernel()
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        with pytest.raises(RuntimeError, match="CUDA toolkit"):
            kernel(*_k1_inputs("cpu"))
    assert kernel.launches == 0


def test_k1_wrapper_checks_inputs():
    packed, index, starts, counts, depth = _k1_inputs("cpu")
    with pytest.raises(TypeError):
        raster_cuda.rasterize_tiles(packed, index, starts.long(), counts,
                                    depth)
    with pytest.raises(TypeError, match="index"):
        raster_cuda.rasterize_tiles(packed, index.long(), starts, counts,
                                    depth)
    with pytest.raises(ValueError):
        raster_cuda.rasterize_tiles(packed, index, starts[:-1], counts[:-1],
                                    depth)
    with pytest.raises(ValueError):
        raster_cuda.rasterize_tiles(torch.zeros((0, 16)), index, starts,
                                    counts, depth)
    with pytest.raises(ValueError):
        raster_cuda.rasterize_tiles(packed, index[None], starts, counts,
                                    depth)
    with pytest.raises(ValueError):
        raster_cuda.rasterize_tiles(packed, index, starts, counts,
                                    depth.t())


def test_k1_cpu_uses_plain_version_and_counts_no_launch():
    before = raster_cuda.K1.launches
    fused, winner = raster_cuda.rasterize_tiles(*_k1_inputs("cpu"))
    assert raster_cuda.K1.launches == before
    assert fused.shape == (6, 20, 36) and winner.shape == (20, 36)
    assert bool((winner == -1).all())
    assert bool((fused[0] == 1).all()) and bool((fused[1] == 1).all())
    assert bool((fused[2:] == 0).all())


def test_k1_wrapper_rejects_segments_outside_the_stream():
    """A segment past the end of the index, or an index past the last
    packed record, raises before anything reads it."""
    packed, index, starts, counts, depth = _k1_inputs("cpu")
    counts[0] = 1
    with pytest.raises(ValueError, match="outside the index"):
        raster_cuda.rasterize_tiles(packed, index, starts, counts, depth)
    packed = torch.zeros((3, 32))
    for bad in (3, -1):
        index = torch.tensor([0, bad, 2], dtype=torch.int32)
        with pytest.raises(ValueError, match="outside the packed"):
            raster_cuda.rasterize_tiles(packed, index, starts, counts, depth)
