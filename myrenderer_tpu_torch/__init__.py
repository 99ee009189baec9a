"""myrenderer_tpu_torch — the PyTorch / CUDA port of myrenderer_tpu.

The same retained scene API (Core, Renderer, Pipeline, Instance,
SceneNode, Surface, Draw) over torch tensors on one device, or in row
bands over a mesh of devices. On one card each frame is one CUDA graph
replay (``renderer/compiled.py``), on a mesh of cards two graphs a card
(the triangle shards' stage, then the bands'); the CPU and the oracle
backend run the frame eagerly. Rasterization is one pass of K1 per
frame (and band), or one per batch on the sequential path, a tile
rasterizer written in CUDA C++ for Hopper
(``csrc/raster_tile.cu``), with a plain PyTorch version of the same
function for CPU tensors; ``Renderer(raster_backend="oracle")`` takes
the full-frame oracle instead. Imports no JAX.
"""

from . import math3d
from .renderer import (Binding, BindingLayout, Core, Draw, Instance,
                       Pipeline, Renderer, SceneNode, Surface, VertexBuffer,
                       VertexLayout, Window)

__all__ = [
    "math3d", "Binding", "BindingLayout", "Core", "Draw", "Instance",
    "Pipeline", "Renderer", "SceneNode", "Surface", "VertexBuffer",
    "VertexLayout", "Window",
]

__version__ = "0.1.0"
