"""The torch device a renderer or a device-side helper runs on."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The torch device for ``device``, a CUDA device with its index (as
    a tensor's ``.device`` has it, so caches keyed by device match).
    Raises for a CUDA device when CUDA is absent (nothing falls back to
    the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
