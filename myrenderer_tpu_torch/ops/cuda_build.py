"""Builds the port's CUDA C++ kernels (``csrc/*.cu``) and loads them.

Each source has a plain C interface. At first use it is compiled with
``nvcc`` for ``sm_90a`` into a shared library in ``build/`` at the
repository root, under a content-addressed name (the source and the flags
hashed), so a changed source rebuilds and an unchanged one loads the file
already there; the library is written to a temporary file and moved into
place, so concurrent builds never load a half-written one. The kernels'
arithmetic pins the reference's rounding forms, so every source is built
without fused multiply-adds the compiler picks itself and without
flushing subnormals.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from typing import Optional

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                         "..", "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-ftz=false", "-prec-div=true", "-prec-sqrt=true",
              "-Xptxas", "-v"]


def build_library(source: str, what: str):
    """Compile ``source`` (a path) with :data:`NVCC_FLAGS` unless its
    library is built already, and load it. ``what`` names the kernel in
    errors. Returns (ctypes.CDLL, seconds spent, nvcc's output: empty
    when the library was there)."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError(f"building {what} needs the CUDA toolkit (nvcc)")
    with open(source, "rb") as f:
        src = f.read()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    os.makedirs(BUILD_DIR, exist_ok=True)
    stem = os.path.splitext(os.path.basename(source))[0]
    path = os.path.join(BUILD_DIR, f"{stem}_{key.hexdigest()[:16]}.so")
    t0 = time.perf_counter()
    log = ""
    if not os.path.exists(path):
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [os.path.join(CUDA_HOME, "bin", "nvcc"), *NVCC_FLAGS, "-o", tmp,
               os.path.abspath(source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed building {what}:\n{log}")
        os.replace(tmp, path)
    return ctypes.CDLL(path), time.perf_counter() - t0, log


class ZeroedScratch:
    """Device scratch for a kernel whose launches find their words zeroed
    and leave them zeroed (K4's and K5's counters and status words): each
    scratch is zeroed once, when it is made, and never by a launch or a
    graph node. Two launches that run at once must not share one, so a
    scratch belongs to one (device, stream) for eager launches and, inside
    :meth:`graph`, to the caller's store, one a device, for the launches
    captured into one CUDA graph."""

    def __init__(self):
        self._eager: dict = {}
        self._graph: Optional[dict] = None

    def get(self, dev, words: int):
        """At least ``words`` zeroed 8-byte words for a launch on ``dev``'s
        current stream."""
        import torch
        if self._graph is not None:
            store, key = self._graph, dev.index
        else:
            store = self._eager
            key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
        have = store.get(key)
        if have is not None and have.numel() >= words:
            return have
        if torch.cuda.is_current_stream_capturing():
            # a new allocation inside a capture: the graph's memset zeroes
            # it at each replay, and nothing outside the graph keeps it
            return torch.zeros(words, dtype=torch.int64, device=dev)
        have = torch.zeros(words, dtype=torch.int64, device=dev)
        store[key] = have
        return have

    @contextlib.contextmanager
    def graph(self, store: dict):
        """Inside the block, launches take their scratch from ``store`` (a
        dict the caller keeps as long as its CUDA graph): made, zeroed, by
        the eager warm-up before the capture, and reused by the capture,
        so the graph holds no memset of it."""
        self._graph = store
        try:
            yield
        finally:
            self._graph = None
