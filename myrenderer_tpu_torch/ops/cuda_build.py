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

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time

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
