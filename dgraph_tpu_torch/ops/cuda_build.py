"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into a shared
library with a plain C interface, loaded with ctypes. Libraries land in
`dgraph_tpu_torch/_build/` (git-ignored), named by a hash of the source, so
an edited kernel rebuilds and an unchanged one loads at once. A build that
fails raises: there is no fallback to the plain versions.

Nothing here runs at import; the first launch of a kernel builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
KERNELS = ("member_sweep", "vector_topk", "ivf_slab_scan")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: Dict[str, float] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    # torch's own lookup (CUDA_HOME or CUDA_PATH, then nvcc's directory):
    # the port reads the environment only through x/config.py
    from torch.utils.cpp_extension import CUDA_HOME

    path = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _so_path(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        tag = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{tag.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for one source; returns (process, tmp, so) or None when
    the library is already built."""
    so = _so_path(name)
    if os.path.exists(so):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, so


def _finish(name: str, job, t0: float) -> None:
    proc, tmp, so = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, so)
    BUILD_SECONDS[name] = time.perf_counter() - t0


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Build every named kernel, one nvcc each, all started together.
    Returns the seconds each build took (0 for a cached library)."""
    names = list(names)
    with _lock:
        t0 = time.perf_counter()
        jobs = {n: _start(n) for n in names}
        for n, job in jobs.items():
            if job is None:
                BUILD_SECONDS.setdefault(n, 0.0)
            else:
                _finish(n, job, t0)
    return {n: BUILD_SECONDS[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build([name])
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(_so_path(name))
    return lib
