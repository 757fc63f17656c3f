"""Build and load the port's CUDA kernels.

Each kernel source in ../csrc/ is compiled by nvcc into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds)
and loaded with ctypes.  Libraries go to ohm_tsd_slam_tpu_torch/_build/;
a source newer than its library is rebuilt.  Nothing is built at import
time: `load` runs at a kernel's first launch.  A missing nvcc or a failed
build raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Dict

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """nvcc on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = os.path.join(home, "bin", "nvcc")
    if os.path.exists(nvcc):
        return nvcc
    raise RuntimeError("nvcc not found (searched PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): cannot build the CUDA kernels")


def build(name: str) -> str:
    """Compile csrc/<name>.cu into _build/lib<name>.so unless the library
    is newer than its source; returns the library path."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    lib = os.path.join(BUILD_DIR, f"lib{name}.so")
    if (os.path.exists(lib)
            and os.path.getmtime(lib) >= os.path.getmtime(src)):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{src}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)   # atomic: a concurrent build never loads a partial file
    return lib


def load(name: str) -> ctypes.CDLL:
    """Build if needed, then load (once per process) lib<name>.so."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(build(name))
        return _loaded[name]
