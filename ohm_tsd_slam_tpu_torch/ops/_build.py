"""Build and load the port's CUDA kernels.

Each kernel source in ../csrc/ is compiled by nvcc into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds)
and loaded with ctypes.  Libraries go to ohm_tsd_slam_tpu_torch/_build/,
named after the source and a hash of its nvcc command line
(lib<name>-<hash>.so), so a change of flags builds a new library; a
source (or a shared header, csrc/*.cuh) newer than its library is rebuilt.  Nothing is built at import
time: `load` runs at a kernel's first launch, and `build_all` compiles
several sources at once, one nvcc process each.  A missing nvcc or a
failed build raises.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List, Optional

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

# The fast caster's kernels must round as their torch twins do: no FMA
# contraction (a*b - c*d fused moves a cross product or a bilinear blend
# by an ulp, and a sample near zero can flip an event), IEEE division and
# square root, no flush of denormals.  The push decides per tile as
# grid/push.py::tile_cull does (a corner's beam bin, a range-window edge),
# so it rounds as its twin as well; ICP's pair assignment and EXP's
# nearest model point pick the least of distances that must equal their
# twins' in every bit.
_IEEE = ["-fmad=false", "-prec-div=true", "-prec-sqrt=true", "-ftz=false"]
KERNEL_FLAGS: Dict[str, List[str]] = {
    "push": _IEEE,
    "segment_layers": _IEEE,
    "pack_rows": _IEEE,
    "segment_min": _IEEE,
    "window_replay": _IEEE,
    "assign_pairs": _IEEE,
    "nearest_model": _IEEE,
}

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


def _flags(name: str) -> List[str]:
    return [*NVCC_FLAGS, *KERNEL_FLAGS.get(name, [])]


def lib_path(name: str) -> str:
    tag = hashlib.sha1(" ".join(_flags(name)).encode()).hexdigest()[:10]
    return os.path.join(BUILD_DIR, f"lib{name}-{tag}.so")


def _fresh(name: str) -> bool:
    lib = lib_path(name)
    srcs = [os.path.join(CSRC_DIR, name + ".cu"),
            *glob.glob(os.path.join(CSRC_DIR, "*.cuh"))]
    return (os.path.exists(lib)
            and os.path.getmtime(lib) >= max(map(os.path.getmtime, srcs)))


def build_all(names: Iterable[str]) -> None:
    """Compile csrc/<name>.cu into lib_path(name) for each stale
    library, all nvcc processes started together."""
    todo = [n for n in names if not _fresh(n)]
    if not todo:
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    procs = []
    for name in todo:
        tmp = f"{lib_path(name)}.{os.getpid()}.tmp"
        cmd = [nvcc, *_flags(name), "-o", tmp,
               os.path.join(CSRC_DIR, name + ".cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for name, tmp, proc in procs:
        out, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            errors.append(f"nvcc failed ({proc.returncode}) building "
                          f"csrc/{name}.cu:\n{out}")
        else:
            # atomic: a concurrent build never loads a partial file
            os.replace(tmp, lib_path(name))
    if errors:
        raise RuntimeError("\n".join(errors))


def resource_usage(name: str, source: Optional[str] = None) -> List[str]:
    """ptxas's report for the kernels of csrc/<name>.cu built with that
    kernel's flags (or of another `source` built with them): registers,
    stack frame, spills, shared memory, one line per fact.  Compiles into
    a file that is removed."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path(name)}.{os.getpid()}.usage.tmp"
    cmd = [find_nvcc(), *_flags(name), "--resource-usage", "-o", tmp,
           source or os.path.join(CSRC_DIR, name + ".cu")]
    try:
        out = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True,
                             timeout=600)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed ({out.returncode}) on "
                           f"{cmd[-1]}:\n{out.stdout}")
    # the stack frame and spills stand on an indented line of their own
    # under each function's "ptxas info" line
    return [line.strip() for line in out.stdout.splitlines()
            if "ptxas info" in line or "bytes stack frame" in line]


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless its library is fresh; returns the
    library path."""
    build_all([name])
    return lib_path(name)


def load(name: str) -> ctypes.CDLL:
    """Build if needed, then load (once per process) lib_path(name)."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(build(name))
        return _loaded[name]
