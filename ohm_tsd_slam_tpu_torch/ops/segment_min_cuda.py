"""K-level ray-segment candidate sweep on the card: the wrapper of
csrc/segment_min.cu (kernel C of the fast caster).

Replaces the TPU kernel
ohm_tsd_slam_tpu/ops/raycast_pallas.py::segment_min_pallas.  The plain
version is grid/raycast_fast.py::segment_min_plain; the wrapper runs it for
tensors on the CPU.  For tensors on CUDA it launches the kernel or raises;
`segment_min.launches` counts the launches (one per call, all levels).
"""

from __future__ import annotations

import ctypes

import torch

from ohm_tsd_slam_tpu_torch.grid.raycast_fast import segment_min_plain
from ohm_tsd_slam_tpu_torch.ops import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = _build.load("segment_min")
    fn = lib.segment_min_f32
    if fn.argtypes is None:
        fn.argtypes = [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _P]
        fn.restype = _I
    return lib


def segment_min(pack: torch.Tensor, count: torch.Tensor, ray: torch.Tensor,
                lo: torch.Tensor, hi: torch.Tensor, t_after: torch.Tensor,
                tr: torch.Tensor, levels: int = 1,
                cover: float = 0.0) -> torch.Tensor:
    """[B, levels] earliest intersections per beam (inf = none): level 0
    the earliest t >= t_after in [lo, hi], level k the earliest
    t >= level k-1 + cover; see segment_min_plain for the arguments."""
    if not pack.is_cuda:
        return segment_min_plain(pack, count, ray, lo, hi, t_after, tr,
                                 levels, cover)
    dev = pack.device
    B = ray.shape[0]
    if pack.dim() != 2 or pack.shape[0] != 8:
        raise ValueError(f"segment_min: pack must be [8, S], got "
                         f"{tuple(pack.shape)}")
    args = {"pack": (pack, pack.numel()), "ray": (ray, 2 * B), "lo": (lo, B),
            "hi": (hi, B), "t_after": (t_after, B), "tr": (tr, 2)}
    flat = {}
    for name, (t, numel) in args.items():
        if t.device != dev or t.dtype != torch.float32 or t.numel() != numel:
            raise TypeError(f"segment_min: {name} must be float32 with "
                            f"{numel} elements on {dev}, got {t.dtype} "
                            f"{tuple(t.shape)} on {t.device}")
        flat[name] = t.contiguous()
    if count.device != dev or count.dtype != torch.int32 or count.numel() != 1:
        raise TypeError("segment_min: count must be one int32 on the card")
    if levels < 1:
        raise ValueError(f"segment_min: levels must be >= 1, got {levels}")
    count = count.contiguous()
    out = torch.empty((B, levels), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.segment_min_f32(
            flat["pack"].data_ptr(), pack.shape[1], count.data_ptr(),
            flat["ray"].data_ptr(), flat["lo"].data_ptr(),
            flat["hi"].data_ptr(), flat["t_after"].data_ptr(),
            flat["tr"].data_ptr(), out.data_ptr(), B, levels, float(cover),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"segment_min_f32 launch failed: cudaError {err}")
    segment_min.launches += 1
    return out


segment_min.launches = 0
