"""Marching-squares segment layers on the card: the wrapper of
csrc/segment_layers.cu (kernel A of the fast caster).

Replaces the TPU kernel
ohm_tsd_slam_tpu/ops/segment_layers_pallas.py::segment_layers_pallas.  The
plain version is grid/raycast_fast.py::segment_layers_plain; the wrapper
runs it for a grid on the CPU.  For a grid on CUDA it launches the kernel
or raises; `segment_layers.launches` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

from ohm_tsd_slam_tpu_torch.grid.raycast_fast import segment_layers_plain
from ohm_tsd_slam_tpu_torch.grid.state import TsdGrid
from ohm_tsd_slam_tpu_torch.ops import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
ROW = 128   # lanes per counted row


def _lib() -> ctypes.CDLL:
    lib = _build.load("segment_layers")
    fn = lib.segment_layers_f32
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _I, _I, _P]
        fn.restype = _I
    return lib


def segment_layers(grid: TsdGrid):
    """The layer mask [4*H*W] float32 0/1 (layer-major: segment 1, the
    saddle's segment 2, virtual h-edge, virtual v-edge) and the int32 count
    of set lanes of each 128-lane row of it."""
    tsd = grid.tsd
    if not tsd.is_cuda:
        return segment_layers_plain(grid)
    H, W = tsd.shape
    if tsd.dtype != torch.float32 or not tsd.is_contiguous():
        raise TypeError("segment_layers: the kernel takes a contiguous "
                        f"float32 field, got {tsd.dtype}")
    if W % ROW or H < 2:
        raise ValueError(f"segment_layers: needs W % {ROW} == 0 and H >= 2, "
                         f"got {H}x{W}")
    mask = torch.empty(4 * H * W, dtype=torch.float32, device=tsd.device)
    row_cnt = torch.empty(4 * H * W // ROW, dtype=torch.int32,
                          device=tsd.device)
    lib = _lib()
    with torch.cuda.device(tsd.device):
        err = lib.segment_layers_f32(
            tsd.data_ptr(), mask.data_ptr(), row_cnt.data_ptr(), H, W,
            torch.cuda.current_stream(tsd.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"segment_layers_f32 launch failed: cudaError {err}")
    segment_layers.launches += 1
    return mask, row_cnt


segment_layers.launches = 0
