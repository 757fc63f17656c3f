"""Order-preserving pack of the isocontour segments on the card: the
wrapper of csrc/pack_rows.cu (kernel B of the fast caster).

Replaces the TPU kernel
ohm_tsd_slam_tpu/ops/pack_rows_pallas.py::pack_channels_rows_pallas, with
the endpoint recompute around it.  The plain version is
grid/raycast_fast.py::pack_rows_plain; the wrapper runs it for a grid on the
CPU.  For a grid on CUDA it launches the kernel or raises;
`pack_rows.launches` counts the launches.  The count of set lanes stays on
the device.
"""

from __future__ import annotations

import ctypes

import torch

from ohm_tsd_slam_tpu_torch.grid.raycast_fast import pack_rows_plain
from ohm_tsd_slam_tpu_torch.grid.state import TsdGrid
from ohm_tsd_slam_tpu_torch.ops import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
ROW = 128


def _lib() -> ctypes.CDLL:
    lib = _build.load("pack_rows")
    fn = lib.pack_rows_f32
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _P]
        fn.restype = _I
    return lib


def pack_rows(grid: TsdGrid, mask: torch.Tensor, row_cnt: torch.Tensor,
              size: int):
    """The endpoints (p0x, p0y, p1x, p1y) of the segments the layer mask
    of segment_layers selects, in flat order, and a 1.0 validity row:
    [5, size + 128] float32, zeros after the last segment.  Returns it and
    the int32 count of set lanes, which may exceed the capacity (those
    segments are dropped)."""
    tsd = grid.tsd
    if not tsd.is_cuda:
        return pack_rows_plain(grid, mask, size)
    H, W = tsd.shape
    if tsd.dtype != torch.float32 or not tsd.is_contiguous():
        raise TypeError("pack_rows: the kernel takes a contiguous float32 "
                        f"field, got {tsd.dtype}")
    if W % ROW or size % ROW:
        raise ValueError(f"pack_rows: needs W and size multiples of {ROW}, "
                         f"got W={W}, size={size}")
    n = 4 * H * W
    for name, t, dt, numel in (("mask", mask, torch.float32, n),
                               ("row_cnt", row_cnt, torch.int32, n // ROW)):
        if (t.device != tsd.device or t.dtype != dt or t.numel() != numel
                or not t.is_contiguous()):
            raise ValueError(f"pack_rows: {name} must be a contiguous {dt} "
                             f"tensor of {numel} on {tsd.device}")
    cap = size + ROW
    packed = torch.empty((5, cap), dtype=torch.float32, device=tsd.device)
    row_off = torch.empty_like(row_cnt)
    total = torch.empty(1, dtype=torch.int32, device=tsd.device)
    s = grid.cell_size
    lib = _lib()
    with torch.cuda.device(tsd.device):
        err = lib.pack_rows_f32(
            tsd.data_ptr(), mask.data_ptr(), row_cnt.data_ptr(),
            row_off.data_ptr(), packed.data_ptr(), total.data_ptr(), H, W,
            cap, s, 0.9 * s,
            torch.cuda.current_stream(tsd.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pack_rows_f32 launch failed: cudaError {err}")
    pack_rows.launches += 1
    return packed, total[0]


pack_rows.launches = 0
