"""Order-preserving pack of the isocontour segments on the card: the
wrapper of csrc/pack_rows.cu (kernel B of the fast caster).

Replaces the TPU kernel
ohm_tsd_slam_tpu/ops/pack_rows_pallas.py::pack_channels_rows_pallas, with
the endpoint recompute around it.  The plain version is
grid/raycast_fast.py::pack_rows_plain; the wrapper runs it for a grid on the
CPU.  For a grid on CUDA it launches the kernel or raises;
`pack_rows.launches` counts the launches.  The count of set lanes stays on
the device.

The kernel takes the prefix of the row counts itself
(csrc/scan_rows.cuh); `status_words` is the scratch that prefix needs,
which must be zero at the launch: the wrapper allocates it behind the pack
in one buffer, and the kernel's one memset zeroes both.
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
TILE_ROWS = 256       # csrc/scan_rows.cuh::kTileRows: rows a block takes


def status_words(rows: int) -> int:
    """64-bit words of scratch the prefix over `rows` row counts needs
    (csrc/scan_rows.cuh): one a tile and the ticket."""
    return -(-rows // TILE_ROWS) + 1


def _lib() -> ctypes.CDLL:
    lib = _build.load("pack_rows")
    fn = lib.pack_rows_f32
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _I, _P, _I, _I, _I, _F, _F, _P]
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
    total = torch.empty(1, dtype=torch.int32, device=tsd.device)
    buf = empty_pack(tsd.device, n // ROW, size)
    launch(grid, mask, row_cnt, buf, total)
    return buf[:5], total[0]


def empty_pack(device, rows: int, size: int, height: int = 5
               ) -> torch.Tensor:
    """The kernel's output buffer for `rows` row counts and a capacity of
    `size` segments: the pack's `height` rows of size + 128 (five here;
    the channels and the validity row in csrc/compact_channels.cu) and,
    behind them, whole rows that hold the prefix's status words."""
    cap = size + ROW
    extra = -(-2 * status_words(rows) // cap)
    return torch.empty((height + extra, cap), dtype=torch.float32,
                       device=device)


def launch(grid: TsdGrid, mask: torch.Tensor, row_cnt: torch.Tensor,
           buf: torch.Tensor, total: torch.Tensor) -> None:
    """Launch the kernel on the current stream, on buffers the caller
    holds (pack_rows checks the inputs and allocates them): fills the pack
    `buf[:5]` of an empty_pack() buffer and `total` [1].  Raises if the
    launch is refused; counts it in pack_rows.launches."""
    tsd = grid.tsd
    H, W = tsd.shape
    cap = buf.shape[1]
    if cap % 2:
        raise ValueError("pack_rows: the kernel needs an even capacity (the "
                         "status words behind the pack lie on 8 bytes), got "
                         f"{cap}")
    s = grid.cell_size
    lib = _lib()
    with torch.cuda.device(tsd.device):
        err = lib.pack_rows_f32(
            tsd.data_ptr(), mask.data_ptr(), row_cnt.data_ptr(),
            buf.data_ptr(), (buf.shape[0] - 5) * cap // 2, total.data_ptr(),
            H, W, cap, s, 0.9 * s,
            torch.cuda.current_stream(tsd.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pack_rows_f32 launch failed: cudaError {err}")
    pack_rows.launches += 1


pack_rows.launches = 0
