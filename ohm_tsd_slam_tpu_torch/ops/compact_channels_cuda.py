"""Order-preserving compaction of a flat mask with its value channels on
the card: the wrapper of csrc/compact_channels.cu (kernel E of the fast
caster, behind the general segment extraction of
grid/raycast_fast.py::extract_segments).

Replaces the TPU kernel
ohm_tsd_slam_tpu/ops/compact_pallas.py::compact_channels_pallas.  The plain
version is grid/compact.py::pack_channels_rows; the wrapper runs it for
tensors on the CPU.  For tensors on CUDA it launches the kernel or raises;
`compact_channels.launches` counts the launches.  The count of set lanes
stays on the device.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ohm_tsd_slam_tpu_torch.grid.compact import pack_channels_rows
from ohm_tsd_slam_tpu_torch.ops import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
ROW = 128
MAX_CHANNELS = 8


def _lib() -> ctypes.CDLL:
    lib = _build.load("compact_channels")
    fn = lib.compact_channels_f32
    if fn.argtypes is None:
        fn.argtypes = [_P, _I, ctypes.POINTER(_P), _I, _I, _P, _P, _P, _P,
                       _I, _P]
        fn.restype = _I
    return lib


def compact_channels(mask: torch.Tensor, channels: Sequence[torch.Tensor],
                     size: int):
    """The values of `channels` at the set lanes of the flat `mask` (bool,
    or float32 set where > 0), in flat order, then a 1.0 validity row:
    [len(channels) + 1, size + 128] float32, zeros after the last set
    lane.  Returns it and the int32 count of set lanes, which may exceed
    the capacity (those lanes are dropped).  Values are copied, so NaN and
    Inf pass through."""
    if not mask.is_cuda:
        return pack_channels_rows(mask, tuple(channels), size)
    n = mask.numel()
    if mask.dtype not in (torch.bool, torch.float32):
        raise TypeError("compact_channels: the kernel takes a bool or "
                        f"float32 mask, got {mask.dtype}")
    if mask.dim() != 1 or not mask.is_contiguous():
        raise ValueError("compact_channels: mask must be flat and contiguous")
    if n < ROW or n % ROW or size % ROW or size < 0:
        raise ValueError(f"compact_channels: needs n and size multiples of "
                         f"{ROW}, got n={n}, size={size}")
    if not 1 <= len(channels) <= MAX_CHANNELS:
        raise ValueError(f"compact_channels: takes 1 to {MAX_CHANNELS} "
                         f"channels, got {len(channels)}")
    for c in channels:
        if c.dtype != torch.float32:
            raise TypeError("compact_channels: the kernel takes float32 "
                            f"channels, got {c.dtype}")
        if (c.device != mask.device or c.shape != mask.shape
                or not c.is_contiguous()):
            raise ValueError("compact_channels: every channel must be a "
                             f"contiguous tensor of {n} on {mask.device}")
    cap = size + ROW
    dev = mask.device
    packed = torch.empty((len(channels) + 1, cap), dtype=torch.float32,
                         device=dev)
    row_cnt = torch.empty(n // ROW, dtype=torch.int32, device=dev)
    row_off = torch.empty_like(row_cnt)
    total = torch.empty(1, dtype=torch.int32, device=dev)
    launch(mask, channels, packed, row_cnt, row_off, total)
    return packed, total[0]


def launch(mask: torch.Tensor, channels: Sequence[torch.Tensor],
           packed: torch.Tensor, row_cnt: torch.Tensor,
           row_off: torch.Tensor, total: torch.Tensor) -> None:
    """Launch the kernel on the current stream, on buffers the caller
    holds (compact_channels checks the inputs and allocates them): fills
    `packed` [len(channels) + 1, cap] and `total` [1]; `row_cnt` and
    `row_off` are int32 scratch of n / 128.  Raises if the launch is
    refused; counts it in compact_channels.launches."""
    dev = mask.device
    ptrs = (_P * len(channels))(*[c.data_ptr() for c in channels])
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.compact_channels_f32(
            mask.data_ptr(), int(mask.dtype == torch.float32), ptrs,
            len(channels), mask.numel(), row_cnt.data_ptr(),
            row_off.data_ptr(), packed.data_ptr(), total.data_ptr(),
            packed.shape[1], torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"compact_channels_f32 launch failed: cudaError {err}")
    compact_channels.launches += 1


compact_channels.launches = 0
