"""TSD fusion push on the card: the wrapper of csrc/push.cu.

Replaces the TPU kernel ohm_tsd_slam_tpu/ops/push_pallas.py::push_pallas
and, with it, the per-tile cull that the JAX package leaves to XLA: on the
card one launch culls the tiles, fuses the scan into the cells of the
tiles it selects, copies the other tiles through and writes the new
tile_init / tile_initw (see the note in csrc/push.cu).  The wrapper
allocates the four output arrays and launches; it runs no torch op on the
grid.  The kernel is bound by bytes: the whole grid is read and written
once.

The grid stays a value: the kernel writes out of place and a new TsdGrid
is returned, so a reader of the old grid (the threaded node's localizer)
is never written under.

For a grid on the CPU the wrapper runs the plain version, grid/push.py::
push (whose cull is grid/push.py::tile_cull).  For a grid on CUDA it
launches the kernel or raises; `launches` counts the launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional

import torch

from ohm_tsd_slam_tpu_torch.grid.push import push
from ohm_tsd_slam_tpu_torch.grid.state import TsdGrid
from ohm_tsd_slam_tpu_torch.ops import _build
from ohm_tsd_slam_tpu_torch.sensor.polar2d import SensorPolar2D

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = _build.load("push")
    fn = lib.tsd_push_f32
    if fn.argtypes is None:
        fn.argtypes = [_P] * 13 + [_I] * 5 + [_F] * 12 + [_P]
        fn.restype = _I
    return lib


def _check(grid: TsdGrid, geom: SensorPolar2D, pose: torch.Tensor,
           data: torch.Tensor, mask: torch.Tensor) -> None:
    dev = grid.tsd.device
    for name, t in (("tsd", grid.tsd), ("weight", grid.weight)):
        if t.dtype != torch.float32:
            raise TypeError(f"push_cuda: grid.{name} is {t.dtype}; the "
                            "CUDA push takes float32 grids only")
        if not t.is_contiguous() or t.shape != grid.tsd.shape:
            raise ValueError(f"push_cuda: grid.{name} must be a contiguous "
                             f"[H, W] tensor, got {tuple(t.shape)}")
    tiles = (grid.tiles_y, grid.tiles_x)
    if (grid.tiles_y * grid.tile_dim != grid.cells_y
            or grid.tiles_x * grid.tile_dim != grid.cells_x
            or tuple(grid.tile_initw.shape) != tiles):
        raise ValueError("push_cuda: the tile arrays must tile the grid "
                         "exactly")
    for name, t, dtype in (("tile_init", grid.tile_init, torch.bool),
                           ("tile_initw", grid.tile_initw, torch.float32),
                           ("mask", mask, torch.bool)):
        if t.dtype != dtype:
            raise TypeError(f"push_cuda: {name} is {t.dtype}, the kernel "
                            f"takes {dtype}")
    if not (grid.tile_init.is_contiguous()
            and grid.tile_initw.is_contiguous()):
        raise ValueError("push_cuda: the tile arrays must be contiguous")
    for name, t in (("weight", grid.weight), ("tile_init", grid.tile_init),
                    ("tile_initw", grid.tile_initw), ("pose", pose),
                    ("data", data), ("mask", mask)):
        if t.device != dev:
            raise ValueError(f"push_cuda: {name} is on {t.device}, the "
                             f"grid on {dev}")
    if tuple(pose.shape) != (3, 3):
        raise ValueError(f"push_cuda: pose must be 3x3, got {tuple(pose.shape)}")
    if tuple(data.shape) != (geom.size,) or tuple(mask.shape) != (geom.size,):
        raise ValueError(f"push_cuda: data and mask must be ({geom.size},)")


def launch(grid: TsdGrid, geom: SensorPolar2D, pose: torch.Tensor,
           data: torch.Tensor, mask: torch.Tensor, out: TsdGrid,
           cull: Optional[torch.Tensor] = None, ty0: int = 0,
           gate: Optional[torch.Tensor] = None) -> None:
    """Launch the kernel on the current stream: reads `grid` and the scan
    (float32 data, bool mask, float32 3x3 pose, all contiguous and on the
    card) and writes the four arrays of `out`, a grid of the same shapes
    that shares no memory with `grid`.  `cull`, float32 [TY, TX, 3], takes
    the cull's decisions (touch, empty_inc as 0/1 after the gate,
    part_weight) for a check against grid/push.py::tile_cull.  `ty0` as in
    push_cuda; `gate` None or a contiguous uint8 [TY, TX] tile gate.
    Raises if the launch is refused; counts it in push_cuda.launches."""
    lib = _lib()
    p, s = grid.tile_dim, grid.cell_size
    with torch.cuda.device(grid.tsd.device):
        stream = torch.cuda.current_stream(grid.tsd.device).cuda_stream
        # the float parameters are the Python numbers the plain version
        # computes with; ctypes rounds each to float32 as torch does
        err = lib.tsd_push_f32(
            grid.tsd.data_ptr(), grid.weight.data_ptr(),
            grid.tile_init.data_ptr(), grid.tile_initw.data_ptr(),
            data.data_ptr(), mask.data_ptr(), pose.data_ptr(),
            None if gate is None else gate.data_ptr(),
            out.tsd.data_ptr(), out.weight.data_ptr(),
            out.tile_init.data_ptr(), out.tile_initw.data_ptr(),
            None if cull is None else cull.data_ptr(),
            grid.cells_y, grid.cells_x, p, geom.size, ty0,
            s, p * s, math.sqrt(2.0) * (p * s) * 0.5, grid.max_truncation,
            grid.max_weight, geom.phi_min, geom.angular_res,
            geom.phi_lower_bound, geom.phi_upper_bound, geom.max_range,
            geom.min_range, geom.low_reflectivity_range, stream)
    if err != 0:
        raise RuntimeError(f"tsd_push_f32 launch failed: cudaError {err}")
    push_cuda.launches += 1


def empty_like(grid: TsdGrid) -> TsdGrid:
    """Uninitialized arrays for a push's result."""
    return dataclasses.replace(
        grid, tsd=torch.empty_like(grid.tsd),
        weight=torch.empty_like(grid.weight),
        tile_init=torch.empty_like(grid.tile_init),
        tile_initw=torch.empty_like(grid.tile_initw))


def push_cuda(grid: TsdGrid, geom: SensorPolar2D, pose: torch.Tensor,
              data: torch.Tensor, mask: torch.Tensor,
              tile_gate: Optional[torch.Tensor] = None,
              cull: Optional[torch.Tensor] = None, ty0: int = 0) -> TsdGrid:
    """Fuse one masked polar scan into the grid; same contract as
    grid/push.py::push, whose `tile_gate` (a [TY, TX] bool mask of the
    tiles that may take part) and `ty0` (the world tile row of a row
    block's first tile row) it takes.  CUDA grids must be float32.  `cull`
    as in `launch` (CUDA grids only)."""
    if not grid.tsd.is_cuda:
        if cull is not None:
            raise ValueError("push_cuda: only the kernel writes `cull`")
        return push(grid, geom, pose, data, mask, tile_gate=tile_gate,
                    ty0=ty0)
    _check(grid, geom, pose, data, mask)
    if tile_gate is not None and (
            tile_gate.device != grid.tsd.device
            or tile_gate.dtype != torch.bool
            or tuple(tile_gate.shape) != (grid.tiles_y, grid.tiles_x)):
        raise TypeError("push_cuda: tile_gate must be a bool "
                        f"[{grid.tiles_y}, {grid.tiles_x}] tensor on "
                        f"{grid.tsd.device}")
    if cull is not None and (
            cull.device != grid.tsd.device or cull.dtype != torch.float32
            or tuple(cull.shape) != (grid.tiles_y, grid.tiles_x, 3)
            or not cull.is_contiguous()):
        raise TypeError("push_cuda: cull must be a contiguous float32 "
                        f"[{grid.tiles_y}, {grid.tiles_x}, 3] tensor on "
                        f"{grid.tsd.device}")
    # no copies where the caller's tensors are float32 and contiguous
    pose = pose.to(torch.float32).contiguous()
    data = data.to(torch.float32).contiguous()
    gate = (None if tile_gate is None
            else tile_gate.to(torch.uint8).contiguous())
    out = empty_like(grid)
    launch(grid, geom, pose, data, mask.contiguous(), out, cull, ty0, gate)
    return out


push_cuda.launches = 0
