"""TSD fusion push on the card: the wrapper of csrc/push.cu.

Replaces the TPU kernel ohm_tsd_slam_tpu/ops/push_pallas.py::push_pallas.
As there, the per-tile cull (grid/push.py::tile_cull), the tile meta stack
and the tile_init / tile_initw updates stay plain torch on the device, and
the kernel does the per-cell work of the touched and empty-on-init tiles.
The kernel is bound by bytes (see the note in csrc/push.cu).

The grid stays a value: the wrapper clones tsd and weight, the kernel
updates the clones in place, and a new TsdGrid is returned, so a reader of
the old grid (the threaded node's localizer) is never written under.  The
cost is one copy of the two [H, W] arrays per push.

For a grid on the CPU the wrapper runs the plain version, grid/push.py::
push.  For a grid on CUDA it launches the kernel or raises; `launches`
counts the launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from ohm_tsd_slam_tpu_torch.grid.push import next_tile_initw, push, tile_cull
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
        fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                       _F, _F, _F, _F, _F, _F, _F, _F, _P]
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


def tile_meta(grid: TsdGrid, geom: SensorPolar2D, pose: torch.Tensor,
              data: torch.Tensor, mask: torch.Tensor):
    """The kernel's inputs besides the grid: the per-tile cull and meta
    stack [TY, TX, 6] (channel order of csrc/push.cu) and the beam table
    (NaN = masked beam).  Returns (touch, empty_inc, meta, table)."""
    f32 = torch.float32
    touch, empty_inc, part_weight = tile_cull(grid, geom, pose, data, mask)
    newly_init = touch & ~grid.tile_init
    was_empty = newly_init & (grid.tile_initw > 0.0)
    meta = torch.stack([t.to(f32) for t in (
        touch,
        empty_inc & grid.tile_init,
        newly_init & ~was_empty,
        was_empty,
        grid.tile_initw,
        part_weight,
    )], dim=-1)
    table = torch.where(mask, data, math.nan).to(f32).contiguous()
    return touch, empty_inc, meta, table


def launch(grid: TsdGrid, geom: SensorPolar2D, tsd: torch.Tensor,
           weight: torch.Tensor, table: torch.Tensor, meta: torch.Tensor,
           pose: torch.Tensor) -> None:
    """Launch the kernel on the current stream: updates tsd and weight
    (float32 [H, W], contiguous, on the card) in place.  Raises if the
    launch is refused; counts it in push_cuda.launches."""
    lib = _lib()
    with torch.cuda.device(tsd.device):
        stream = torch.cuda.current_stream(tsd.device).cuda_stream
        err = lib.tsd_push_f32(
            tsd.data_ptr(), weight.data_ptr(), table.data_ptr(),
            meta.data_ptr(), pose.data_ptr(),
            grid.cells_y, grid.cells_x, grid.tile_dim, geom.size,
            grid.cell_size, grid.max_truncation, grid.max_weight,
            geom.phi_min, geom.angular_res, geom.phi_lower_bound,
            geom.phi_upper_bound, geom.low_reflectivity_range, stream)
    if err != 0:
        raise RuntimeError(f"tsd_push_f32 launch failed: cudaError {err}")
    push_cuda.launches += 1


def push_cuda(grid: TsdGrid, geom: SensorPolar2D, pose: torch.Tensor,
              data: torch.Tensor, mask: torch.Tensor) -> TsdGrid:
    """Fuse one masked polar scan into the grid; same contract as
    grid/push.py::push.  CUDA grids must be float32."""
    if not grid.tsd.is_cuda:
        return push(grid, geom, pose, data, mask)
    _check(grid, geom, pose, data, mask)
    pose = pose.to(torch.float32).contiguous()
    touch, empty_inc, meta, table = tile_meta(grid, geom, pose, data, mask)
    tsd = grid.tsd.clone()
    weight = grid.weight.clone()
    launch(grid, geom, tsd, weight, table, meta, pose)
    return dataclasses.replace(
        grid, tsd=tsd, weight=weight,
        tile_init=grid.tile_init | touch,
        tile_initw=next_tile_initw(grid, empty_inc))


push_cuda.launches = 0
