"""TSD grid state (port of ohm_tsd_slam_tpu/grid/state.py).

The field is a dense [H, W] pair of tensors (tsd, weight) plus small
[TY, TX] per-tile bookkeeping arrays, as in the JAX package: dense
adjacency replaces the reference's partition halos
(TsdGrid::propagateBorders, TsdGrid.cpp:372-427).  A grid is a value:
every update returns a new TsdGrid and never writes into the tensors of
the one it was given, so a reader holding an older grid keeps a
consistent map while a writer builds the next one.

* Cell (ix, iy) has its center at ((ix+0.5)s, (iy+0.5)s)
  (TsdGridPartition.cpp:121-131); tensors are indexed [iy, ix].
* NaN tsd marks an unwritten cell; cells of never-initialized tiles are
  NaN as well, so taps into them read NaN (the documented divergence of
  the JAX package, kept as is).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from ohm_tsd_slam_tpu_torch.config import GridConfig
from ohm_tsd_slam_tpu_torch.utils.device import default_device

# Interpolation return codes (EnumTsdGridInterpolate, TsdGrid.h:28-35)
INTERPOLATE_SUCCESS = 0
INTERPOLATE_INVALIDINDEX = 1
INTERPOLATE_EMPTYPARTITION = 2
INTERPOLATE_ISNAN = 3

TSDINC = 1.0  # reconstruct_defs.h:6

_ARRAY_FIELDS = ("tsd", "weight", "tile_init", "tile_initw")
_STATIC_FIELDS = ("cell_size", "max_truncation", "max_weight", "tile_dim")


@dataclass(frozen=True)
class TsdGrid:
    """The TSD field.

    Attributes:
      tsd:        [H, W] truncated signed distance; NaN = unwritten cell.
      weight:     [H, W] fusion weight.
      tile_init:  [TY, TX] bool — tile has been materialized.
      tile_initw: [TY, TX] "emptiness" weight accumulated before
                  materialization (isEmpty == !init && initw > 0).
      cell_size, max_truncation, max_weight, tile_dim: static geometry.
    """

    tsd: torch.Tensor
    weight: torch.Tensor
    tile_init: torch.Tensor
    tile_initw: torch.Tensor
    cell_size: float
    max_truncation: float
    max_weight: float
    tile_dim: int

    @property
    def cells_y(self) -> int:
        return self.tsd.shape[0]

    @property
    def cells_x(self) -> int:
        return self.tsd.shape[1]

    @property
    def tiles_y(self) -> int:
        return self.tile_init.shape[0]

    @property
    def tiles_x(self) -> int:
        return self.tile_init.shape[1]

    @property
    def min_x(self) -> float:
        return 0.0

    @property
    def max_x(self) -> float:
        return self.cells_x * self.cell_size

    @property
    def min_y(self) -> float:
        return 0.0

    @property
    def max_y(self) -> float:
        return self.cells_y * self.cell_size

    def centroid(self) -> tuple:
        # TsdGrid::getCentroid (TsdGrid.cpp:200-204)
        return (0.5 * (self.min_x + self.max_x),
                0.5 * (self.min_y + self.max_y))

    def is_inside(self, position: torch.Tensor) -> torch.Tensor:
        """TsdGrid::isInsideGrid (TsdGrid.h:342-347)."""
        x, y = position[0], position[1]
        return ((x > self.min_x) & (x < self.max_x)
                & (y > self.min_y) & (y < self.max_y))


def create(config: GridConfig, dtype=torch.float32, device=None) -> TsdGrid:
    """Allocate an all-uninitialized grid (TsdGrid::init,
    TsdGrid.cpp:112-169) on `device`: None is the card
    (utils/device.py::default_device)."""
    device = default_device(device, "create")
    h = w = config.cells_per_side
    ty = tx = config.tiles_per_side
    return TsdGrid(
        tsd=torch.full((h, w), math.nan, dtype=dtype, device=device),
        weight=torch.zeros((h, w), dtype=dtype, device=device),
        tile_init=torch.zeros((ty, tx), dtype=torch.bool, device=device),
        tile_initw=torch.zeros((ty, tx), dtype=dtype, device=device),
        cell_size=float(config.cellsize),
        max_truncation=float(config.max_truncation),
        max_weight=float(config.max_weight),
        tile_dim=int(config.tile_dim),
    )


def cell_centers(grid: TsdGrid, dtype=None, row0: int = 0):
    """World coordinates of all cell centers: x[W], y[H]; the grid's
    first row is world row `row0` (a row block of a larger grid; the
    integer offset is added before the conversion to `dtype`)."""
    if dtype is None:
        dtype = grid.tsd.dtype
    s = grid.cell_size
    dev = grid.tsd.device
    xs = (torch.arange(grid.cells_x, dtype=dtype, device=dev) + 0.5) * s
    ys = (torch.arange(row0, row0 + grid.cells_y, device=dev).to(dtype)
          + 0.5) * s
    return xs, ys


def tile_of_cell(grid: TsdGrid, ix, iy):
    """The (tile row, tile column) of cell (ix, iy)."""
    return iy // grid.tile_dim, ix // grid.tile_dim


def expand_tiles(grid: TsdGrid, tile_arr: torch.Tensor) -> torch.Tensor:
    """Broadcast a [TY, TX] per-tile array to [H, W] cells."""
    p = grid.tile_dim
    return tile_arr.repeat_interleave(p, 0).repeat_interleave(p, 1)


def free_footprint(grid: TsdGrid, center, width: float,
                   height: float) -> TsdGrid:
    """TsdGrid::freeFootprint (TsdGrid.cpp:609-638): write TSDINC into a
    rectangle of cells around `center` (host floats), materializing the
    touched tiles.  Index arithmetic replicates the reference's
    `coord/s + 0.5` rounding; out-of-bounds rectangles change nothing."""
    s = grid.cell_size
    cx, cy = float(center[0]), float(center[1])
    min_x = math.floor((cx - width * 0.5) / s + 0.5)
    max_x = math.floor((cx + width * 0.5) / s + 0.5)
    min_y = math.floor((cy - height * 0.5) / s + 0.5)
    max_y = math.floor((cy + height * 0.5) / s + 0.5)
    if not (min_x >= 0 and max_x <= grid.cells_x
            and min_y >= 0 and max_y <= grid.cells_y):
        return grid

    dev = grid.tsd.device
    ix = torch.arange(grid.cells_x, device=dev)
    iy = torch.arange(grid.cells_y, device=dev)
    in_rect = (((iy >= min_y) & (iy < max_y))[:, None]
               & ((ix >= min_x) & (ix < max_x))[None, :])

    # touched tiles get materialized; cells of tiles that were "empty"
    # take their init value first (TsdGridPartition::init)
    td = grid.tile_dim
    tile_touched = in_rect.reshape(grid.tiles_y, td, grid.tiles_x,
                                   td).any(dim=3).any(dim=1)
    newly_init = tile_touched & ~grid.tile_init
    was_empty = newly_init & (grid.tile_initw > 0.0)
    cell_newly_empty = expand_tiles(grid, was_empty)
    cell_initw = expand_tiles(grid, grid.tile_initw)

    tsd = torch.where(cell_newly_empty, TSDINC, grid.tsd)
    weight = torch.where(cell_newly_empty, cell_initw, grid.weight)
    tsd = torch.where(in_rect, TSDINC, tsd)
    # tile_initw is kept: the reference never resets _initWeight on init
    return dataclasses.replace(grid, tsd=tsd, weight=weight,
                               tile_init=grid.tile_init | tile_touched)


def to_arrays(grid: TsdGrid) -> Dict[str, object]:
    """The grid as a dict of numpy arrays plus its four static fields —
    the state both packages can load (see from_arrays)."""
    out: Dict[str, object] = {f: getattr(grid, f).cpu().numpy()
                              for f in _ARRAY_FIELDS}
    out.update({f: getattr(grid, f) for f in _STATIC_FIELDS})
    return out


def from_arrays(d: Dict[str, object], device=None) -> TsdGrid:
    """Build a TsdGrid from `to_arrays`' dict (or from the same fields of
    a JAX grid, read with np.asarray).  Floating arrays keep their dtype."""
    arrays = {f: torch.from_numpy(np.array(d[f])).to(device)
              for f in _ARRAY_FIELDS}
    arrays["tile_init"] = arrays["tile_init"].to(torch.bool)
    return TsdGrid(**arrays,
                   cell_size=float(d["cell_size"]),
                   max_truncation=float(d["max_truncation"]),
                   max_weight=float(d["max_weight"]),
                   tile_dim=int(d["tile_dim"]))
