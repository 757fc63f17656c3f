"""Bilinear TSD interpolation and surface normals (port of
ohm_tsd_slam_tpu/grid/interpolate.py).

Vectorized TsdGrid::interpolateBilinear / coord2Cell (TsdGrid.h:284-340)
and TsdGrid::interpolateNormal (TsdGrid.cpp:517-546).  Functions take
query coordinates with any leading batch dimensions and return (value,
code) pairs with the reference's EnumTsdGridInterpolate codes.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ohm_tsd_slam_tpu_torch.grid.state import (
    INTERPOLATE_EMPTYPARTITION,
    INTERPOLATE_INVALIDINDEX,
    INTERPOLATE_ISNAN,
    INTERPOLATE_SUCCESS,
    TsdGrid,
)


def coord2cell(grid: TsdGrid, coords: torch.Tensor):
    """TsdGrid::coord2Cell (TsdGrid.h:306-340): base cell
    floor(coord/s - 0.5) (the one whose center lies at or below the query)
    and the fractional weights from its center.

    Returns (ix, iy, wx, wy, valid); indices are int64.  A NaN coordinate
    gives an index outside the grid, hence valid=False.
    """
    s = grid.cell_size
    u = coords[..., 0] / s - 0.5
    v = coords[..., 1] / s - 0.5
    ix = torch.floor(u).to(torch.int64)
    iy = torch.floor(v).to(torch.int64)
    wx = u - ix.to(u.dtype)
    wy = v - iy.to(v.dtype)
    # reference bounds check (TsdGrid.h:332) admits xIdx == cellsX-1,
    # whose +1 tap reads the never-propagated outer halo => NaN (_tap)
    valid = (ix >= 0) & (ix < grid.cells_x) & (iy >= 0) & (iy < grid.cells_y)
    return ix, iy, wx, wy, valid


def _tap(grid: TsdGrid, ix: torch.Tensor, iy: torch.Tensor) -> torch.Tensor:
    """tsd[iy, ix], NaN outside the grid (the outer halo)."""
    oob = (ix < 0) | (ix >= grid.cells_x) | (iy < 0) | (iy >= grid.cells_y)
    ixc = ix.clamp(0, grid.cells_x - 1)
    iyc = iy.clamp(0, grid.cells_y - 1)
    val = grid.tsd.reshape(-1)[iyc * grid.cells_x + ixc]
    return torch.where(oob, math.nan, val)


def interpolate_bilinear(grid: TsdGrid, coords: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """TsdGrid::interpolateBilinear (TsdGrid.h:284-304).

    Args:
      coords: (..., 2) world coordinates.
    Returns:
      (tsd, code): interpolated TSD (NaN on failure) and the
      EnumTsdGridInterpolate code (int64) per query.
    """
    ix, iy, wx, wy, valid = coord2cell(grid, coords)

    # the owning tile of the base cell decides EMPTYPARTITION (TsdGrid.h:293)
    td = grid.tile_dim
    txc = torch.div(ix, td, rounding_mode="floor").clamp(0, grid.tiles_x - 1)
    tyc = torch.div(iy, td, rounding_mode="floor").clamp(0, grid.tiles_y - 1)
    tile_ok = grid.tile_init.reshape(-1)[tyc * grid.tiles_x + txc]

    v00 = _tap(grid, ix, iy)
    v10 = _tap(grid, ix, iy + 1)
    v01 = _tap(grid, ix + 1, iy)
    v11 = _tap(grid, ix + 1, iy + 1)
    # exact tap order and weights of TsdGridPartition::interpolateBilinear
    # (TsdGridPartition.h:214-221)
    tsd = (v00 * (1.0 - wy) * (1.0 - wx)
           + v10 * wy * (1.0 - wx)
           + v01 * (1.0 - wy) * wx
           + v11 * wy * wx)

    code = torch.where(torch.isnan(tsd), INTERPOLATE_ISNAN,
                       INTERPOLATE_SUCCESS)
    code = torch.where(tile_ok, code, INTERPOLATE_EMPTYPARTITION)
    code = torch.where(valid, code, INTERPOLATE_INVALIDINDEX)
    tsd = torch.where(code == INTERPOLATE_SUCCESS, tsd, math.nan)
    return tsd, code


def interpolate_normal(grid: TsdGrid, coords: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """TsdGrid::interpolateNormal (TsdGrid.cpp:517-546): central
    differences of bilinear taps at ±cellSize, normalized.

    Returns (normals (..., 2), ok mask); normals are NaN where not ok.
    """
    s = grid.cell_size
    ex = torch.zeros_like(coords)
    ex[..., 0] = s
    ey = torch.zeros_like(coords)
    ey[..., 1] = s

    xp, cxp = interpolate_bilinear(grid, coords + ex)
    xm, cxm = interpolate_bilinear(grid, coords - ex)
    yp, cyp = interpolate_bilinear(grid, coords + ey)
    ym, cym = interpolate_bilinear(grid, coords - ey)

    ok = ((cxp == INTERPOLATE_SUCCESS) & (cxm == INTERPOLATE_SUCCESS)
          & (cyp == INTERPOLATE_SUCCESS) & (cym == INTERPOLATE_SUCCESS))

    n = torch.stack([xp - xm, yp - ym], dim=-1)
    norm = torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True))
    n = n / torch.where(norm > 0, norm, 1.0)
    n = torch.where(ok[..., None], n, math.nan)
    return n, ok
