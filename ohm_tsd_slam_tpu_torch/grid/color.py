"""RGB visualization of the TSD field (port of
ohm_tsd_slam_tpu/grid/color.py).

TsdGrid::grid2ColorImage (TsdGrid.cpp:429-488): green ramp for positive
TSD, red ramp for negative, white for empty-unmaterialized tiles, black
for unknown.
"""

from __future__ import annotations

import math

import torch

from ohm_tsd_slam_tpu_torch.grid.state import TsdGrid
from ohm_tsd_slam_tpu_torch.utils.compiled import compiled


def grid_to_color_image(grid: TsdGrid, width: int = None,
                        height: int = None) -> torch.Tensor:
    """Returns [height, width, 3] uint8.

    The reference samples at (w·maxX/width, h·maxY/height) through
    coord2Cell's base-cell convention and reads the raw cell value
    (TsdGrid.cpp:446-456).
    """
    if width is None:
        width = grid.cells_x
    if height is None:
        height = grid.cells_y
    s = grid.cell_size
    dtype = grid.tsd.dtype
    dev = grid.tsd.device
    td = grid.tile_dim

    px = torch.arange(width, dtype=dtype, device=dev) * (grid.max_x / width)
    py = torch.arange(height, dtype=dtype, device=dev) * (grid.max_y / height)

    # coord2Cell base index (TsdGrid.h:306-340)
    ix = torch.floor(px / s - 0.5).to(torch.int64)
    iy = torch.floor(py / s - 0.5).to(torch.int64)
    valid = (((ix >= 0) & (ix < grid.cells_x))[None, :]
             & ((iy >= 0) & (iy < grid.cells_y))[:, None])
    ixc = ix.clamp(0, grid.cells_x - 1)
    iyc = iy.clamp(0, grid.cells_y - 1)

    ty = (iyc // td)[:, None]
    tx = (ixc // td)[None, :]
    cell_init = grid.tile_init[ty, tx]
    cell_empty = (~grid.tile_init & (grid.tile_initw > 0.0))[ty, tx]
    tsd = grid.tsd[iyc[:, None], ixc[None, :]]
    tsd = torch.where(valid & cell_init, tsd, math.nan)
    is_empty = valid & cell_empty

    pos = tsd > 0.0
    neg = tsd < 0.0
    # ramps are only read where their sign test holds; zeroing the other
    # cells first keeps every float -> uint8 conversion in range
    ramp_pos = (torch.where(pos, tsd, 0.0) * 255.0).to(torch.uint8)
    ramp_neg = ((1.0 + torch.where(neg, tsd, 0.0)) * 255.0).to(torch.uint8)
    other = torch.where(is_empty, 255, 0).to(torch.uint8)

    r = torch.where(pos, ramp_pos, torch.where(neg, ramp_neg, other))
    g = torch.where(pos, 255, torch.where(neg, 0, other))
    b = torch.where(pos, ramp_pos, torch.where(neg, 0, other))
    return torch.stack([r, g, b], dim=-1).to(torch.uint8)


_color_graph = compiled(grid_to_color_image,
                        static_argnames=("width", "height"))


def grid_to_color_image_jit(grid: TsdGrid, width: int = None,
                            height: int = None) -> torch.Tensor:
    """grid_to_color_image, compiled (ohm_tsd_slam_tpu/grid/color.py::
    grid_to_color_image_jit, `width` and `height` static): one graph a key
    on the card, the eager function on the CPU; the publisher calls it."""
    return _color_graph(grid, width, height)


grid_to_color_image_jit.compiled = _color_graph
