"""Axis-aligned surface extraction → occupancy grid (port of
ohm_tsd_slam_tpu/grid/axis_aligned.py::occupancy_grid and
::surface_points).

RayCastAxisAligned2D::calcCoords (RayCastAxisAligned2D.cpp:13-105) plus
the occupancy assembly of ThreadGrid::eventLoop (ThreadGrid.cpp:72-133),
evaluated as dense [H, W] comparisons of adjacent cells.  The reference's
halo semantics are replicated exactly, as in the JAX package (see its
module docstring for the derivation):

  * a tile's halo holds its right/up neighbour's first row/col iff both
    tiles are initialized, which dense adjacency reproduces;
  * the px==P / py==P halo writes of a scanning tile spill into the first
    row/col of the next tile, visible where that tile writes nothing;
  * crossings on a tile-boundary row/col are found by both adjacent
    scanning tiles, and by the up/left tile alone when the own tile is
    outside the interior ring;
  * the half-cell-offset crossing coordinates
    (RayCastAxisAligned2D.cpp:54-55) are kept so occupancy indices match.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ohm_tsd_slam_tpu_torch.grid.state import TsdGrid, expand_tiles
from ohm_tsd_slam_tpu_torch.utils.compiled import compiled


class OccupancyResult(NamedTuple):
    occupancy: torch.Tensor  # [H, W] int8: -1 unknown, 0 free, 100 occupied
    n_surface: torch.Tensor  # surface crossings found (with the reference's
    #                          boundary duplicates)


def _interior_tile_mask(grid: TsdGrid) -> torch.Tensor:
    """Tiles outside the outer ring (RayCastAxisAligned2D.cpp:25-27)."""
    dev = grid.tile_init.device
    ty = torch.arange(grid.tiles_y, device=dev)
    tx = torch.arange(grid.tiles_x, device=dev)
    ok_y = (ty >= 1) & (ty <= grid.tiles_y - 2)
    ok_x = (tx >= 1) & (tx <= grid.tiles_x - 2)
    return ok_y[:, None] & ok_x[None, :]


def _shift_tiles(tiles: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """tiles moved by (dy, dx) >= 0, zero-filled (no wrap-around)."""
    dev = tiles.device
    rows = torch.arange(tiles.shape[0], device=dev)[:, None] >= dy
    cols = torch.arange(tiles.shape[1], device=dev)[None, :] >= dx
    return torch.roll(tiles, (dy, dx), (0, 1)) & rows & cols


def _crossings(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a > 0) & (b < 0)) | ((a < 0) & (b > 0))


def _scans(grid: TsdGrid):
    """The scanning tiles (initialized interior ones) and the cells each
    scan covers: (ii [TY, TX], cell_ii, row0, col0, spill_down,
    spill_right), the last two being the first row (col) of the tile
    below (right of) a scanning tile, which its halo scan reaches."""
    p = grid.tile_dim
    dev = grid.tsd.device
    H, W = grid.tsd.shape
    ii = _interior_tile_mask(grid) & grid.tile_init
    hh = torch.arange(H, device=dev)
    ww = torch.arange(W, device=dev)
    row0 = ((hh % p == 0) & (hh >= p))[:, None]
    col0 = ((ww % p == 0) & (ww >= p))[None, :]
    spill_down = row0 & expand_tiles(grid, _shift_tiles(ii, 1, 0))
    spill_right = col0 & expand_tiles(grid, _shift_tiles(ii, 0, 1))
    return ii, expand_tiles(grid, ii), row0, col0, spill_down, spill_right


def occupancy_grid(grid: TsdGrid, use_inflation: bool = False,
                   inflation_factor: int = 2) -> OccupancyResult:
    """Extract the occupancy grid.

    free/unknown: cells of initialized interior tiles are 0 where tsd > 0
    else -1 (RayCastAxisAligned2D.cpp:42-49); cells of interior
    empty-but-unmaterialized tiles are 0 (:87-101); first-row/col cells of
    tiles right/down/diagonal of a scanning tile get the halo spill.

    occupied: TSD zero crossings along rows and columns, sub-cell
    interpolated, stamped at round(x/cellSize) with u,v in (0, W)x(0, H)
    (ThreadGrid.cpp:96-118).
    """
    tsd = grid.tsd
    H, W = tsd.shape
    dev = tsd.device
    ii, cell_ii, row0, col0, spill_down, spill_right = _scans(grid)

    def cells(tiles):
        return expand_tiles(grid, tiles)

    cell_init = cells(grid.tile_init)
    cell_empty = cells(~grid.tile_init & (grid.tile_initw > 0.0)
                       & _interior_tile_mask(grid))
    spill = spill_down | spill_right | (row0 & col0
                                        & cells(_shift_tiles(ii, 1, 1)))

    # every written-but-not-free cell is -1 like an unwritten one
    free = ((cell_ii | spill) & cell_init & (tsd > 0.0)) | cell_empty
    occ = torch.where(free, 0, -1).to(torch.int8)

    # ---- surface crossings ----------------------------------------------
    # horizontal pairs (gy, gx-1) -> (gy, gx), scanned by the tile owning
    # the first cell, plus the up tile's duplicate on tile-boundary rows
    a = tsd[:, :-1]
    b = tsd[:, 1:]
    hcross = _crossings(a, b)
    h_own = hcross & cell_ii[:, :-1]
    h_dup = hcross & spill_down[:, :-1]
    hmask = h_own | h_dup
    # x = (gx-1 + interp)·s (the reference's half-cell quirk), u = round(x/s)
    gx = torch.arange(1, W, dtype=tsd.dtype, device=dev)
    hu = torch.floor(gx[None, :] - 1.0 + a / (a - b) + 0.5).to(torch.int64)
    hv = torch.arange(H, device=dev)[:, None].expand(hu.shape)

    # vertical pairs (gy-1, gx) -> (gy, gx)
    a2 = tsd[:-1, :]
    b2 = tsd[1:, :]
    vcross = _crossings(a2, b2)
    v_own = vcross & cell_ii[:-1, :]
    v_dup = vcross & spill_right[:-1, :]
    vmask = v_own | v_dup
    gy = torch.arange(1, H, dtype=tsd.dtype, device=dev)
    vv = torch.floor(gy[:, None] - 1.0 + a2 / (a2 - b2) + 0.5).to(torch.int64)
    vu = torch.arange(W, device=dev)[None, :].expand(vv.shape)

    hits = torch.zeros(H * W, dtype=torch.int32, device=dev)
    for u, v, m in ((hu, hv, hmask), (vu, vv, vmask)):
        ok = m & (u > 0) & (u < W) & (v > 0) & (v < H)
        flat = v.clamp(0, H - 1) * W + u.clamp(0, W - 1)
        hits.index_put_((flat.reshape(-1),), ok.reshape(-1).to(torch.int32),
                        accumulate=True)
    occupied = (hits > 0).reshape(H, W)

    if use_inflation and inflation_factor > 0:
        # ThreadGrid.cpp:105-114: window [v-f, v+f) x [u-f, u+f)
        f = inflation_factor
        base = occupied
        for dy in range(-f, f):
            for dx in range(-f, f):
                occupied = occupied | torch.roll(base, (dy, dx), (0, 1))

    occ = torch.where(occupied, 100, occ).to(torch.int8)
    n = h_own.sum() + h_dup.sum() + v_own.sum() + v_dup.sum()
    return OccupancyResult(occ, n)


_occupancy_graph = compiled(occupancy_grid,
                            static_argnames=("use_inflation",
                                             "inflation_factor"))


def occupancy_grid_jit(grid: TsdGrid, use_inflation: bool = False,
                       inflation_factor: int = 2) -> OccupancyResult:
    """occupancy_grid, compiled (ohm_tsd_slam_tpu/grid/axis_aligned.py::
    occupancy_grid_jit, `use_inflation` and `inflation_factor` static):
    one graph a key on the card, the eager function on the CPU; the
    publisher (slam/grid_pub.py) calls it."""
    return _occupancy_graph(grid, use_inflation, inflation_factor)


occupancy_grid_jit.compiled = _occupancy_graph


def surface_points(grid: TsdGrid) -> Tuple[torch.Tensor, torch.Tensor]:
    """The crossing coordinates themselves (the reference's coords list,
    its duplicates included) as a fixed-size masked array: points
    [H·(W−1) + (H−1)·W, 2] (the row pairs, then the column pairs, each
    row-major) and their mask.

    Coordinates replicate RayCastAxisAligned2D.cpp:52-55 / 75-78:
    x = (gx-1+interp)·s for row scans (y = gy·s), and the transpose for
    column scans; interp = a / (a − b), in the JAX package's order."""
    tsd = grid.tsd
    H, W = tsd.shape
    s = grid.cell_size
    dev = tsd.device
    _, cell_ii, _, _, spill_down, spill_right = _scans(grid)

    # row pairs (gy, gx-1) -> (gy, gx); the up tile's duplicate scan on
    # tile-boundary rows
    a = tsd[:, :-1]
    b = tsd[:, 1:]
    hmask = _crossings(a, b) & (cell_ii | spill_down)[:, :-1]
    gx = torch.arange(1, W, dtype=tsd.dtype, device=dev)
    hx = (gx[None, :] - 1.0 + a / (a - b)) * s
    hy = (torch.arange(H, dtype=tsd.dtype, device=dev)[:, None] * s
          ).expand(hx.shape)

    # column pairs (gy-1, gx) -> (gy, gx)
    a2 = tsd[:-1, :]
    b2 = tsd[1:, :]
    vmask = _crossings(a2, b2) & (cell_ii | spill_right)[:-1, :]
    gy = torch.arange(1, H, dtype=tsd.dtype, device=dev)
    vy = (gy[:, None] - 1.0 + a2 / (a2 - b2)) * s
    vx = (torch.arange(W, dtype=tsd.dtype, device=dev)[None, :] * s
          ).expand(vy.shape)

    pts = torch.cat([torch.stack([hx.reshape(-1), hy.reshape(-1)], -1),
                     torch.stack([vx.reshape(-1), vy.reshape(-1)], -1)])
    return pts, torch.cat([hmask.reshape(-1), vmask.reshape(-1)])
