"""Scan fusion: push a polar scan into the TSD grid — the plain version
(port of ohm_tsd_slam_tpu/grid/push.py::tile_cull and ::push).

TsdGrid::push (TsdGrid.cpp:217-284) with TsdGridComponent::isInRange
culling (TsdGridComponent.cpp:43-124) and TsdGridPartition::addTsd /
increaseEmptiness (TsdGridPartition.h:170-212, .cpp:136-164), evaluated
over the whole grid as dense [H, W] tensors:

  1. per-tile culling masks on [TY, TX] tensors (tile_cull),
  2. per-cell beam index by back-projection (atan2 over cell centers),
  3. the addTsd weighted running average, gated by the tile masks,
  4. increaseEmptiness for fully traversed tiles.

This is the reference for the CUDA kernel (ops/push_cuda.py), which
takes step 1's decisions per tile itself (tile_cull is their twin) and
computes the per-cell steps 2-4 only for the tiles it selects.  The main
path runs this version only for a grid on the CPU.  `push_jit` and
`push_tree_jit` are the kernel route compiled (a CUDA graph a key).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ohm_tsd_slam_tpu_torch.core import se2
from ohm_tsd_slam_tpu_torch.grid.state import (
    TSDINC,
    TsdGrid,
    cell_centers,
    expand_tiles,
)
from ohm_tsd_slam_tpu_torch.sensor.polar2d import SensorPolar2D, back_project
from ohm_tsd_slam_tpu_torch.utils.compiled import compiled


def _tile_rows(grid: TsdGrid, dtype, ty0: int) -> torch.Tensor:
    """The world tile-row index of each of the grid's tile rows, the
    first being ty0 (a row block of a larger grid): the integer offset is
    added before the conversion to `dtype`, so a block's values are the
    larger grid's in every bit."""
    return torch.arange(ty0, ty0 + grid.tiles_y, device=grid.tsd.device
                        ).to(dtype)


def _tile_edges(grid: TsdGrid, dtype, ty0: int = 0) -> torch.Tensor:
    """Corner coordinates of every tile, [TY, TX, 4, 2]: the cell centers
    of the corner cells (TsdGridPartition.cpp:48-63)."""
    p = grid.tile_dim
    s = grid.cell_size
    dev = grid.tsd.device
    tx0 = (torch.arange(grid.tiles_x, dtype=dtype, device=dev) * p + 0.5) * s
    ty0 = (_tile_rows(grid, dtype, ty0) * p + 0.5) * s
    txe = tx0 + p * s
    tye = ty0 + p * s
    shape = (grid.tiles_y, grid.tiles_x)
    ex = torch.stack([a[None, :].expand(shape)
                      for a in (tx0, txe, tx0, txe)], dim=-1)
    ey = torch.stack([a[:, None].expand(shape)
                      for a in (ty0, ty0, tye, tye)], dim=-1)
    return torch.stack([ex, ey], dim=-1)


def tile_cull(grid: TsdGrid, geom: SensorPolar2D, pose: torch.Tensor,
              data: torch.Tensor, mask: torch.Tensor, ty0: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Vectorized TsdGridComponent::isInRange over all tiles; for a row
    block of a larger grid whose first tile row is ty0, over its tiles.

    Returns:
      touch:       [TY, TX] tile takes part in the fusion update
      empty_inc:   [TY, TX] tile is fully traversed -> increaseEmptiness
      part_weight: [TY, TX] ((maxRange - distCentroid)/maxRange)^2
                   (TsdGrid.cpp:239-243)
    """
    dtype = grid.tsd.dtype
    dev = grid.tsd.device
    p = grid.tile_dim
    s = grid.cell_size
    tr = se2.translation(pose).to(dtype)

    # tile centroid/circumradius (TsdGridPartition.cpp:65-70)
    cx = (torch.arange(grid.tiles_x, dtype=dtype, device=dev) * p
          + (p + 1) * 0.5) * s
    cy = (_tile_rows(grid, dtype, ty0) * p + (p + 1) * 0.5) * s
    dx = cx[None, :] - tr[0]
    dy = cy[:, None] - tr[1]
    distance = torch.sqrt(dx * dx + dy * dy)
    circumradius = math.sqrt(2.0) * (p * s) * 0.5
    trunc = grid.max_truncation
    closest = distance - circumradius - trunc
    farthest = distance + circumradius + trunc
    # range-window tests (TsdGridComponent.cpp:49-58)
    in_window = (closest <= geom.max_range) & (farthest >= geom.min_range)

    # corner back-projection (TsdGridComponent.cpp:66-93)
    idx_edge = back_project(geom, pose, _tile_edges(grid, dtype, ty0))
    below = idx_edge == -2
    above = idx_edge == -1
    seen = ~below & ~above
    any_visible = seen.any(dim=-1)
    all_visible = seen.all(dim=-1)
    idx_mapped = torch.where(above, geom.size - 1,
                             torch.where(below, 0, idx_edge))
    min_idx = idx_mapped.amin(dim=-1)
    max_idx = idx_mapped.amax(dim=-1)

    # beam-span reductions (TsdGridComponent.cpp:96-114), [TY, TX, B]
    beams = torch.arange(geom.size, device=dev)
    in_span = ((beams >= min_idx[..., None]) & (beams <= max_idx[..., None]))
    visible_beam = (data > closest[..., None]) & mask
    is_visible = (in_span & visible_beam).any(dim=-1)

    empty_beam = torch.where(
        torch.isinf(data),
        (distance < geom.low_reflectivity_range)[..., None],
        (data > farthest[..., None]) & mask,
    )
    is_empty = (~in_span | empty_beam).all(dim=-1)

    base = in_window & any_visible & is_visible
    empty_inc = base & all_visible & is_empty
    touch = base & ~empty_inc

    # max_range divides as a tensor, for the IEEE quotient on CUDA too
    # (see sensor/polar2d.py::back_project)
    dist_clamped = distance.clamp(max=geom.max_range)
    max_range = torch.full((), geom.max_range, dtype=dtype, device=dev)
    part_weight = ((geom.max_range - dist_clamped) / max_range) ** 2
    return touch, empty_inc, part_weight


def next_tile_initw(grid: TsdGrid, empty_inc: torch.Tensor) -> torch.Tensor:
    """Emptiness weight of tiles traversed before materialization
    (TsdGridPartition.cpp:136-164)."""
    return torch.where(empty_inc & ~grid.tile_init,
                       (grid.tile_initw + 1.0).clamp(max=grid.max_weight),
                       grid.tile_initw)


def push(grid: TsdGrid, geom: SensorPolar2D, pose: torch.Tensor,
         data: torch.Tensor, mask: torch.Tensor,
         tile_gate: Optional[torch.Tensor] = None, ty0: int = 0) -> TsdGrid:
    """Fuse one masked polar scan into the grid (TsdGrid::push).

    Args:
      grid: current TSD state (not modified).
      geom: scan geometry.
      pose: (3,3) sensor pose in world frame.
      data: (B,) ranges (inf = no return; see standard_mask).
      mask: (B,) validity mask.
      tile_gate: optional [TY, TX] bool pre-cull mask; tiles outside it
        take no part in the update (push_tree's quadtree gate).
      ty0: the world tile row of the grid's first tile row, for a row
        block of a larger grid (parallel/sharded.py): the block's rows
        come out equal in every bit to the same rows of the larger grid's
        push.
    Returns:
      the updated grid.
    """
    dtype = grid.tsd.dtype
    data = data.to(dtype)
    tr = se2.translation(pose).to(dtype)
    trunc = grid.max_truncation

    touch, empty_inc, part_weight = tile_cull(grid, geom, pose, data, mask,
                                              ty0)
    if tile_gate is not None:
        touch = touch & tile_gate
        empty_inc = empty_inc & tile_gate

    # ---- materialize newly-initialized tiles (TsdGridPartition::init) ----
    newly_init = touch & ~grid.tile_init
    was_empty = newly_init & (grid.tile_initw > 0.0)
    cell_new_empty = expand_tiles(grid, was_empty)
    cell_new_plain = expand_tiles(grid, newly_init & ~was_empty)
    cell_initw = expand_tiles(grid, grid.tile_initw)

    tsd0 = torch.where(cell_new_empty, TSDINC,
                       torch.where(cell_new_plain, math.nan, grid.tsd))
    w0 = torch.where(cell_new_empty, cell_initw,
                     torch.where(cell_new_plain, 0.0, grid.weight))

    # ---- per-cell fusion over touched tiles (TsdGrid.cpp:246-274) -------
    xs, ys = cell_centers(grid, dtype, row0=ty0 * grid.tile_dim)
    shape = (grid.cells_y, grid.cells_x)
    cells = torch.stack([xs[None, :].expand(shape),
                         ys[:, None].expand(shape)], dim=-1)
    idx = back_project(geom, pose, cells)               # [H, W]
    beam_ok = idx >= 0
    idx_c = idx.clamp(0, geom.size - 1).to(torch.int64)
    # one encoded table lookup: NaN encodes a masked beam
    data_enc = torch.where(mask, data, math.nan)
    d = data_enc[idx_c]
    m = ~torch.isnan(d) & beam_ok

    dx = cells[..., 0] - tr[0]
    dy = cells[..., 1] - tr[1]
    dist_cell = torch.sqrt(dx * dx + dy * dy)
    finite = ~torch.isinf(d)
    sd = torch.where(finite, d - dist_cell, trunc)
    # inf returns push free space only within the low-reflectivity range
    # (TsdGrid.cpp:266-271)
    do_add = m & (finite | (dist_cell < geom.low_reflectivity_range))
    cell_touched = expand_tiles(grid, touch)

    # addTsd (TsdGridPartition.h:170-212)
    accept = do_add & cell_touched & (sd >= -trunc)
    tsd_new = (sd / torch.full((), trunc, dtype=dtype, device=sd.device)
               ).clamp(max=TSDINC)        # the IEEE quotient on CUDA too
    # the reference's surface weight boost (w = 1 when |sd| < eps) is dead
    # code: eps = -cellSize/2 (TsdGridPartition.cpp:95) never exceeds |sd|
    eps = -grid.cell_size / 2.0
    w_meas = (torch.where(sd.abs() < eps, torch.ones_like(sd), 0.01)
              * expand_tiles(grid, part_weight))

    cell_nan = torch.isnan(tsd0)
    denom = w0 + w_meas
    blend_tsd = torch.where(cell_nan, tsd_new,
                            (tsd0 * w0 + tsd_new * w_meas) / denom)
    blend_w = torch.where(cell_nan, denom, denom.clamp(max=grid.max_weight))

    tsd1 = torch.where(accept, blend_tsd, tsd0)
    w1 = torch.where(accept, blend_w, w0)

    # ---- increaseEmptiness (TsdGridPartition.cpp:136-164) ---------------
    cell_empty_inc = expand_tiles(grid, empty_inc & grid.tile_init)
    enan = torch.isnan(tsd1)
    w_emptied = torch.where(enan, w1 + 1.0,
                            (w1 + 1.0).clamp(max=grid.max_weight))
    tsd_emptied = torch.where(enan, TSDINC,
                              (tsd1 * (w_emptied - 1.0) + 1.0) / w_emptied)
    tsd2 = torch.where(cell_empty_inc, tsd_emptied, tsd1)
    w2 = torch.where(cell_empty_inc, w_emptied, w1)

    return dataclasses.replace(
        grid,
        tsd=tsd2,
        weight=w2,
        tile_init=grid.tile_init | touch,
        tile_initw=next_tile_initw(grid, empty_inc),
    )


def branch_gate(grid: TsdGrid, geom: SensorPolar2D,
                pose: torch.Tensor) -> torch.Tensor:
    """Quadtree branch-level range-window culling, one vector test per
    level: the pushRecursion descent (TsdGrid.cpp:357-370) tests a leaf
    only if every ancestor branch passes the range-window part of
    TsdGridComponent::isInRange (TsdGridComponent.cpp:46-58).  A branch's
    centroid is the mean of its leaves' centroids and its circumradius
    doubles a level (TsdGridBranch.cpp:42-71).

    Returns the [TY, TX] bool mask of the leaves whose ancestor chain
    survives.  The distance is sqrt(dx·dx + dy·dy), the JAX package's norm
    in its order of operations."""
    dtype = grid.tsd.dtype
    dev = grid.tsd.device
    p = grid.tile_dim
    s = grid.cell_size
    tr = se2.translation(pose).to(dtype)
    trunc = grid.max_truncation
    r_leaf = math.sqrt(2.0) * (p * s) * 0.5

    gate = torch.ones((grid.tiles_y, grid.tiles_x), dtype=torch.bool,
                      device=dev)
    blk = 2  # tiles per block side at this level (2^level)
    while (blk <= grid.tiles_x and blk <= grid.tiles_y
           and grid.tiles_x % blk == 0 and grid.tiles_y % blk == 0):
        # the mean of the block's leaf centroids, (j*p + (p+1)/2)*s a leaf
        # (TsdGridPartition.cpp:65-70)
        cx, cy = ((torch.arange(n // blk, dtype=dtype, device=dev)
                   * (blk * p) + (blk - 1) * p * 0.5 + (p + 1) * 0.5) * s
                  for n in (grid.tiles_x, grid.tiles_y))
        dx = cx[None, :] - tr[0]
        dy = cy[:, None] - tr[1]
        distance = torch.sqrt(dx * dx + dy * dy)
        r = blk * r_leaf
        ok = ((distance - r - trunc <= geom.max_range)
              & (distance + r + trunc >= geom.min_range))
        gate = gate & ok.repeat_interleave(blk, 0).repeat_interleave(blk, 1)
        blk *= 2
    return gate


def push_tree(grid: TsdGrid, geom: SensorPolar2D, pose: torch.Tensor,
              data: torch.Tensor, mask: torch.Tensor) -> TsdGrid:
    """TsdGrid::pushTree (TsdGrid.cpp:286-350): the push with whole
    quadtree branches pruned by their range window first.  The branch test
    is conservative (a branch window contains every child's), so the
    result equals push()'s; the gate only spares the pruned tiles' cull.
    It runs through grid/dispatch.py::best_push, so a grid on the card
    goes to the push kernel with the gate, never to the plain push.

    The reference's pushTree loop skips push's per-beam mask check
    (TsdGrid.cpp:321-341 vs :249-274, an older copy of the loop); as in
    the JAX package, the mask check is kept."""
    from ohm_tsd_slam_tpu_torch.grid import dispatch

    return dispatch.best_push(grid)(grid, geom, pose, data, mask,
                                    tile_gate=branch_gate(grid, geom, pose))


# --------------------------------------------------------------------------
# compiled entry points (utils/compiled.py: a CUDA graph a key on the card,
# the eager functions on the CPU)
# --------------------------------------------------------------------------

def _kernel_route(grid: TsdGrid, geom: SensorPolar2D, pose: torch.Tensor,
                  data: torch.Tensor, mask: torch.Tensor,
                  tile_gate: Optional[torch.Tensor], ty0: int) -> TsdGrid:
    from ohm_tsd_slam_tpu_torch.grid import dispatch

    return dispatch.best_push(grid)(grid, geom, pose, data, mask,
                                    tile_gate=tile_gate, ty0=ty0)


_push_graph = compiled(_kernel_route, static_argnames=("geom", "ty0"))


def push_jit(grid: TsdGrid, geom: SensorPolar2D, pose: torch.Tensor,
             data: torch.Tensor, mask: torch.Tensor,
             tile_gate: Optional[torch.Tensor] = None,
             ty0: int = 0) -> TsdGrid:
    """push, compiled (ohm_tsd_slam_tpu/grid/push.py::push_jit, `geom`
    static): on the card one graph a key of grid/dispatch.py::best_push's
    route, the push kernel (ops/push_cuda.py); the plain push never runs
    there.  On the CPU the plain push."""
    return _push_graph(grid, geom, pose, data, mask, tile_gate, ty0)


push_jit.compiled = _push_graph

_tree_graph = compiled(push_tree, static_argnames=("geom",))


def push_tree_jit(grid: TsdGrid, geom: SensorPolar2D, pose: torch.Tensor,
                  data: torch.Tensor, mask: torch.Tensor) -> TsdGrid:
    """push_tree, compiled (ohm_tsd_slam_tpu/grid/push.py::push_tree_jit,
    `geom` static): on the card one graph a key of branch_gate's vector
    tests and the push kernel with that tile gate, so the gate's torch
    glue costs one launch a call."""
    return _tree_graph(grid, geom, pose, data, mask)


push_tree_jit.compiled = _tree_graph
