"""The grid-reading matchers against a row-sharded grid, with bounded
collectives (port of ohm_tsd_slam_tpu/parallel/shard_matchers.py).

TSD_PDFMatching (registration mode TSD, the reference's shipped default,
config/single-laser.yaml) rates candidate poses by bilinear taps into the
TSD field (TSD_PDFMatching.cpp:223-251); AMCL rates its particles by the
same likelihood, and the direct Gauss-Newton matcher reads the field's
value and gradient at each scene point.  With the grid's rows split over
the mesh's "sp" axis:

  * each rank evaluates the taps whose base cell row it owns (one halo row
    covers the taps one row above: the propagateBorders analogue,
    TsdGrid.cpp:372-427); a point whose base cell is outside the grid (the
    zrand miss) belongs to sp rank 0, so every point counts once;
  * per-point results are summed on the rank, and only the partial sums
    cross ranks, in one SUM all_reduce each: the candidates' [K]
    log-likelihoods (TSD), the particles' [P] a filter iteration (AMCL),
    the packed normal equations (15 numbers) an iteration (GN);
  * everything else (trial preparation, draws, candidates, the argmax) is
    computed on every rank from the same inputs and the same
    torch.Generator state, so the transform comes out the same on every
    rank without further collectives.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from ohm_tsd_slam_tpu_torch.grid.state import TsdGrid
from ohm_tsd_slam_tpu_torch.parallel.mesh import (
    all_gather,
    all_reduce,
    axis_index,
    float_pack,
    float_unpack,
    shard_rows,
)
from ohm_tsd_slam_tpu_torch.parallel.shard_raycast import _halo_exchange
from ohm_tsd_slam_tpu_torch.registration.amcl import AmclParams, match_amcl
from ohm_tsd_slam_tpu_torch.registration.gauss_newton import (
    GnParams,
    GnResult,
    match_gauss_newton,
)
from ohm_tsd_slam_tpu_torch.registration.ransac import (
    RansacParams,
    match_tsd,
)

# the bilinear stencil's reach: the base row iy and the row above
_TAP_HALO = 1


def _tap_block(block: torch.Tensor, ix: torch.Tensor,
               iy_local: torch.Tensor) -> torch.Tensor:
    """block[iy_local, ix], NaN where ix is outside the grid's columns
    (grid/interpolate.py's taps; the rows beyond the grid are the NaN
    halo rows of the edge blocks)."""
    Hb, W = block.shape
    oob = (ix < 0) | (ix >= W)
    v = block.reshape(-1)[iy_local.clamp(0, Hb - 1) * W + ix.clamp(0, W - 1)]
    return torch.where(oob, torch.nan, v)


def _local_tsd_logp_sum(block, tile_init, s, H, td, y0, h, idx_sp, mesh,
                        axis, zrand, world, pmask):
    """The TSD log-likelihood summed over the control points, from this
    rank's owned points, summed over the ranks: registration/ransac.py::
    match_tsd's per-point likelihood (TSD_PDFMatching.cpp:233-251),
    log(1 - (1 - zrand)|tsd|) on a bilinear hit, log(zrand) on a miss
    (outside the grid, an empty tile, a NaN tap).

    block: [h + 2, W] owned rows with one halo row a side; tile_init the
    whole grid's; world [..., C, 2] and pmask [C] the same on every rank.
    Returns [...]."""
    W = block.shape[1]
    dtype = block.dtype
    u = world[..., 0] / s - 0.5
    v = world[..., 1] / s - 0.5
    ix = torch.floor(u).to(torch.int64)
    iy = torch.floor(v).to(torch.int64)
    wx = u - ix.to(dtype)
    wy = v - iy.to(dtype)
    valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
    own = valid & (iy >= y0) & (iy < y0 + h)

    iy_l = iy - y0 + _TAP_HALO
    v00 = _tap_block(block, ix, iy_l)
    v10 = _tap_block(block, ix, iy_l + 1)
    v01 = _tap_block(block, ix + 1, iy_l)
    v11 = _tap_block(block, ix + 1, iy_l + 1)
    tsd = (v00 * (1.0 - wy) * (1.0 - wx)
           + v10 * wy * (1.0 - wx)
           + v01 * (1.0 - wy) * wx
           + v11 * wy * wx)
    TY, TX = tile_init.shape
    tile_ok = tile_init.reshape(-1)[(iy // td).clamp(0, TY - 1) * TX
                                    + (ix // td).clamp(0, TX - 1)]

    hit = own & tile_ok & ~torch.isnan(tsd)
    log_zrand = torch.log(torch.full((), zrand, dtype=dtype,
                                     device=block.device))
    logp_hit = torch.log((1.0 - (1.0 - zrand) * torch.where(
        hit, tsd, 0.0).abs()).clamp(min=1e-30))
    # owned points: a hit or an owned miss; points outside the grid are
    # counted once, by sp rank 0
    miss0 = ~valid & (idx_sp == 0)
    contrib = (torch.where(hit, logp_hit, 0.0)
               + torch.where((own & ~hit) | miss0, log_zrand, 0.0))
    contrib = torch.where(pmask, contrib, 0.0)
    return all_reduce(contrib.sum(-1), mesh, axis)


def _logp_sum_fn(mesh: DeviceMesh, grid: TsdGrid, zrand: float, axis: str):
    """The shard-local logp_sum_fn for match_tsd and match_amcl: the row
    block with one halo row a side (one all_reduce) and the whole
    tile_init (one more), once a call."""
    y0, h, H = shard_rows(mesh, grid, axis)
    block = _halo_exchange(grid.tsd, mesh, axis, rows=_TAP_HALO)
    tile_init = all_gather(grid.tile_init.to(grid.tsd.dtype), mesh,
                           axis).reshape(-1, grid.tiles_x) > 0

    def fn(world, pmask):
        return _local_tsd_logp_sum(block, tile_init, grid.cell_size, H,
                                   grid.tile_dim, y0, h,
                                   axis_index(mesh, axis), mesh, axis,
                                   zrand, world, pmask)
    return fn


def sharded_match_tsd(mesh: DeviceMesh, generator, grid: TsdGrid,
                      sensor_pose, model, mask_model, scene, mask_scene,
                      params: RansacParams, axis: str = "sp",
                      inject=None) -> torch.Tensor:
    """TSD_PDFMatching against the row-sharded grid (`grid`: this rank's
    row block): the candidate set and scoring of registration/ransac.py::
    match_tsd from the same draws on every rank (`generator` in the same
    state on each, or `inject`); only the grid taps are shard-local, with
    one SUM of the [K] candidate log-likelihoods."""
    return match_tsd(generator, None, sensor_pose, model, mask_model, scene,
                     mask_scene, params, inject=inject,
                     logp_sum_fn=_logp_sum_fn(mesh, grid, params.zrand_tsd,
                                              axis))


def sharded_match_amcl(mesh: DeviceMesh, generator, grid: TsdGrid,
                       sensor_pose, scene, mask_scene,
                       params: AmclParams = AmclParams(), axis: str = "sp",
                       inject=None) -> torch.Tensor:
    """AMCL particle matching against the row-sharded grid: one SUM of the
    [particles] log-likelihoods a filter iteration; resampling and jitter
    run on every rank from the same draws."""
    return match_amcl(generator, None, sensor_pose, scene, mask_scene,
                      params, inject=inject,
                      logp_sum_fn=_logp_sum_fn(mesh, grid, params.zrand,
                                               axis))


def _local_field_value_grad(block, s, W, H, y0, h, x):
    """registration/gauss_newton.py::_field_value_grad on the halo'd row
    block, with `ok` also False where this rank does not own the base row,
    so the unowned points add nothing to the summed normal equations."""
    dtype = block.dtype
    u = x[..., 0] / s - 0.5
    v = x[..., 1] / s - 0.5
    ix = torch.floor(u).to(torch.int64)
    iy = torch.floor(v).to(torch.int64)
    wx = u - ix.to(dtype)
    wy = v - iy.to(dtype)
    valid = (ix >= 0) & (ix < W - 1) & (iy >= 0) & (iy < H - 1)
    own = valid & (iy >= y0) & (iy < y0 + h)

    iy_l = iy - y0 + _TAP_HALO
    v00 = _tap_block(block, ix, iy_l)
    v10 = _tap_block(block, ix, iy_l + 1)
    v01 = _tap_block(block, ix + 1, iy_l)
    v11 = _tap_block(block, ix + 1, iy_l + 1)
    finite = ~(torch.isnan(v00) | torch.isnan(v10) | torch.isnan(v01)
               | torch.isnan(v11))
    v00, v10, v01, v11 = (torch.nan_to_num(t, nan=0.0)
                          for t in (v00, v10, v01, v11))
    val = (v00 * (1.0 - wy) * (1.0 - wx) + v10 * wy * (1.0 - wx)
           + v01 * (1.0 - wy) * wx + v11 * wy * wx)
    gx = ((v01 - v00) * (1.0 - wy) + (v11 - v10) * wy) / s
    gy = ((v10 - v00) * (1.0 - wx) + (v11 - v01) * wx) / s
    return val, gx, gy, own & finite


def sharded_match_gauss_newton(mesh: DeviceMesh, grid: TsdGrid,
                               sensor_pose, scene, scene_mask,
                               params: GnParams,
                               T_init: Optional[torch.Tensor] = None,
                               axis: str = "sp") -> GnResult:
    """Direct scan-to-map Gauss-Newton against the row-sharded grid: one
    SUM of the packed normal equations (3x3 H, the 3-vector b and three
    scalars) an iteration."""
    y0, h, H = shard_rows(mesh, grid, axis)
    block = _halo_exchange(grid.tsd, mesh, axis, rows=_TAP_HALO)

    def field_fn(x):
        return _local_field_value_grad(block, grid.cell_size, grid.cells_x,
                                       H, y0, h, x)

    def reduce_fn(stats):
        return float_unpack(all_reduce(float_pack(stats, block.dtype), mesh,
                                       axis), stats)

    return match_gauss_newton(None, sensor_pose, scene.to(block.dtype),
                              scene_mask, params, T_init=T_init,
                              field_fn=field_fn, reduce_fn=reduce_fn,
                              max_truncation=grid.max_truncation)
