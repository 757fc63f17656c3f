"""The raycast against a row-sharded grid: halo exchange, shard-local
extraction and candidate sweeps, owned window replays (port of
ohm_tsd_slam_tpu/parallel/shard_raycast.py).

The grid's rows are split over the mesh's "sp" axis (parallel/mesh.py).
A beam crosses many row blocks, and gathering the grid for every scan
would move it whole; the isocontour caster (grid/raycast_fast.py)
decomposes instead:

  1. halo exchange (the propagateBorders analogue, TsdGrid.cpp:372-427):
     each rank receives HALO rows from each row neighbour, enough for
     marching squares on its boundary quads and for the window replay
     around any candidate it owns;
  2. shard-local extraction on the rank's rows and one halo row above
     (quads belong to the rank of their lower row, so no quad's segment
     is emitted twice), by kernels A and B (or E) as the whole grid's,
     the endpoints shifted into world coordinates;
  3. shard-local candidates: kernel C, one level, from the mesh-wide
     running start;
  4. the mesh-wide candidate: one MIN all_reduce over "sp" a round;
  5. owned window replay: the rank whose rows hold the candidate replays
     the exact march window on its halo'd block (plain torch, as the JAX
     package runs it in XLA) and publishes the result in a SUM all_reduce
     (a beam has at most one owner).

Per render: one all_reduce of 2 x HALO rows a rank, then a MIN and a SUM
a round over the beams, then one SUM of the normals: 2 + 2 x ROUNDS
collectives, none of which grows with the grid's height.  There is no
exact-march fallback under the mesh (it would gather the grid): the
extraction's overflow is summed over the ranks into n_dropped.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

import ohm_tsd_slam_tpu_torch.grid.raycast_fast as rf
from ohm_tsd_slam_tpu_torch.core import se2
from ohm_tsd_slam_tpu_torch.grid.raycast import (
    RaycastResult,
    beam_geometry,
    first_event,
    sensor_frame,
)
from ohm_tsd_slam_tpu_torch.grid.render import _bilinear_raw
from ohm_tsd_slam_tpu_torch.grid.state import TsdGrid
from ohm_tsd_slam_tpu_torch.parallel.mesh import (
    all_reduce,
    axis_index,
    axis_size,
    psum,
    shard_rows,
    slots,
)
from ohm_tsd_slam_tpu_torch.sensor.polar2d import (
    SensorPolar2D,
    data_to_cartesian,
)

# halo rows exchanged a side: the window replay's reach (WINDOW steps of
# one cell) and the bilinear and normal stencils
HALO = rf.WINDOW + 4


def _halo_exchange(tsd_local: torch.Tensor, mesh: DeviceMesh, axis: str,
                   rows: int = HALO) -> torch.Tensor:
    """[h, W] -> [h + 2 rows, W]: the neighbours' rows along `axis` above
    and below (NaN, unobserved, beyond the first and the last block), in
    every bit.  One all_reduce of [n, 2, rows, W] mesh.slots in which each
    rank writes its first and last rows into its own slot."""
    n, idx = axis_size(mesh, axis), axis_index(mesh, axis)
    h, W = tsd_local.shape
    if h < rows:
        raise ValueError(f"a row block of {h} rows is thinner than the "
                         f"{rows}-row halo")
    buf = slots(tsd_local.new_empty((2, rows, W)), n)
    buf[idx, 0] = tsd_local[:rows]
    buf[idx, 1] = tsd_local[-rows:]
    all_reduce(buf, mesh, axis)
    nan = torch.full((rows, W), math.nan, dtype=tsd_local.dtype,
                     device=tsd_local.device)
    below = buf[idx - 1, 1] if idx > 0 else nan
    above = buf[idx + 1, 0] if idx < n - 1 else nan
    return torch.cat([below, tsd_local, above])


def _whole_grid(grid: TsdGrid, H: int) -> TsdGrid:
    """A stand-in for the whole [H, W] grid for what reads only its shape,
    dtype and device (beam clipping, the pack's origin): its tsd is one
    cell broadcast, no memory."""
    return dataclasses.replace(grid, tsd=grid.tsd[:1, :1].expand(
        H, grid.cells_x))


def _vec2(x: float, y: float, like: torch.Tensor) -> torch.Tensor:
    """[x, y] in `like`'s dtype, filled on its device (a copy from the
    host would wait for the card)."""
    return torch.stack([torch.full((), v, dtype=like.dtype,
                                   device=like.device) for v in (x, y)])


def _local_taps(tsd_halo: torch.Tensor, s: float, row0: int,
                pos: torch.Tensor) -> torch.Tensor:
    """Bilinear values at world points from the halo'd block whose row 0
    is world row `row0`; NaN where a tap is missing or NaN (the NaN-only
    semantics: a cell of a tile never initialised is NaN).  The cells and
    weights come from the world coordinates, as on the whole grid (the
    JAX package shifts the coordinates into the block instead, which can
    round a point on a cell line into the cell next to it)."""
    v, _, ok = _bilinear_raw(tsd_halo, pos, s, row0)
    return torch.where(ok, v, math.nan)


def _local_window_events(tsd_halo, s, row0, tr, ray, idx_min, idx_max,
                         k_cand, has_cand):
    """The exact march's window replay (grid/raycast_fast.py::
    window_replay_plain's events) on the halo'd block: (hit, any_ev,
    pos_ev [B, 2], interp)."""
    j = torch.arange(rf.WINDOW, dtype=ray.dtype, device=ray.device)
    t_w = rf.window_start(k_cand, idx_min)[:, None] + j[None, :]
    pos = tr + t_w[..., None] * ray[:, None, :]           # [B, WINDOW, 2]
    v = _local_taps(tsd_halo, s, row0, pos)
    hit, any_ev, k_ev, interp = first_event(v, t_w, idx_max)
    pos_ev = torch.gather(pos[:, 1:, :], 1,
                          k_ev[:, :, None].expand(-1, 1, 2))[:, 0, :]
    return hit & has_cand, any_ev & has_cand, pos_ev, interp


def _local_normals(tsd_halo, s, row0, coords_w):
    """interpolateNormal (TsdGrid.cpp:517-546) on the halo'd block: the
    unit central difference and whether all four taps and its norm are
    good."""
    def tap(dx, dy):
        return _local_taps(tsd_halo, s, row0,
                           coords_w + _vec2(dx, dy, coords_w))

    vxp, vxm, vyp, vym = tap(s, 0.0), tap(-s, 0.0), tap(0.0, s), tap(0.0, -s)
    ok = ~(vxp.isnan() | vxm.isnan() | vyp.isnan() | vym.isnan())
    n = torch.stack([vxp - vxm, vyp - vym], dim=-1)
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    n = n / torch.where(norm > 0, norm, 1.0)
    return n, ok & (norm[..., 0] > 0)


def sharded_raycast(mesh: DeviceMesh, grid: TsdGrid, geom: SensorPolar2D,
                    pose: torch.Tensor, axis: str = "sp",
                    kernels: Optional[rf.CasterKernels] = None
                    ) -> RaycastResult:
    """Raycast against the row-sharded grid without gathering it: `grid`
    is this rank's row block (mesh.grid_sharding), `pose` the same on
    every rank of the group.  Returns the beam-aligned result on every
    rank, with raycast_fast's semantics on the whole grid.  `kernels` as
    in raycast_fast (ops/kernel_check.py passes its checked ones).

    A rank's segment capacity is max(MAX_SEGMENTS // sp, 2048): it owns a
    1/sp share of the rows, hence about that share of the isocontour."""
    ks = kernels or rf.cuda_kernels()
    n = axis_size(mesh, axis)
    y0, h, H = shard_rows(mesh, grid, axis)
    s = grid.cell_size
    dtype, dev = grid.tsd.dtype, grid.tsd.device
    whole = _whole_grid(grid, H)
    ray, tr, idx_min, idx_max, feasible = beam_geometry(whole, geom, pose)

    # the rank's quads (lower row in [y0, y0 + h)): its rows and the first
    # halo row above; the block is a grid of its own for the extraction
    tsd_halo = _halo_exchange(grid.tsd, mesh, axis)
    block = tsd_halo[HALO:HALO + h + 1]
    block_grid = TsdGrid(
        tsd=block, weight=torch.zeros_like(block),
        tile_init=torch.ones((1, 1), dtype=torch.bool, device=dev),
        tile_initw=torch.zeros((1, 1), dtype=dtype, device=dev),
        cell_size=s, max_truncation=0.0, max_weight=0.0, tile_dim=1)
    p0, p1, valid, n_dropped = rf.extract_endpoints(
        block_grid, max(rf.MAX_SEGMENTS // n, 2048), ks)
    shift = _vec2(0.0, y0 * s, p0)
    origin = rf._pack_origin(whole, dtype, dev)
    pack, count = rf.pack_segments(p0 + shift - origin, p1 + shift - origin,
                                   valid)
    tr_pack = tr - origin

    lo = (torch.floor(idx_min) - 1.0).clamp(min=0.0)
    hi = torch.ceil(idx_max) + 1.0
    t_search = lo
    B = ray.shape[0]
    resolved = torch.zeros(B, dtype=torch.bool, device=dev)
    hit = torch.zeros_like(resolved)
    ownmask = torch.zeros_like(resolved)
    pos_ev = torch.zeros((B, 2), dtype=dtype, device=dev)
    interp = torch.zeros(B, dtype=dtype, device=dev)
    for _ in range(rf.ROUNDS):
        t_after = torch.where(resolved, math.inf, t_search)
        t_r = ks.segment_min(pack, count, ray, lo, hi, t_after, tr_pack,
                             levels=1)[:, 0].contiguous()
        all_reduce(t_r, mesh, axis, "min")
        has = torch.isfinite(t_r) & feasible & ~resolved
        k_r = torch.where(has, t_r, 0.0)
        # the owner: the candidate's row lies in this rank's rows
        row_c = (tr[1] + k_r * ray[:, 1]) / s - 0.5
        owner = has & (row_c >= y0) & (row_c < y0 + h)
        hit_r, any_r, pos_r, int_r = _local_window_events(
            tsd_halo, s, y0 - HALO, tr, ray, idx_min, idx_max, k_r, owner)
        # publish the owned results: [B, 5] hit, any, pos, interp
        pub = torch.where(owner[:, None], torch.cat([
            hit_r[:, None].to(dtype), any_r[:, None].to(dtype), pos_r,
            int_r[:, None]], dim=1), 0.0)
        all_reduce(pub, mesh, axis)
        take = (pub[:, 1] > 0) & ~resolved
        hit = torch.where(take, pub[:, 0] > 0, hit)
        pos_ev = torch.where(take[:, None], pub[:, 2:4], pos_ev)
        interp = torch.where(take, pub[:, 4], interp)
        ownmask = torch.where(take, owner, ownmask)
        resolved = resolved | take | ~has
        t_search = torch.maximum(t_search, k_r + rf.COVER)

    coords_w = pos_ev + ray * (interp[:, None] - 1.0)
    # the normals at the crossing, by its owner; the drops ride along
    nrm, n_ok = _local_normals(tsd_halo, s, y0 - HALO, coords_w)
    pub = torch.cat([torch.where(ownmask[:, None], torch.cat(
        [nrm, n_ok[:, None].to(dtype)], dim=1), 0.0).reshape(-1),
        n_dropped.to(dtype).reshape(1)])
    all_reduce(pub, mesh, axis)
    normals_w = pub[:-1].reshape(B, 3)[:, :2]
    n_ok = pub[:-1].reshape(B, 3)[:, 2] > 0
    return sensor_frame(pose.to(dtype), coords_w, normals_w,
                        feasible & hit & n_ok, pub[-1].to(torch.int64))


def sharded_map_residual(mesh: DeviceMesh, grid: TsdGrid,
                         geom: SensorPolar2D, pose: torch.Tensor,
                         data: torch.Tensor, mask: torch.Tensor,
                         axis: str = "sp") -> torch.Tensor:
    """parallel/sharded.py::map_residual_loss against the row-sharded
    grid: each rank takes the bilinear reads whose base cell row it owns
    (its halo covers the taps one row above), and one SUM of the pair
    (sum of squares, count) makes the mean.  Differentiable in `pose`;
    under autograd each rank's gradient is its own part (mesh.psum), so
    sharded_pose_gradient sums them."""
    dtype = grid.tsd.dtype
    s = grid.cell_size
    y0, h, _ = shard_rows(mesh, grid, axis)
    scene, valid = data_to_cartesian(geom, data, mask)
    world = se2.transform_points(pose.to(dtype), scene)
    tsd_halo = _halo_exchange(grid.tsd, mesh, axis)
    v, _, ok = _bilinear_raw(tsd_halo, world, s, y0 - HALO)
    iy = torch.floor(world[..., 1] / s - 0.5)
    use = valid & ok & (iy >= y0) & (iy < y0 + h)
    num_den = psum(torch.stack([torch.where(use, v * v, 0.0).sum(),
                                use.sum().to(dtype)]), mesh, axis)
    return num_den[0] / num_den[1].clamp(min=1)


def sharded_pose_gradient(mesh: DeviceMesh, grid: TsdGrid,
                          geom: SensorPolar2D, pose: torch.Tensor,
                          data: torch.Tensor, mask: torch.Tensor,
                          axis: str = "sp") -> torch.Tensor:
    """d(map residual)/d(x, y, theta) with the grid left row-sharded (the
    sharded parallel/sharded.py::pose_gradient): each rank's part of the
    gradient, then one SUM over `axis`."""
    with torch.enable_grad():
        p3 = torch.zeros(3, dtype=pose.dtype, device=pose.device,
                         requires_grad=True)
        delta = se2.make(p3[0], p3[1], p3[2], dtype=pose.dtype,
                         device=pose.device)
        loss = sharded_map_residual(mesh, grid, geom, pose @ delta, data,
                                    mask, axis)
        (grad,) = torch.autograd.grad(loss, p3)
    return all_reduce(grad, mesh, axis)
