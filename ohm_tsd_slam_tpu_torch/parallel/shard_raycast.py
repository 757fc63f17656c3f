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
     the exact march window on its halo'd block by kernel D (the JAX
     package runs it in XLA), the normal at the crossing included, and
     publishes the row in a SUM all_reduce (a beam has at most one
     owner), with the extraction's drops.

Per render: one all_reduce of 2 x HALO rows a rank, then a MIN and a SUM
a round over the beams: 1 + 2 x ROUNDS collectives, none of which grows
with the grid's height.  There is no exact-march fallback under the mesh
(it would gather the grid): the extraction's overflow is summed over the
ranks into n_dropped.
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


def _field_grid(tsd: torch.Tensor, s: float) -> TsdGrid:
    """The field `tsd` (a row block) as a grid of its own for what reads
    only the field and the cell size (the extraction, the window replay):
    the NaN-only semantics, no tiles, its weight one zero broadcast."""
    return TsdGrid(
        tsd=tsd, weight=tsd.new_zeros(()).expand_as(tsd),
        tile_init=torch.ones((1, 1), dtype=torch.bool, device=tsd.device),
        tile_initw=tsd.new_zeros((1, 1)), cell_size=s, max_truncation=0.0,
        max_weight=0.0, tile_dim=1)


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
    halo = _field_grid(tsd_halo, s)          # world row y0 - HALO first
    rows_h = slice(HALO, HALO + h + 1)
    p0, p1, valid, n_dropped = rf.extract_endpoints(
        dataclasses.replace(halo, tsd=tsd_halo[rows_h],
                            weight=halo.weight[rows_h]),
        max(rf.MAX_SEGMENTS // n, 2048), ks)
    shift = _vec2(0.0, y0 * s, p0)
    origin = rf._pack_origin(whole, dtype, dev)
    pack, count = rf.pack_segments(p0 + shift - origin, p1 + shift - origin,
                                   valid)
    tr_pack = tr - origin

    lo = (torch.floor(idx_min) - 1.0).clamp(min=0.0)
    hi = torch.ceil(idx_max) + 1.0
    # where each beam's search resumes: inf once it is resolved (a window
    # with an event, no candidate left) or infeasible; kernel C finds no
    # candidate past inf, so such a beam's t_r stays inf
    t_search = torch.where(feasible, lo, math.inf)
    B = ray.shape[0]
    ray_y = ray[:, 1]
    # the owner of a candidate at world y: the rank whose rows hold its
    # row y / s - 0.5 (bounds computed alike on both sides of a block edge,
    # so exactly one rank owns it; either's halo holds the window).  A beam
    # without a candidate has y = +-inf or NaN and no owner
    y_lo, y_hi = (y0 + 0.5) * s, (y0 + h + 0.5) * s
    # the taken rows: hit, any_ev, pos_x, pos_y, interp, nx, ny, n_ok
    taken = torch.zeros((B, 8), dtype=dtype, device=dev)
    for r in range(rf.ROUNDS):
        t_r = ks.segment_min(pack, count, ray, lo, hi, t_search, tr_pack,
                             levels=1)[:, 0]
        all_reduce(t_r, mesh, axis, "min")
        y_c = tr[1] + t_r * ray_y
        owner = (y_c >= y_lo) & (y_c < y_hi)
        rows = ks.window_replay(halo, t_r, ray, idx_min, idx_max, owner, tr,
                                row0=y0 - HALO)
        # publish the owned rows (-0.0 elsewhere, so a signed zero survives
        # the sum); the extraction's drops ride with the last round's
        pub = torch.where(owner[:, None], rows, -0.0).reshape(-1)
        if r == rf.ROUNDS - 1:
            pub = torch.cat([pub, n_dropped.to(dtype).reshape(1)])
        all_reduce(pub, mesh, axis)
        rows = pub[:8 * B].view(B, 8)
        take = rows[:, 1] > 0
        taken = torch.where(take[:, None], rows, taken)
        # the next round searches past the candidate's window (t_r + COVER
        # > t_search: t_r >= t_search)
        t_search = torch.where(take, math.inf, t_r + rf.COVER)

    # the normal counts only with a nonzero norm too (as JAX's
    # _local_normals); where kernel D's four taps fail, its normal is NaN,
    # which sensor_frame zeroes with the mask
    n_ok = (taken[:, 7] > 0) & (taken[:, 5:7] != 0).any(1)
    coords_w = taken[:, 2:4] + ray * (taken[:, 4:5] - 1.0)
    return sensor_frame(pose.to(dtype), coords_w, taken[:, 5:7],
                        (taken[:, 0] > 0) & n_ok, pub[-1].to(torch.int64))


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
