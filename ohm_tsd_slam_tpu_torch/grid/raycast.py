"""Polar ray casting — the exact dense march (port of
ohm_tsd_slam_tpu/grid/raycast.py::raycast).

RayCastPolar2D (RayCastPolar2D.cpp) marches each beam cell by cell,
4-tap bilinear reads, first +→− sign change wins, −→+ rejected as a back
face.  Here the march is a dense [B, K] tensor program: every beam samples
every step at once and the first crossing is found with an argmax over the
step axis.

Semantics replicated (citations inline):
  * rays scaled to one cell per step       (RayCastPolar2D.cpp:36,123)
  * AABB slab clipping + min/max range     (RayCastPolar2D.cpp:205-219)
  * sensor-outside-grid guard              (RayCastPolar2D.cpp:42-60,128-146)
  * coarse skip over empty/invalid tiles   (RayCastPolar2D.cpp:224-235)
  * sub-cell interpolation of the crossing (RayCastPolar2D.cpp:257-262)
  * back-face (−→+) rejection              (RayCastPolar2D.cpp:263-267)
  * central-difference normals; a failed
    normal invalidates the beam            (RayCastPolar2D.cpp:277-280)
  * model points in the sensor frame       (RayCastPolar2D.cpp:172-177)
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ohm_tsd_slam_tpu_torch.core import se2
from ohm_tsd_slam_tpu_torch.grid.interpolate import (
    INTERPOLATE_EMPTYPARTITION,
    INTERPOLATE_INVALIDINDEX,
    INTERPOLATE_SUCCESS,
    interpolate_bilinear,
    interpolate_normal,
)
from ohm_tsd_slam_tpu_torch.grid.state import TsdGrid
from ohm_tsd_slam_tpu_torch.sensor.polar2d import SensorPolar2D
from ohm_tsd_slam_tpu_torch.utils.compiled import compiled


class RaycastResult(NamedTuple):
    coords: torch.Tensor    # [B, 2] surface points in the sensor frame
    normals: torch.Tensor   # [B, 2] surface normals in the sensor frame
    mask: torch.Tensor      # [B]    beam produced a valid model point
    ranges: torch.Tensor    # [B]    |coords|
    # beams or segments the fast caster lost to a fixed capacity (int64;
    # grid/raycast_fast.py); 0 for the exact march
    n_dropped: torch.Tensor


def _num_steps(geom: SensorPolar2D, grid: TsdGrid) -> int:
    return int(math.ceil(geom.max_range / grid.cell_size)) + 2


def _first_true(x: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 if none); torch
    has no bool argmax, and returns the first of equal maxima."""
    return x.to(torch.uint8).argmax(dim=-1)


def first_event(v: torch.Tensor, t: torch.Tensor, idx_max: torch.Tensor):
    """The march's first sign change over the sample pairs (k, k+1) of
    [B, K+1] samples `v` at steps `t` (RayCastPolar2D.cpp:237-270): the
    loop runs while i = t - 1 <= idx_max; +→− is a hit, −→+ a back face,
    a NaN sample neither.  Returns (hit [B], any_ev [B], k [B, 1] the
    pair's index, 0 without an event, interp [B] its sub-step fraction)."""
    step_valid = (t[:, 1:] - 1.0) <= idx_max[:, None]    # [B, K]
    v_prev = v[:, :-1]
    v_cur = v[:, 1:]
    ev_pos = (v_prev > 0) & (v_cur < 0) & step_valid
    ev_neg = (v_prev < 0) & (v_cur > 0) & step_valid
    ev = ev_pos | ev_neg
    any_ev = ev.any(dim=1)
    k = _first_true(ev)[:, None]                         # first event
    hit = any_ev & torch.gather(ev_pos, 1, k)[:, 0]
    vp = torch.gather(v_prev, 1, k)[:, 0]
    vc = torch.gather(v_cur, 1, k)[:, 0]
    return hit, any_ev, k, vp / (vp - vc)


def beam_geometry(grid: TsdGrid, geom: SensorPolar2D, pose: torch.Tensor):
    """World-frame beam step vectors (one cell per step) and the per-beam
    march range, by slab clipping to the grid and the min/max range
    (RayCastPolar2D.cpp:200-221).

    Returns (ray [B,2], tr [2], idx_min [B], idx_max [B], feasible [B])."""
    pose = pose.to(grid.tsd.dtype)
    return _clip_beams(grid, geom, pose[0, 0], pose[0, 1], pose[1, 0],
                       pose[1, 1], se2.translation(pose))


def beam_geometry_batch(grid: TsdGrid, geom: SensorPolar2D,
                        poses: torch.Tensor):
    """beam_geometry for each of P poses [P, 3, 3] at once: (ray [P,B,2],
    tr [P,2], idx_min [P,B], idx_max [P,B], feasible [P,B]).  The same
    elementwise operations, broadcast over the pose axis, so each pose's
    rows equal beam_geometry's for that pose."""
    poses = poses.to(grid.tsd.dtype)
    return _clip_beams(grid, geom, poses[:, 0, 0, None],
                       poses[:, 0, 1, None], poses[:, 1, 0, None],
                       poses[:, 1, 1, None], poses[:, :2, 2])


def _clip_beams(grid: TsdGrid, geom: SensorPolar2D, r00, r01, r10, r11,
                tr: torch.Tensor):
    """beam_geometry from the rotation's entries (0-dim, or [P, 1] for a
    pose batch) and the translation tr ([2] or [P, 2])."""
    dtype = grid.tsd.dtype
    s = grid.cell_size
    rays_local = geom.rays_local(dtype, grid.tsd.device)    # [B, 2] unit
    x, y = rays_local[..., 0], rays_local[..., 1]
    # se2.rotate_vectors' arithmetic, one cell per step
    ray = torch.stack([r00 * x + r01 * y, r10 * x + r11 * y], dim=-1) * s
    if tr.dim() == 1:
        tx, ty = tr[0], tr[1]
    else:
        tx, ty = tr[:, 0, None], tr[:, 1, None]

    inside = grid.is_inside((tx, ty))
    # defaults: inside → (-1e10, +1e10); outside → inverted, so
    # idx_min >= idx_max unless both slabs override (RayCastPolar2D.cpp:42-60)
    def_min = (1.0 - 2.0 * inside.to(dtype)) * 10e9
    def_max = -def_min

    xdim = (grid.cells_x - 1) * s
    ydim = (grid.cells_y - 1) * s
    rx, ry = ray[..., 0], ray[..., 1]
    use_x = rx.abs() > 10e-6
    use_y = ry.abs() > 10e-6
    zero = torch.zeros_like(rx)
    x_lo = torch.where(rx > 0.0, zero, xdim)
    y_lo = torch.where(ry > 0.0, zero, ydim)
    x_hi = torch.where(rx > 0.0, xdim, zero)
    y_hi = torch.where(ry > 0.0, ydim, zero)
    xmin = torch.where(use_x, (x_lo - tx) / rx, def_min)
    ymin = torch.where(use_y, (y_lo - ty) / ry, def_min)
    xmax = torch.where(use_x, (x_hi - tx) / rx, def_max)
    ymax = torch.where(use_y, (y_hi - ty) / ry, def_max)

    idx_min = torch.maximum(xmin, ymin).clamp(min=0.0)
    idx_min = idx_min.clamp(min=geom.min_range / s)
    idx_max = torch.minimum(xmax, ymax).clamp(max=geom.max_range / s)
    return ray, tr, idx_min, idx_max, idx_min < idx_max


def raycast(grid: TsdGrid, geom: SensorPolar2D,
            pose: torch.Tensor) -> RaycastResult:
    """Render the model scan for all beams from `pose`
    (RayCastPolar2D::calcCoordsFromCurrentViewMask,
    RayCastPolar2D.cpp:113-192): beam-aligned outputs plus a mask."""
    dtype = grid.tsd.dtype
    dev = grid.tsd.device
    ray, tr, idx_min, idx_max, feasible = beam_geometry(grid, geom, pose)

    # ---- coarse skip over empty/invalid tiles ---------------------------
    # (RayCastPolar2D.cpp:224-235): advance in tile-size steps while the
    # interpolation reports EMPTYPARTITION/INVALIDINDEX; the march starts
    # from the last uninformative coarse sample (same sampling phase).
    part = float(grid.tile_dim)
    n_coarse = int(math.ceil(_num_steps(geom, grid) / part)) + 1
    m = torch.arange(n_coarse, dtype=dtype, device=dev)
    t_coarse = idx_min[:, None] + m[None, :] * part      # [B, M]
    coarse_valid = t_coarse < idx_max[:, None]
    pos_coarse = tr + t_coarse[..., None] * ray[:, None, :]
    _, code_c = interpolate_bilinear(grid, pos_coarse)
    informative = ((code_c != INTERPOLATE_EMPTYPARTITION)
                   & (code_c != INTERPOLATE_INVALIDINDEX)
                   & coarse_valid)
    any_inf = informative.any(dim=1)
    first_inf = _first_true(informative)
    last_valid = (coarse_valid.sum(dim=1) - 1).clamp(min=0)
    skip = torch.where(any_inf, (first_inf - 1).clamp(min=0), last_valid)
    idx_start = idx_min + skip.to(dtype) * part

    # ---- fine march (RayCastPolar2D.cpp:237-270) ------------------------
    K = _num_steps(geom, grid)
    k = torch.arange(K + 1, dtype=dtype, device=dev)     # sample 0 = start
    t = idx_start[:, None] + k[None, :]                  # [B, K+1]
    pos = tr + t[..., None] * ray[:, None, :]            # [B, K+1, 2]
    tsd, code = interpolate_bilinear(grid, pos)
    v = torch.where(code == INTERPOLATE_SUCCESS, tsd, math.nan)
    hit, _, k_ev, interp = first_event(v, t, idx_max)
    pos_ev = torch.gather(pos[:, 1:, :], 1,
                          k_ev[:, :, None].expand(-1, 1, 2))[:, 0, :]
    coords_w = pos_ev + ray * (interp[:, None] - 1.0)

    normals_w, n_ok = interpolate_normal(grid, coords_w)
    return sensor_frame(pose.to(dtype), coords_w, normals_w,
                        feasible & hit & n_ok,
                        torch.zeros((), dtype=torch.int64, device=dev))


def sensor_frame(pose: torch.Tensor, coords_w: torch.Tensor,
                 normals_w: torch.Tensor, mask: torch.Tensor,
                 n_dropped: torch.Tensor) -> RaycastResult:
    """World-frame model points to the beam-aligned sensor-frame result,
    zero where `mask` is False (RayCastPolar2D.cpp:168-177).  `pose` [3, 3]
    with [B] beams, or a pose batch [P, 3, 3] with [P, B] beams: then each
    pose's rows are what this function gives for that pose alone (se2's
    elementwise arithmetic on its entries, taken as [P, 1] columns)."""
    if pose.dim() == 3:
        pose = pose.permute(1, 2, 0)[..., None]           # [3, 3, P, 1]
    Tinv = se2.invert(pose)
    coords_s = se2.transform_points(Tinv, coords_w)
    normals_s = se2.rotate_vectors(Tinv, normals_w)
    coords_s = torch.where(mask[..., None], coords_s, 0.0)
    normals_s = torch.where(mask[..., None], normals_s, 0.0)
    ranges = torch.sqrt(torch.sum(coords_s * coords_s, dim=-1))
    return RaycastResult(coords_s, normals_s, mask, ranges, n_dropped)


_raycast_graph = compiled(raycast, static_argnames=("geom",))


def raycast_jit(grid: TsdGrid, geom: SensorPolar2D,
                pose: torch.Tensor) -> RaycastResult:
    """raycast, compiled (ohm_tsd_slam_tpu/grid/raycast.py::raycast_jit,
    `geom` static): on the card the exact march's ops as one graph a key,
    on the CPU the eager march."""
    return _raycast_graph(grid, geom, pose)


raycast_jit.compiled = _raycast_graph
