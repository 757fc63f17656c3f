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
    dtype = grid.tsd.dtype
    s = grid.cell_size
    pose = pose.to(dtype)
    rays_local = geom.rays_local(dtype, grid.tsd.device)    # [B, 2] unit
    ray = se2.rotate_vectors(pose, rays_local) * s       # 1 cell per step
    tr = se2.translation(pose)

    inside = grid.is_inside(tr)
    # defaults: inside → (-1e10, +1e10); outside → inverted, so
    # idx_min >= idx_max unless both slabs override (RayCastPolar2D.cpp:42-60)
    def_min = (1.0 - 2.0 * inside.to(dtype)) * 10e9
    def_max = -def_min

    xdim = (grid.cells_x - 1) * s
    ydim = (grid.cells_y - 1) * s
    rx, ry = ray[:, 0], ray[:, 1]
    use_x = rx.abs() > 10e-6
    use_y = ry.abs() > 10e-6
    zero = torch.zeros_like(rx)
    x_lo = torch.where(rx > 0.0, zero, xdim)
    y_lo = torch.where(ry > 0.0, zero, ydim)
    x_hi = torch.where(rx > 0.0, xdim, zero)
    y_hi = torch.where(ry > 0.0, ydim, zero)
    xmin = torch.where(use_x, (x_lo - tr[0]) / rx, def_min)
    ymin = torch.where(use_y, (y_lo - tr[1]) / ry, def_min)
    xmax = torch.where(use_x, (x_hi - tr[0]) / rx, def_max)
    ymax = torch.where(use_y, (y_hi - tr[1]) / ry, def_max)

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
    zero where `mask` is False (RayCastPolar2D.cpp:168-177)."""
    Tinv = se2.invert(pose)
    coords_s = se2.transform_points(Tinv, coords_w)
    normals_s = se2.rotate_vectors(Tinv, normals_w)
    coords_s = torch.where(mask[:, None], coords_s, 0.0)
    normals_s = torch.where(mask[:, None], normals_s, 0.0)
    ranges = torch.sqrt(torch.sum(coords_s * coords_s, dim=-1))
    return RaycastResult(coords_s, normals_s, mask, ranges, n_dropped)
