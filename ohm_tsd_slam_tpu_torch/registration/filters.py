"""Pre/post assignment filters as pure mask transforms (port of
ohm_tsd_slam_tpu/registration/filters.py).

A pair set is the triple (model_idx[S], dist2[S], pair_mask[S]) aligned to
the scene points (reference: src/obvision/registration/icp/assign/filter/).
"""

from __future__ import annotations

import torch

from ohm_tsd_slam_tpu_torch.core import se2
from ohm_tsd_slam_tpu_torch.registration.nn import project_pixels, to_int32


def out_of_bounds_filter_2d(scene: torch.Tensor, mask: torch.Tensor,
                            pose: torch.Tensor,
                            x_min: float, x_max: float,
                            y_min: float, y_max: float) -> torch.Tensor:
    """OutOfBoundsFilter2D (OutOfBoundsFilter2D.cpp:27-37): drop scene
    points that fall outside the grid AABB in world coordinates."""
    w = se2.transform_points(pose, scene)
    inside = ((w[:, 0] >= x_min) & (w[:, 0] <= x_max)
              & (w[:, 1] >= y_min) & (w[:, 1] <= y_max))
    return mask & inside


def robot_footprint_filter(scene: torch.Tensor, mask: torch.Tensor,
                           center: torch.Tensor,
                           radius: float) -> torch.Tensor:
    """RobotFootprintFilter (RobotFootprintFilter.cpp:41-61): mask points
    within `radius` of the robot center (self-observations)."""
    d = scene - center
    return mask & (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] > radius * radius)


def occlusion_filter(scene3d: torch.Tensor, mask: torch.Tensor,
                     P: torch.Tensor, width: int,
                     height: int) -> torch.Tensor:
    """OcclusionFilter (OcclusionFilter.cpp:34-95): project the 3D scene
    points through the 3×4 matrix P into a width×height image and keep
    only the nearest-z point per pixel (1e-3 z tolerance).

    A z-buffer by a min-scatter over the pixel indices replaces the
    reference's sequential insert-compare loop.  As in the JAX package,
    every point within 1e-3 of its pixel's minimum survives, where the
    reference keeps whichever it met in a winning order: a superset that
    differs only inside the tolerance band."""
    z = scene3d[:, 2]
    dw, u, v = project_pixels(scene3d, P)
    proj_ok = (dw.abs() > 1e-12) & (z > 0)
    u = to_int32(u)
    v = height - 1 - to_int32(v)
    in_img = (u >= 0) & (u < width) & (v >= 0) & (v < height)
    consider = mask & proj_ok & in_img

    pix = (v.clamp(0, height - 1) * width
           + u.clamp(0, width - 1)).to(torch.int64)
    zbuf = torch.full((width * height,), 10e6, dtype=scene3d.dtype,
                      device=scene3d.device)
    zbuf.scatter_reduce_(0, pix, torch.where(consider, z, 10e6), "amin",
                         include_self=True)
    occluded = consider & (z - zbuf[pix] > 1e-3)
    return mask & ~occluded


def distance_threshold_schedule(max_dist: float, min_dist: float,
                                iterations: int, length: int = None,
                                dtype=torch.float64,
                                device=None) -> torch.Tensor:
    """The shrinking squared-distance gate of DistanceFilter
    (DistanceFilter.cpp:11-19,62-63): d²_k = maxdist² · ratio^k with
    ratio = (min/max)^(1/(it-1)), clamped at mindist² (the reference
    multiplies the squared threshold by the unsquared ratio — replicated).

    Args:
      iterations: the filter's own iteration count (only sets the shrink
        rate; the caller replicates the reference's unsigned wrap).
      length: number of ICP steps (default = iterations).
    Returns the [length] squared thresholds, computed on `device` (no host
    to device copy).
    """
    if length is None:
        length = iterations
    it = float(iterations - 1) if iterations >= 1 else 1.0
    if it == 0.0:
        # iterations == 1: pow(ratio, 1/0) = 0 for ratio < 1, so every
        # step's gate collapses to mindist^2 (DistanceFilter.cpp:11-29)
        mult = 0.0
    else:
        mult = (min_dist / max_dist) ** (1.0 / it)
    k = torch.arange(length, dtype=dtype, device=device)
    d2 = (max_dist ** 2) * torch.pow(mult, k)
    return d2.clamp(min=min_dist ** 2)


def distance_filter(dist2: torch.Tensor, pair_mask: torch.Tensor,
                    thresh2) -> torch.Tensor:
    """DistanceFilter::filter (DistanceFilter.cpp:50-61): keep pairs with
    d² <= the current threshold."""
    return pair_mask & (dist2 <= thresh2)


def reciprocal_filter(model_idx: torch.Tensor, dist2: torch.Tensor,
                      pair_mask: torch.Tensor,
                      model_size: int) -> torch.Tensor:
    """ReciprocalFilter (ReciprocalFilter.cpp:32-78): at most one pair per
    model point, the closest, ties to the smallest scene index (the
    reference's sort-by-(model, dist) + keep-first) — a segment-min scatter
    over model indices."""
    S = dist2.shape[0]
    idx = model_idx.to(torch.int64)
    scene_ids = torch.arange(S, dtype=dist2.dtype, device=dist2.device)
    d2 = torch.where(pair_mask, dist2, torch.inf)

    best = torch.full((model_size,), torch.inf, dtype=dist2.dtype,
                      device=dist2.device)
    best = best.scatter_reduce(0, idx, d2, reduce="amin")
    is_best = pair_mask & (d2 == best[idx])

    sid = torch.where(is_best, scene_ids, torch.inf)
    first = torch.full_like(best, torch.inf)
    first = first.scatter_reduce(0, idx, sid, reduce="amin")
    return is_best & (sid == first[idx])


def trimmed_filter(dist2: torch.Tensor, pair_mask: torch.Tensor,
                   overlap_percent: float) -> torch.Tensor:
    """TrimmedFilter (TrimmedFilter.cpp:21-77): keep the best
    `overlap_percent`% of the pairs by distance.

    The count to keep, floor(n · p / 100), is rounded in dist2's dtype:
    the JAX package's float32 without x64 and float64 with it (the 100
    divides as a tensor: torch on CUDA turns a division by a Python
    number into a product with its reciprocal).  The sort is stable, as
    JAX's argsort, so ties keep the lower index."""
    S = dist2.shape[0]
    d2 = torch.where(pair_mask, dist2, torch.inf)
    n = pair_mask.sum().to(dist2.dtype)
    hundred = torch.full((), 100.0, dtype=dist2.dtype, device=dist2.device)
    keep = torch.floor(n * overlap_percent / hundred).to(torch.int64)
    order = torch.argsort(d2, stable=True)
    rank = torch.empty_like(order).scatter_(
        0, order, torch.arange(S, dtype=order.dtype, device=order.device))
    return pair_mask & (rank < keep)
