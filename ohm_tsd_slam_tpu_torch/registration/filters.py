"""ICP pre/post filters as pure mask transforms (port of the parts of
ohm_tsd_slam_tpu/registration/filters.py that ICP mode uses).

A pair set is the triple (model_idx[S], dist2[S], pair_mask[S]) aligned to
the scene points (reference: src/obvision/registration/icp/assign/filter/).
"""

from __future__ import annotations

import torch

from ohm_tsd_slam_tpu_torch.core import se2


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
