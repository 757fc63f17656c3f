"""Brute-force nearest-neighbour pair assignment (port of
ohm_tsd_slam_tpu/registration/nn.py::nearest_neighbors and
::assign_pairs_fused).

At scan sizes (~1081 points) an exact dense [S, M] distance matrix is the
fast path; invalid points are excluded by +inf masking, not compaction.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _dist2(model: torch.Tensor, model_mask: torch.Tensor,
           scene: torch.Tensor) -> torch.Tensor:
    """d²(s, m) = |s|² + |m|² − 2·s·mᵀ, clamped at 0, +inf for invalid
    model points.  The K=2 product is written out so that it keeps full
    precision on every device."""
    s2 = torch.sum(scene * scene, dim=1, keepdim=True)          # [S,1]
    m2 = torch.sum(model * model, dim=1)[None, :]               # [1,M]
    cross = (scene[:, 0:1] * model[None, :, 0]
             + scene[:, 1:2] * model[None, :, 1])               # [S,M]
    d2 = (s2 + m2 - 2.0 * cross).clamp(min=0.0)
    return torch.where(model_mask[None, :], d2, torch.inf)


def nearest_neighbors(model: torch.Tensor, model_mask: torch.Tensor,
                      scene: torch.Tensor, scene_mask: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact 1-NN from every scene point into the valid model set
    (FlannPairAssignment::determinePairs, FlannPairAssignment.cpp:94-144).

    Returns idx (S,) int32 nearest model index (first minimum) and dist2
    (S,) squared distance (+inf where the scene point is invalid)."""
    d2 = _dist2(model, model_mask, scene)
    best, idx = torch.min(d2, dim=1)
    best = torch.where(scene_mask, best, torch.inf)
    return idx.to(torch.int32), best


def assign_pairs_fused(model: torch.Tensor, model_mask: torch.Tensor,
                       scene: torch.Tensor, scene_mask: torch.Tensor,
                       payload: torch.Tensor, thresh2=None,
                       use_reciprocal: bool = True):
    """One fused ICP pair assignment on the [S, M] distance matrix: 1-NN
    (first minimum) + distance gate + reciprocal rule (a pair survives iff
    it is its row's and, among selected cells, its column's minimum, ties
    to the smallest scene index) + the paired payload rows.

    Equal to nearest_neighbors + filters.distance_filter +
    filters.reciprocal_filter + payload[idx] (FlannPairAssignment +
    DistanceFilter.cpp:50-61 + ReciprocalFilter.cpp:33-77).  The JAX
    package's one-hot payload matmul is an index gather here: exact
    either way.

    Returns idx (S,) int32, dist2 (S,) row-best squared distance (+inf for
    invalid scene points), pair_mask (S,), paired (S, K) payload rows
    (zeros outside pair_mask).
    """
    S, M = scene.shape[0], model.shape[0]
    dev = scene.device
    d2 = _dist2(model, model_mask, scene)

    best = d2.amin(dim=1)                                       # [S]
    # first-minimum index: min of the masked column iota
    iota_m = torch.arange(M, dtype=torch.int32, device=dev)[None, :]
    idx = torch.where(d2 == best[:, None], iota_m, M).amin(dim=1)
    idx = idx.clamp(max=M - 1)

    pmask = scene_mask & torch.isfinite(best)
    if thresh2 is not None:
        pmask = pmask & (best <= thresh2)

    if use_reciprocal:
        # column rule over the selected cells only: the selected cell of
        # row s is (s, idx[s]), so column minima are a segment min
        idx64 = idx.to(torch.int64)
        dsel = torch.where(pmask, best, torch.inf)
        col_best = torch.full((M,), torch.inf, dtype=best.dtype, device=dev)
        col_best = col_best.scatter_reduce(0, idx64, dsel, reduce="amin")
        is_best = pmask & (dsel == col_best[idx64])
        iota_s = torch.arange(S, dtype=best.dtype, device=dev)
        sid = torch.where(is_best, iota_s, torch.inf)
        first = torch.full_like(col_best, torch.inf)
        first = first.scatter_reduce(0, idx64, sid, reduce="amin")
        pmask = is_best & (sid == first[idx64])

    paired = torch.where(pmask[:, None], payload[idx.to(torch.int64)], 0.0)
    return (idx, torch.where(scene_mask, best, torch.inf), pmask,
            paired.to(scene.dtype))
