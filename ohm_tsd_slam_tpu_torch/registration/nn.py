"""Pair assignment (port of ohm_tsd_slam_tpu/registration/nn.py):
brute-force nearest neighbours (nearest_neighbors, assign_pairs_fused and
its plain twin assign_pairs_plain) and projective association of 3D
clouds (projective_pairs_3d).

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
    """One fused ICP pair assignment (see assign_pairs_plain): on CUDA
    tensors the kernel of csrc/assign_pairs.cu (ops/assign_pairs_cuda.py),
    equal to assign_pairs_plain on the card in every bit; on the CPU
    assign_pairs_plain.  thresh2 is None, a number or a one-element tensor
    (read on the device, so a graph replays each iteration's own gate)."""
    from ohm_tsd_slam_tpu_torch.ops.assign_pairs_cuda import assign_pairs

    return assign_pairs(model, model_mask, scene, scene_mask, payload,
                        thresh2, use_reciprocal)


def assign_pairs_plain(model: torch.Tensor, model_mask: torch.Tensor,
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


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """Whole floats to int32 as XLA converts them: NaN to 0, values out of
    range saturated (torch's cast leaves both undefined)."""
    x = torch.where(torch.isnan(x), 0.0, x).clamp(-2 ** 31, 2 ** 31 - 1)
    return x.to(torch.int64).clamp(-2 ** 31, 2 ** 31 - 1).to(torch.int32)


def project_pixels(pts: torch.Tensor, P: torch.Tensor):
    """(dw, floor(du + 0.5), floor(dv + 0.5)) of [N, 3] points through the
    3×4 projection P: du = (P[0]·(x, y, z, 1)) / dw and dv likewise, in the
    JAX package's order of operations."""
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    dw = P[2, 0] * x + P[2, 1] * y + P[2, 2] * z + P[2, 3]
    du = (P[0, 0] * x + P[0, 1] * y + P[0, 2] * z + P[0, 3]) / dw
    dv = (P[1, 0] * x + P[1, 1] * y + P[1, 2] * z + P[1, 3]) / dw
    return dw, torch.floor(du + 0.5), torch.floor(dv + 0.5)


def projective_pairs_3d(model: torch.Tensor, scene: torch.Tensor,
                        scene_mask: torch.Tensor, P: torch.Tensor,
                        width: int, height: int):
    """Projective data association (ProjectivePairAssignment.cpp:28-97):
    the model points rasterised into a width×height index image through
    the 3×4 projection P; each scene point projects to a pixel and pairs
    with the model point stored there.

    The rasterisation is a max-scatter into a zeroed image (the
    reference's sequential overwrite keeps the last-written point, `amax`
    the highest index: one of the writers, deterministic).  The reference
    reads an image value of 0 as "no model point", so model point 0 can
    never be matched (quirk replicated).

    Returns (model_idx [S] int32, dist2 [S], pair_mask [S])."""
    def project(pts):
        dw, u, v = project_pixels(pts, P)
        u, v = to_int32(u), to_int32(v)
        inb = (u >= 0) & (v >= 0) & (u < width) & (v < height)
        pix = v.clamp(0, height - 1) * width + u.clamp(0, width - 1)
        return pix.to(torch.int64), (dw.abs() > 1e-9) & inb

    m_pix, m_ok = project(model)
    img = torch.zeros(width * height, dtype=torch.int32, device=model.device)
    ids = torch.arange(model.shape[0], dtype=torch.int32, device=model.device)
    img.scatter_reduce_(0, m_pix, torch.where(m_ok, ids, 0), "amax",
                        include_self=True)

    s_pix, s_ok = project(scene)
    idx_m = img[s_pix]
    pair = scene_mask & s_ok & (idx_m != 0)
    d = scene - model[idx_m.to(torch.int64)]
    # the sum over x, y, z in a fixed order, the same on every device
    d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
    return idx_m, torch.where(pair, d2, torch.inf), pair
