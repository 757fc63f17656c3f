"""Rigid-transform estimators on masked pair sets (port of
ohm_tsd_slam_tpu/registration/estimators.py).

ClosedFormEstimator2D (ClosedFormEstimator2D.cpp) and
PointToLine2DEstimator (PointToLineEstimator2D.cpp) as pure functions
over beam-aligned tensors and pair masks.  No host sync: nothing here
reads a value back.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _masked_mean(x: torch.Tensor, mask: torch.Tensor, n: torch.Tensor):
    return torch.sum(torch.where(mask, x, 0.0)) / n


def _rigid(c: torch.Tensor, s: torch.Tensor, tx: torch.Tensor,
           ty: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros_like(c)
    one = torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, tx]),
                        torch.stack([s, c, ty]),
                        torch.stack([zero, zero, one])])


def closed_form_2d(model: torch.Tensor, scene: torch.Tensor,
                   model_idx: torch.Tensor, pair_mask: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form 2D point-to-point fit (ClosedFormEstimator2D::setPairs
    :36-67 and ::estimateTransformation :74-109) of the pairs
    (model[model_idx], scene) under pair_mask.  Returns (T, rms): the
    (3,3) transform moving the scene toward the model and the mean
    squared pair distance before it (Icp.cpp:428)."""
    return closed_form_2d_paired(model[model_idx.to(torch.int64)], scene,
                                 pair_mask)[:2]


def closed_form_2d_paired(pm: torch.Tensor, scene: torch.Tensor,
                          pair_mask: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """closed_form_2d on pre-gathered paired model points pm (S, 2).
    Returns (T, rms, n), n the pair count in pm's dtype (exact up to 2^24
    pairs in float32).

    The eight masked sums are two reductions: one over the rows [pm_x,
    pm_y, scene_x, scene_y, |pm - scene|², 1] (the centroids, rms and the
    count), one over the per-pair terms of nom and den, each formed pair
    by pair so that no difference of sums cancels.  Each row is
    contiguous, so every sum runs in the order of a lone 1-D sum: on the
    CPU the result is the eight separate sums' in every bit."""
    rr = torch.sum((pm - scene) ** 2, dim=1)
    rows = torch.cat([pm, scene, rr[:, None],
                      pair_mask[:, None].to(pm.dtype)], dim=1)
    # masked, one contiguous row a quantity: [6, S]
    rows = torch.where(pair_mask[:, None], rows, 0.0).T.contiguous()
    sums = rows.sum(1)
    # [cmx, cmy, csx, csy, rms, 1] (the last 0 without a pair)
    mean = sums / sums[5:].clamp(min=1)

    # centred rows [xf, yf, xs, ys, (unused), 0 on every pair]
    cen = rows - mean[:, None]
    fg = cen[0:2, None] * cen[None, 2:4]       # [2, 2, S]: f_i·g_j
    terms = torch.stack([fg[1, 0] - fg[0, 1],  # yf·xs − xf·ys
                         fg[0, 0] + fg[1, 1],  # xf·xs + yf·ys
                         cen[5]])
    nom_den_0 = torch.where(pair_mask, terms, 0.0).sum(1)
    # [dtheta, 0]: the 0 gives the transform's constant row exactly
    angle = torch.atan2(nom_den_0[0::2], nom_den_0[1:])
    cs, sn = torch.cos(angle), torch.sin(angle)       # [c, 1], [s, 0]
    c, s, ns = cs[0], sn[0], -sn[0]
    rot = torch.stack([c, ns, s, c]).view(2, 2)
    t = mean[0:2] - (rot * mean[2:4]).sum(1)
    T = torch.stack([c, ns, t[0], s, c, t[1], sn[1], sn[1], cs[1]])
    return T.view(3, 3), mean[4], sums[5]


def point_to_line_2d(model: torch.Tensor, normals: torch.Tensor,
                     scene: torch.Tensor, model_idx: torch.Tensor,
                     pair_mask: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Point-to-line estimator (PointToLineEstimator2D.cpp:86-157):
    linearized normal equations A·[ψ tx ty]ᵀ = b with per-pair model
    normals; RMS is the mean absolute point-to-line residual (:59-73)."""
    idx = model_idx.to(torch.int64)
    return point_to_line_2d_paired(model[idx], normals[idx], scene,
                                   pair_mask)


def point_to_line_2d_paired(pm: torch.Tensor, nrm: torch.Tensor,
                            scene: torch.Tensor, pair_mask: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """point_to_line_2d on pre-gathered paired model points/normals."""
    n = pair_mask.sum().clamp(min=1).to(pm.dtype)

    # point-to-line residual r = n · (s - m)
    r = torch.sum(nrm * (scene - pm), dim=1)
    rms = _masked_mean(r.abs(), pair_mask, n)

    # a_z = x_s * ny - y_s * nx (moment term, :111)
    a = scene[:, 0] * nrm[:, 1] - scene[:, 1] * nrm[:, 0]
    J = torch.stack([a, nrm[:, 0], nrm[:, 1]], dim=1)     # (S, 3)
    Jw = J * pair_mask[:, None].to(pm.dtype)
    A = Jw.T @ J
    b = Jw.T @ torch.where(pair_mask, -r, 0.0)
    eye = torch.eye(3, dtype=pm.dtype, device=pm.device)
    # solve_ex: no error check, so no host sync
    sol, _ = torch.linalg.solve_ex(A + 1e-12 * eye, b)
    c, s = torch.cos(sol[0]), torch.sin(sol[0])
    return _rigid(c, s, sol[1], sol[2]), rms
