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
                                 pair_mask)


def closed_form_2d_paired(pm: torch.Tensor, scene: torch.Tensor,
                          pair_mask: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """closed_form_2d on pre-gathered paired model points pm (S, 2)."""
    n = pair_mask.sum().clamp(min=1).to(pm.dtype)

    rms = _masked_mean(torch.sum((pm - scene) ** 2, dim=1), pair_mask, n)

    cmx = _masked_mean(pm[:, 0], pair_mask, n)
    cmy = _masked_mean(pm[:, 1], pair_mask, n)
    csx = _masked_mean(scene[:, 0], pair_mask, n)
    csy = _masked_mean(scene[:, 1], pair_mask, n)

    xf = pm[:, 0] - cmx
    yf = pm[:, 1] - cmy
    xs = scene[:, 0] - csx
    ys = scene[:, 1] - csy
    nom = torch.sum(torch.where(pair_mask, yf * xs - xf * ys, 0.0))
    den = torch.sum(torch.where(pair_mask, xf * xs + yf * ys, 0.0))
    dtheta = torch.atan2(nom, den)

    c, s = torch.cos(dtheta), torch.sin(dtheta)
    dx = cmx - (c * csx - s * csy)
    dy = cmy - (c * csy + s * csx)
    return _rigid(c, s, dx, dy), rms


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
