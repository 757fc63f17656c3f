"""Direct scan-to-map registration: Gauss-Newton on the TSD field (port of
ohm_tsd_slam_tpu/registration/gauss_newton.py, registration mode GN).

No analogue in the reference.  Where the reference renders a model scan
(RayCastPolar2D), pairs nearest neighbours (FlannPairAssignment) and fits a
rigid transform per ICP iteration (ClosedFormEstimator2D), this matcher
aligns the scene scan directly against the TSD field: the truncated signed
distance at a transformed scene point is the point-to-surface residual,
and its bilinear spatial gradient is the residual's Jacobian.  One
iteration is a few element-wise passes over the scene points and a 3x3
solve: no raycast, no nearest-neighbour search, no pair filtering.  The
objective is that of TSD_PDFMatching's candidate rating
(TSD_PDFMatching.cpp:223-251), optimized with second-order steps instead
of sampling.

Conventions as in ICP (registration/icp.py): scene points in the sensor
frame, `sensor_pose` maps sensor to world, and the returned T is the
sensor-frame correction (new pose = pose @ T, ThreadLocalize.cpp:397).

What differs from the JAX module: the `lax.scan` over the iterations is a
Python loop over fixed shapes; the damped 3x3 system is solved in closed
form (Cramer's rule; `torch.linalg.solve` checks for a singular matrix and
so waits for the card), and nothing is read back to the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ohm_tsd_slam_tpu_torch.core import se2
from ohm_tsd_slam_tpu_torch.grid.state import TsdGrid
from ohm_tsd_slam_tpu_torch.utils.compiled import compiled


class GnResult(NamedTuple):
    T: torch.Tensor           # (3,3) scene->model correction (sensor frame)
    rms: torch.Tensor         # weighted RMS of the final TSD residual [m]
    matches: torch.Tensor     # number of scene points on informative field
    iterations: torch.Tensor  # iterations executed (== params.iterations)


@dataclass(frozen=True)
class GnParams:
    """Static Gauss-Newton parameters (hashable)."""

    iterations: int = 30
    damping: float = 1e-4        # Levenberg diagonal damping (relative)
    huber_delta: float = 0.3     # Huber threshold on the residual [m]
    min_matches: int = 10        # below this, return identity


def _field_value_grad(grid: TsdGrid, x: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """Bilinear TSD value and its exact spatial gradient at world points.

    Same cell convention as TsdGrid::coord2Cell (TsdGrid.h:306-340); the
    gradient is the analytic derivative of the bilinear surface (the
    reference's interpolateNormal central differences approximate it,
    TsdGrid.cpp:517-546).  A NaN tap invalidates the point.
    """
    tsd = grid.tsd
    H, W = tsd.shape
    s = grid.cell_size
    u = x[..., 0] / s - 0.5
    v = x[..., 1] / s - 0.5
    ix = torch.floor(u).to(torch.int64)
    iy = torch.floor(v).to(torch.int64)
    wx = u - ix.to(u.dtype)
    wy = v - iy.to(v.dtype)
    valid = (ix >= 0) & (ix < W - 1) & (iy >= 0) & (iy < H - 1)
    flat = tsd.reshape(-1)
    base = iy.clamp(0, H - 2) * W + ix.clamp(0, W - 2)
    v00 = flat[base]
    v10 = flat[base + W]
    v01 = flat[base + 1]
    v11 = flat[base + W + 1]
    finite = ~(torch.isnan(v00) | torch.isnan(v10) | torch.isnan(v01)
               | torch.isnan(v11))
    v00, v10, v01, v11 = (torch.nan_to_num(t, nan=0.0)
                          for t in (v00, v10, v01, v11))
    val = (v00 * (1.0 - wy) * (1.0 - wx) + v10 * wy * (1.0 - wx)
           + v01 * (1.0 - wy) * wx + v11 * wy * wx)
    gx = ((v01 - v00) * (1.0 - wy) + (v11 - v10) * wy) / s
    gy = ((v10 - v00) * (1.0 - wx) + (v11 - v01) * wx) / s
    return val, gx, gy, valid & finite


def _solve3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A⁻¹ b for a (3,3) A by Cramer's rule: a few element-wise ops, no
    singularity check that would read the device (the damped GN system is
    positive definite)."""
    def det(c0, c1, c2):
        return (c0[0] * (c1[1] * c2[2] - c1[2] * c2[1])
                - c1[0] * (c0[1] * c2[2] - c0[2] * c2[1])
                + c2[0] * (c0[1] * c1[2] - c0[2] * c1[1]))

    c0, c1, c2 = A[:, 0], A[:, 1], A[:, 2]
    d = det(c0, c1, c2)
    return torch.stack([det(b, c1, c2), det(c0, b, c2), det(c0, c1, b)]) / d


def match_gauss_newton(grid: TsdGrid, sensor_pose: torch.Tensor,
                       scene: torch.Tensor, scene_mask: torch.Tensor,
                       params: GnParams,
                       T_init: Optional[torch.Tensor] = None,
                       field_fn: Optional[Callable] = None,
                       reduce_fn: Optional[Callable] = None,
                       max_truncation: Optional[float] = None) -> GnResult:
    """Align `scene` (sensor frame, [B,2]) to the TSD surface.

    Args:
      grid: map state (may be None when `field_fn` is given).
      sensor_pose: (3,3) current sensor pose (sensor -> world).
      scene: (B,2) scene points in the sensor frame.
      scene_mask: (B,) validity.
      params: static parameters.
      T_init: optional (3,3) sensor-frame seed (e.g. a RANSAC pre-match).
      field_fn: optional `x [B,2] -> (val, gx, gy, ok)` replacing the
        grid taps: the row-sharded path plugs its shard-local evaluation
        in here (parallel/shard_matchers.py); `ok` must then be False for
        points the shard does not own.
      reduce_fn: optional reduction of each iteration's normal equations
        (H [3,3], b [3], n, wsum, wee), returning the same tuple: a sum
        over the mesh in the sharded path.
      max_truncation: the grid's, where `grid` is None.

    Returns:
      GnResult with the sensor-frame correction T (new pose = pose @ T).
    """
    dtype = scene.dtype if grid is None else grid.tsd.dtype
    dev = scene.device
    scene = scene.to(dtype)
    pose = sensor_pose.to(dtype)
    trunc = grid.max_truncation if max_truncation is None else max_truncation
    if field_fn is None:
        def field_fn(x):
            return _field_value_grad(grid, x)
    eye = torch.eye(3, dtype=dtype, device=dev)
    M = pose @ (eye if T_init is None else T_init.to(dtype))

    delta = params.huber_delta
    w_scene = scene_mask.to(dtype)
    for _ in range(params.iterations):
        x = se2.transform_points(M, scene)               # [B,2] world
        val, gx, gy, ok = field_fn(x)
        e = val * trunc                                  # residual [m]
        g = torch.stack([gx, gy], dim=-1) * trunc        # d e / d x

        # informative points: on a field slope (the saturated ±1 plateaus
        # far from any surface have zero gradient and contribute nothing)
        gnorm2 = (g * g).sum(-1)
        w = w_scene * ok.to(dtype) * (gnorm2 > 1e-12).to(dtype)

        # Huber reweighting
        abs_e = e.abs()
        w = w * torch.where(abs_e <= delta, 1.0,
                            delta / abs_e.clamp(min=1e-12))

        # rotate about the current sensor position (world)
        c = M[:2, 2]
        px = x[:, 0] - c[0]
        py = x[:, 1] - c[1]
        J = torch.stack([g[:, 0], g[:, 1],
                         -g[:, 0] * py + g[:, 1] * px], dim=-1)  # [B,3]

        Jw = J * w[:, None]
        Hm = J.T @ Jw                                    # 3x3
        b = Jw.T @ e                                     # 3
        n = (w > 0).sum()
        wsum = w.sum()
        wee = (w * e * e).sum()
        if reduce_fn is not None:
            Hm, b, n, wsum, wee = reduce_fn((Hm, b, n, wsum, wee))
        Hd = (Hm + params.damping * torch.diag(Hm.diagonal().clamp(min=1e-12))
              + 1e-12 * eye)
        step = _solve3(Hd, -b)
        step = torch.where(n >= params.min_matches, step,
                           torch.zeros_like(step))

        dtheta = step[2]
        cth, sth = torch.cos(dtheta), torch.sin(dtheta)
        R = torch.stack([torch.stack([cth, -sth]), torch.stack([sth, cth])])
        t = c - R @ c + step[:2]
        zero, one = torch.zeros_like(cth), torch.ones_like(cth)
        Tw = torch.stack([torch.stack([cth, -sth, t[0]]),
                          torch.stack([sth, cth, t[1]]),
                          torch.stack([zero, zero, one])])
        M = Tw @ M
        rms = torch.sqrt(wee / wsum.clamp(min=1e-12))
    T = se2.invert(pose) @ M
    return GnResult(T=T, rms=rms, matches=n,
                    iterations=torch.full((), params.iterations,
                                          dtype=torch.int64, device=dev))


# match_gauss_newton compiled (ohm_tsd_slam_tpu/registration/
# gauss_newton.py::match_gauss_newton_jit): on the card one CUDA graph of
# the iterations a key (`field_fn` and `reduce_fn` key it by identity);
# eager on the CPU
match_gauss_newton_jit = compiled(match_gauss_newton,
                                  static_argnames=("params",))
