"""Per-robot localization step (port of the ICP-mode path of
ohm_tsd_slam_tpu/slam/localize.py).

The body of ThreadLocalize::eventLoop (ThreadLocalize.cpp:310-409) over
the grid state:
  * model rendering with the isocontour caster
    (grid/raycast_fast.py, the default) or the exact march  (:353)
  * scene conversion                                   (:328-329,361)
  * ICP registration                                   (:513-591)
  * registration error gate ‖t‖ > trnsMax or
    |sin Δφ| > rotMax → NaN pose sentinel              (:381-387,593-600)
  * pose update by right-multiplication                (:397)
  * significance gate for map updates
    (|sin Δφ| > ROT_MIN or ‖Δt‖ > TRNS_MIN)             (:402,728-736)

`localize_step` renders with `raycast_fast` unguarded and reports what
the caster lost to its fixed capacities in `rays_dropped`; the node reads
it with the gate flags and re-runs the step with the exact march when it
is nonzero (slam/node.py), which gives the JAX package's guarded result
(`raycast_checked` there) without another read of the device.

Not ported yet (each raises NotImplementedError naming its ROADMAP.md
queue-1 item): the other registration modes and the odometry rescue.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from ohm_tsd_slam_tpu_torch.config import (
    OdomRescueConfig,
    RegistrationConfig,
    RegMode,
)
from ohm_tsd_slam_tpu_torch.grid.raycast import raycast
from ohm_tsd_slam_tpu_torch.grid.raycast_fast import (
    SegmentCache,
    raycast_fast,
)
from ohm_tsd_slam_tpu_torch.grid.state import TsdGrid
from ohm_tsd_slam_tpu_torch.registration.icp import IcpParams, icp
from ohm_tsd_slam_tpu_torch.sensor.polar2d import (
    SensorPolar2D,
    data_to_cartesian,
)

# ROADMAP.md queue 1 item that ports each registration mode other than ICP
_MODE_ITEM = {
    RegMode.EXP: "queue 1 item 12 (the other matchers)",
    RegMode.PDF: "queue 1 item 12 (the other matchers)",
    RegMode.TSD: "queue 1 item 11 (TSD mode)",
    RegMode.GN: "queue 1 item 13 (differentiable render and Gauss-Newton)",
    RegMode.AMCL: "queue 1 item 12 (the other matchers)",
}


def calc_angle_02pi(T: torch.Tensor) -> torch.Tensor:
    """ThreadLocalize::calcAngle (ThreadLocalize.cpp:715-726): angle in
    [0, 2π) from asin/acos of the rotation entries, 0 when the sign
    pattern matches neither branch (e.g. θ == 0)."""
    arcsin = torch.asin(T[1, 0].clamp(-1.0, 1.0))
    arcsineg = torch.asin(T[0, 1].clamp(-1.0, 1.0))
    arccos = torch.acos(T[0, 0].clamp(-1.0, 1.0))
    zero = torch.zeros_like(arccos)
    return torch.where((arcsin > 0.0) & (arcsineg < 0.0), arccos,
                       torch.where((arcsin < 0.0) & (arcsineg > 0.0),
                                   2.0 * math.pi - arccos, zero))


def is_registration_error(T: torch.Tensor, trns_max: float,
                          rot_max: float) -> torch.Tensor:
    """ThreadLocalize::isRegistrationError (ThreadLocalize.cpp:593-600)."""
    trns = torch.sqrt(T[0, 2] ** 2 + T[1, 2] ** 2)
    dphi = calc_angle_02pi(T)
    return (trns > trns_max) | (torch.sin(dphi).abs() > rot_max)


def is_pose_change_significant(last_pose: torch.Tensor,
                               cur_pose: torch.Tensor,
                               trns_min: float,
                               rot_min: float) -> torch.Tensor:
    """ThreadLocalize::isPoseChangeSignificant (ThreadLocalize.cpp:728-736)."""
    dx = cur_pose[0, 2] - last_pose[0, 2]
    dy = cur_pose[1, 2] - last_pose[1, 2]
    dphi = calc_angle_02pi(cur_pose) - calc_angle_02pi(last_pose)
    dphi = torch.sin(dphi).abs()
    trns = torch.sqrt(dx * dx + dy * dy)
    return (dphi > rot_min) | (trns > trns_min)


class LocalizeResult(NamedTuple):
    pose: torch.Tensor          # (3,3) updated sensor pose (unchanged on error)
    T: torch.Tensor             # (3,3) estimated scene->model transform
    reg_error: torch.Tensor     # bool — NaN-pose sentinel condition
    significant: torch.Tensor   # bool — push pose to mapper
    model_valid: torch.Tensor   # number of valid model points
    scene_valid: torch.Tensor   # number of valid scene points
    rms: torch.Tensor
    icp_iterations: torch.Tensor
    # segments or beams the fast caster lost to its fixed capacities, or
    # every beam for a stale segment cache (int64; 0 for the exact march).
    # Nonzero means the model scan may miss beams: the node re-renders
    # with the exact march.
    rays_dropped: torch.Tensor


@dataclass(frozen=True)
class LocalizeParams:
    """Static per-robot localization parameters (hashable)."""

    geom: SensorPolar2D
    icp: IcpParams
    mode: int = int(RegMode.ICP)
    trns_max: float = 0.25
    rot_max: float = 0.17
    trns_min: float = 0.05
    rot_min: float = 0.03
    # the isocontour caster (grid/raycast_fast.py) instead of the exact
    # march, as in the JAX package
    fast_raycast: bool = True

    def __post_init__(self):
        if self.mode != int(RegMode.ICP):
            mode = RegMode(self.mode)
            raise NotImplementedError(
                f"registration mode {mode.name} is not ported yet "
                f"(ROADMAP.md {_MODE_ITEM[mode]}); use ICP (0)")

    @staticmethod
    def from_config(reg: RegistrationConfig, geom: SensorPolar2D,
                    bounds=None, odom_cfg: Optional[OdomRescueConfig] = None
                    ) -> "LocalizeParams":
        if odom_cfg is not None and odom_cfg.use_odom_rescue:
            raise NotImplementedError(
                "odometry rescue is not ported yet (ROADMAP.md queue 1 "
                "item 14, runtime extras)")
        return LocalizeParams(
            geom=geom,
            icp=IcpParams.from_config(reg.icp, bounds=bounds),
            mode=int(reg.mode),
            trns_max=reg.trns_thresh,
            rot_max=reg.rot_thresh,
            trns_min=reg.trns_min,
            rot_min=reg.rot_min,
        )


def localize_step(grid: TsdGrid, pose: torch.Tensor,
                  last_pose: torch.Tensor, data: torch.Tensor,
                  mask: torch.Tensor, params: LocalizeParams,
                  segments: Optional[SegmentCache] = None) -> LocalizeResult:
    """One ICP-mode localization cycle.  Reads nothing back to the host.

    Args:
      grid: current map state.
      pose: (3,3) current sensor pose estimate.
      last_pose: pose at the last map update (significance reference).
      data, mask: masked scan (after standard_mask / clamp_min_range).
      params: static parameters.
      segments: optional extract_segments() cache for THIS grid version
        (the node keeps one per map update); without it the fast caster
        extracts inline.
    """
    geom = params.geom
    scene, scene_mask = data_to_cartesian(geom, data, mask)
    if params.fast_raycast:
        model = raycast_fast(grid, geom, pose, segments=segments)
    else:
        model = raycast(grid, geom, pose)
    T_init = torch.eye(3, dtype=scene.dtype, device=scene.device)
    icp_res = icp(model.coords, model.mask, scene, scene_mask,
                  params.icp, T_init=T_init, sensor_pose=pose,
                  model_normals=model.normals)
    model_valid = model.mask.sum()
    T = icp_res.T

    # failure gate (incl. the raycast-degenerate guard, :354-358) + pose
    # update
    err = is_registration_error(T, params.trns_max, params.rot_max)
    err = err | (model_valid == 0)
    new_pose = torch.where(err, pose, pose @ T)
    significant = (~err) & is_pose_change_significant(
        last_pose, new_pose, params.trns_min, params.rot_min)
    return LocalizeResult(
        pose=new_pose, T=T, reg_error=err, significant=significant,
        model_valid=model_valid, scene_valid=scene_mask.sum(),
        rms=icp_res.rms, icp_iterations=icp_res.iterations,
        rays_dropped=model.n_dropped)
