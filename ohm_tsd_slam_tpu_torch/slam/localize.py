"""Per-robot localization step (port of ohm_tsd_slam_tpu/slam/localize.py
for the registration modes ICP, EXP, PDF and TSD).

The body of ThreadLocalize::eventLoop (ThreadLocalize.cpp:310-409) over
the grid state:
  * model rendering with the isocontour caster
    (grid/raycast_fast.py, the default) or the exact march  (:353)
  * scene conversion                                   (:328-329,361)
  * registration dispatch by mode: a RANSAC matcher's
    transform (registration/ransac.py) seeds ICP       (:513-591)
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
queue-1 item): the modes GN and AMCL and the odometry rescue.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from ohm_tsd_slam_tpu_torch.config import (
    BeamModelConfig,
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
from ohm_tsd_slam_tpu_torch.registration.ransac import (
    RansacParams,
    match_normal,
    match_pdf,
    match_tsd,
)
from ohm_tsd_slam_tpu_torch.sensor.polar2d import (
    SensorPolar2D,
    data_to_cartesian,
)

# ROADMAP.md queue 1 item that ports each registration mode still missing
_MODE_ITEM = {
    RegMode.GN: "queue 1 item 13 (differentiable render and Gauss-Newton)",
    RegMode.AMCL: "queue 1 item 12 (the other matchers)",
}
# the modes whose RANSAC matcher seeds ICP
_RANSAC_MODES = (int(RegMode.EXP), int(RegMode.PDF), int(RegMode.TSD))


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
    # RANSAC pre-registration parameters (modes EXP/PDF/TSD) and the beam
    # model of PDF; from_config fills both
    ransac: Optional[RansacParams] = None
    beam: Optional[BeamModelConfig] = None

    def __post_init__(self):
        mode = RegMode(self.mode)
        if mode in _MODE_ITEM:
            raise NotImplementedError(
                f"registration mode {mode.name} is not ported yet "
                f"(ROADMAP.md {_MODE_ITEM[mode]}); use ICP (0), EXP (1), "
                "PDF (2) or TSD (3)")
        if self.mode in _RANSAC_MODES and self.ransac is None:
            raise ValueError(f"registration mode {mode.name} needs `ransac` "
                             "(LocalizeParams.from_config fills it)")
        if mode == RegMode.PDF and self.beam is None:
            raise ValueError("registration mode PDF needs `beam` "
                             "(LocalizeParams.from_config fills it)")

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
            ransac=RansacParams.from_config(reg.ransac, geom.angular_res),
            beam=reg.beam_model,
        )


def localize_step(grid: TsdGrid, pose: torch.Tensor,
                  last_pose: torch.Tensor, data: torch.Tensor,
                  mask: torch.Tensor, params: LocalizeParams,
                  T_prereg: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  segments: Optional[SegmentCache] = None) -> LocalizeResult:
    """One localization cycle.  Reads nothing back to the host.

    Args:
      grid: current map state.
      pose: (3,3) current sensor pose estimate.
      last_pose: pose at the last map update (significance reference).
      data, mask: masked scan (after standard_mask / clamp_min_range).
      params: static parameters.
      T_prereg: optional externally computed RANSAC seed (3,3); overrides
        the matcher dispatch.
      generator: the draw stream of the stochastic matchers (modes
        EXP/PDF/TSD; doRegistration dispatch, ThreadLocalize.cpp:530-568),
        on the grid's device.  The caller hands every scan a fresh stream
        (SlamNode seeds one per robot and scan); in those modes a call
        without one (and without T_prereg) raises.
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

    # registration: pre-match seed + ICP refinement
    if T_prereg is not None:
        T_init = T_prereg
    elif params.mode == int(RegMode.EXP):
        T_init = match_normal(generator, model.coords, model.mask,
                              scene, scene_mask, params.ransac)
    elif params.mode == int(RegMode.PDF):
        T_init = match_pdf(generator, model.coords, model.mask,
                           scene, scene_mask, params.ransac, params.beam)
    elif params.mode == int(RegMode.TSD):
        T_init = match_tsd(generator, grid, pose, model.coords, model.mask,
                           scene, scene_mask, params.ransac)
    else:
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
