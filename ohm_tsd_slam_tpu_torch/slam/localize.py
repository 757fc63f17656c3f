"""Per-robot localization step (port of ohm_tsd_slam_tpu/slam/localize.py:
all six registration modes and the odometry rescue).

The body of ThreadLocalize::eventLoop (ThreadLocalize.cpp:310-409) over
the grid state:
  * model rendering with the isocontour caster
    (grid/raycast_fast.py, the default) or the exact march  (:353)
  * scene conversion                                   (:328-329,361)
  * registration dispatch by mode (:513-591): ICP alone; a pre-match
    seeds ICP in the modes EXP, PDF, TSD (registration/ransac.py) and
    AMCL (registration/amcl.py); mode GN aligns the scene directly to the
    field (registration/gauss_newton.py) and renders no model scan
  * the optional odometry rescue (slam/odometry.py), at the reference's
    commented-out call site                           (:586-588)
  * registration error gate ‖t‖ > trnsMax or
    |sin Δφ| > rotMax → NaN pose sentinel              (:381-387,593-600)
  * pose update by right-multiplication                (:397)
  * significance gate for map updates
    (|sin Δφ| > ROT_MIN or ‖Δt‖ > TRNS_MIN)             (:402,728-736)

With `fast_raycast` the step renders with the guarded caster
`raycast_checked`, as the JAX package's does: the exact march re-renders
the scan when the fast caster lost anything to its fixed capacities, and
`rays_dropped` reports the fast caster's count.  Eagerly that guard reads
the drop count once (utils/compiled.py::when); no other part of any mode
reads the device inside the step.

`localize_step_jit` is the step compiled, as the JAX package's
`jax.jit(localize_step, static_argnames=("params",))`: on the card one
CUDA graph a key (utils/compiled.py), in every mode, the stochastic
matchers' draws included, the guard a conditional node of the graph (one
graph serves the scans that overflow and those that do not, and a replay
reads nothing back); on the CPU the eager step.  The node calls it.
"""

from __future__ import annotations

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
    bind_cache,
    is_stale,
    raycast_checked,
    strip_cache,
)
from ohm_tsd_slam_tpu_torch.grid.state import TsdGrid
from ohm_tsd_slam_tpu_torch.registration.amcl import AmclParams, match_amcl
from ohm_tsd_slam_tpu_torch.registration.gauss_newton import (
    GnParams,
    match_gauss_newton,
)
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
from ohm_tsd_slam_tpu_torch.slam import odometry
from ohm_tsd_slam_tpu_torch.slam.odometry import calc_angle_02pi
from ohm_tsd_slam_tpu_torch.utils.compiled import compiled

# the modes whose RANSAC matcher seeds ICP
_RANSAC_MODES = (int(RegMode.EXP), int(RegMode.PDF), int(RegMode.TSD))


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
    # Nonzero means the guard rendered the scan with the exact march.
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
    # direct Gauss-Newton matcher (mode GN)
    gn: GnParams = GnParams()
    # particle-filter matcher (mode AMCL)
    amcl: AmclParams = AmclParams()
    # optional odometry rescue (OdometryAnalyzer call sites,
    # ThreadLocalize.cpp:263-265,334-336,586-588)
    odom: Optional[odometry.OdomRescueParams] = None

    def __post_init__(self):
        mode = RegMode(self.mode)
        if self.mode in _RANSAC_MODES and self.ransac is None:
            raise ValueError(f"registration mode {mode.name} needs `ransac` "
                             "(LocalizeParams.from_config fills it)")
        if mode == RegMode.PDF and self.beam is None:
            raise ValueError("registration mode PDF needs `beam` "
                             "(LocalizeParams.from_config fills it)")

    @staticmethod
    def from_config(reg: RegistrationConfig, geom: SensorPolar2D,
                    bounds=None, odom_cfg: Optional[OdomRescueConfig] = None,
                    cell_size: float = 0.025) -> "LocalizeParams":
        odom_params = None
        if odom_cfg is not None and odom_cfg.use_odom_rescue:
            odom_params = odometry.OdomRescueParams(
                tf_laser=(odom_cfg.laser_x, odom_cfg.laser_y,
                          odom_cfg.laser_yaw),
                trns_vel_max=odom_cfg.trns_vel_max,
                rot_vel_max=odom_cfg.rot_vel_max,
                cell_size=cell_size,
            )
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
            amcl=AmclParams(
                particles=reg.amcl.particles,
                iterations=reg.amcl.iterations,
                sigma_trans=reg.amcl.sigma_trans,
                sigma_rot=reg.amcl.sigma_rot,
            ),
            odom=odom_params,
        )


def localize_step(grid: TsdGrid, pose: torch.Tensor,
                  last_pose: torch.Tensor, data: torch.Tensor,
                  mask: torch.Tensor, params: LocalizeParams,
                  T_prereg: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  odom_state: Optional[odometry.OdomState] = None,
                  segments: Optional[SegmentCache] = None) -> LocalizeResult:
    """One localization cycle.  With `params.fast_raycast` it reads the
    fast caster's drop count back once, for the guard (raycast_checked);
    localize_step_jit reads nothing back.

    Args:
      grid: current map state.
      pose: (3,3) current sensor pose estimate.
      last_pose: pose at the last map update (significance reference).
      data, mask: masked scan (after standard_mask / clamp_min_range).
      params: static parameters.
      T_prereg: optional externally computed seed (3,3); overrides the
        matcher dispatch (and, in mode GN, seeds ICP on the rendered
        model instead of Gauss-Newton, as in the JAX package).
      generator: the draw stream of the stochastic matchers (modes
        EXP/PDF/TSD/AMCL; doRegistration dispatch,
        ThreadLocalize.cpp:530-568), on the grid's device.  The caller
        hands every scan a fresh stream (SlamNode seeds one per robot and
        scan); in those modes a call without one (and without T_prereg)
        raises.
      odom_state: optional odometry-rescue state, updated for this scan
        (slam/odometry.py::update).  Requires params.odom; `check` is
        applied between registration and the error gate.
      segments: optional extract_segments() cache for THIS grid version
        (the node keeps one per map update); without it the fast caster
        extracts inline.  Mode GN renders nothing and ignores it.
    """
    geom = params.geom
    scene, scene_mask = data_to_cartesian(geom, data, mask)

    if params.mode == int(RegMode.GN) and T_prereg is None:
        # mode GN: Gauss-Newton against the field needs neither the model
        # scan nor pairing, so the render is skipped (and nothing dropped)
        gn = match_gauss_newton(grid, pose, scene, scene_mask, params.gn)
        return _finish(params, pose, last_pose, odom_state, gn.T,
                       gn.matches >= params.gn.min_matches, gn.matches,
                       scene_mask.sum(), gn.rms, gn.iterations,
                       torch.zeros((), dtype=torch.int64,
                                   device=scene.device))

    # the fast caster is overflow-guarded: on a capacity overflow the
    # exact march renders the scan, and the drop count is surfaced
    if params.fast_raycast:
        model = raycast_checked(grid, geom, pose, segments=segments)
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
    elif params.mode == int(RegMode.AMCL):
        T_init = match_amcl(generator, grid, pose, scene, scene_mask,
                            params.amcl)
    else:
        T_init = torch.eye(3, dtype=scene.dtype, device=scene.device)
    icp_res = icp(model.coords, model.mask, scene, scene_mask,
                  params.icp, T_init=T_init, sensor_pose=pose,
                  model_normals=model.normals)
    model_valid = model.mask.sum()
    # the raycast-degenerate guard (:354-358): no model point, no pose
    return _finish(params, pose, last_pose, odom_state, icp_res.T,
                   model_valid > 0, model_valid, scene_mask.sum(),
                   icp_res.rms, icp_res.iterations, model.n_dropped)


def _finish(params: LocalizeParams, pose, last_pose, odom_state, T,
            reg_ok, model_valid, scene_valid, rms, iterations,
            rays_dropped) -> LocalizeResult:
    """The odometry rescue, the failure gate and the pose update."""
    if params.odom is not None and odom_state is not None:
        T, _ = odometry.check(odom_state, params.odom, T)
    err = is_registration_error(T, params.trns_max, params.rot_max)
    err = err | ~reg_ok
    new_pose = torch.where(err, pose, pose @ T)
    significant = (~err) & is_pose_change_significant(
        last_pose, new_pose, params.trns_min, params.rot_min)
    return LocalizeResult(
        pose=new_pose, T=T, reg_error=err, significant=significant,
        model_valid=model_valid, scene_valid=scene_valid, rms=rms,
        icp_iterations=iterations, rays_dropped=rays_dropped)


def _step(grid: TsdGrid, pose: torch.Tensor, last_pose: torch.Tensor,
          data: torch.Tensor, mask: torch.Tensor, params: LocalizeParams,
          T_prereg: Optional[torch.Tensor],
          generator: Optional[torch.Generator],
          odom_state: Optional[odometry.OdomState],
          segments: Optional[SegmentCache], stale: bool) -> LocalizeResult:
    return localize_step(grid, pose, last_pose, data, mask, params,
                         T_prereg, generator, odom_state,
                         bind_cache(segments, grid, stale))


_step_graph = compiled(_step, static_argnames=("params", "stale"),
                       name="localize_step_jit")


def localize_step_jit(grid: TsdGrid, pose: torch.Tensor,
                      last_pose: torch.Tensor, data: torch.Tensor,
                      mask: torch.Tensor, params: LocalizeParams,
                      T_prereg: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      odom_state: Optional[odometry.OdomState] = None,
                      segments: Optional[SegmentCache] = None
                      ) -> LocalizeResult:
    """localize_step compiled (ohm_tsd_slam_tpu/slam/localize.py::
    localize_step_jit, `params` static): the same arguments and result.
    On the card the whole step (render, matcher, ICP or Gauss-Newton, the
    gates) is one graph a key, replayed with one launch; the key holds
    `params`, the shapes and dtypes, which optional argument is None and
    whether `segments` is stale for `grid` (decided here, on the caller's
    objects), never the guard's branch.  `generator`'s draws equal the
    eager step's, and it is left where the eager step leaves it."""
    stale = segments is not None and is_stale(segments, grid)
    return _step_graph(grid, pose, last_pose, data, mask, params, T_prereg,
                       generator, odom_state, strip_cache(segments), stale)


localize_step_jit.compiled = _step_graph
