"""Odometry rescue (port of ohm_tsd_slam_tpu/slam/odometry.py).

OdometryAnalyzer (src/OdometryAnalyzer.{h,cpp}): replaces an implausible
scan-match transform with the odometry delta.  In the reference the module
is compiled but disconnected (every call site commented out,
ThreadLocalize.cpp:196,233,263-265,334-336,586-588); here, as in the JAX
package, it is a working optional stage.

The caller supplies odometry poses ((3,3) SE(2), base frame) with their
stamps; the rescue state is an explicit `OdomState` threaded through
`update`.  Every function keeps its inputs' dtype and device and reads
nothing back to the host.

Documented divergence, as in the JAX package: odomRescueCheck's velocity
gates are short-circuited to `if(1)` in the reference
(OdometryAnalyzer.cpp:212-216), so the checked-in code always replaces
T_slam when called.  `check` applies the intended gates
(dtrans > cellSize/2 and (drot > rot_vel_max·dt or vtrans > trns_vel_max)),
which the commented-out conditions spell out; `always_rescue=True` gives
the reference's literal behaviour.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from ohm_tsd_slam_tpu_torch.core import se2

# defaults shared with ThreadLocalize (ThreadLocalize.h:56-71)
TRNS_VEL_MAX = 1.5
ROT_VEL_MAX = 6.28

_STATE_FIELDS = ("odom_old", "rel_odom", "stamp_old", "dt", "valid")


def calc_angle_02pi(T: torch.Tensor) -> torch.Tensor:
    """ThreadLocalize::calcAngle (ThreadLocalize.cpp:715-726), which
    OdometryAnalyzer::calcAngle (OdometryAnalyzer.cpp:225-245) duplicates:
    the angle in [0, 2π) from asin/acos of the rotation entries, 0 when the
    sign pattern matches neither branch (e.g. θ == 0)."""
    arcsin = torch.asin(T[1, 0].clamp(-1.0, 1.0))
    arcsineg = torch.asin(T[0, 1].clamp(-1.0, 1.0))
    arccos = torch.acos(T[0, 0].clamp(-1.0, 1.0))
    zero = torch.zeros_like(arccos)
    return torch.where((arcsin > 0.0) & (arcsineg < 0.0), arccos,
                       torch.where((arcsin < 0.0) & (arcsineg > 0.0),
                                   2.0 * math.pi - arccos, zero))


def _scalar(value, dtype, device) -> torch.Tensor:
    """A 0-dim tensor of `value` (a Python number or a 0-dim tensor),
    filled on `device` rather than copied from the host."""
    if isinstance(value, torch.Tensor):
        return value.to(dtype=dtype, device=device)
    return torch.full((), value, dtype=dtype, device=device)


class OdomState(NamedTuple):
    """The rescue state (_tfOdomOld, _tfRelativeOdom, _stampLaserOld of
    the reference)."""

    odom_old: torch.Tensor      # (3,3) last odometry pose
    rel_odom: torch.Tensor      # (3,3) odom(t-1)^-1 · odom(t)
    stamp_old: torch.Tensor     # 0-dim seconds (previous scan stamp)
    dt: torch.Tensor            # 0-dim seconds between the last two scans
    valid: torch.Tensor         # 0-dim bool — _odomTfIsValid


@dataclass(frozen=True)
class OdomRescueParams:
    """Static parameters (OdometryAnalyzer.cpp:28-48)."""

    # the laser in the base frame (x, y, yaw)
    tf_laser: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    trns_vel_max: float = TRNS_VEL_MAX    # "max_velocity_lin"
    rot_vel_max: float = ROT_VEL_MAX      # "max_velocity_rot"
    cell_size: float = 0.025
    always_rescue: bool = False           # reference's literal if(1) paths


def init(params: OdomRescueParams, odom_pose: torch.Tensor,
         stamp: float) -> OdomState:
    """odomRescueInit (OdometryAnalyzer.cpp:65-111): capture the first
    odometry pose; the static laser transform lives in `params`."""
    dtype, dev = odom_pose.dtype, odom_pose.device
    return OdomState(
        odom_old=odom_pose,
        rel_odom=torch.eye(3, dtype=dtype, device=dev),
        stamp_old=_scalar(stamp, dtype, dev),
        dt=_scalar(1e-6, dtype, dev),
        valid=_scalar(False, torch.bool, dev),
    )


def update(state: OdomState, odom_pose: torch.Tensor, stamp,
           odom_ok: bool = True) -> OdomState:
    """odomRescueUpdate (OdometryAnalyzer.cpp:113-151): record the
    odometry delta since the previous scan and push the state ahead.
    `odom_ok=False` marks a failed odometry lookup (a tf timeout in the
    reference): the rescue is off for this cycle."""
    rel = se2.invert(state.odom_old) @ odom_pose
    stamp = _scalar(stamp, state.stamp_old.dtype, state.stamp_old.device)
    return OdomState(
        odom_old=odom_pose,
        rel_odom=rel,
        stamp_old=stamp,
        dt=(stamp - state.stamp_old).clamp(min=1e-6),
        valid=_scalar(bool(odom_ok), torch.bool, stamp.device),
    )


def check(state: OdomState, params: OdomRescueParams,
          T_slam: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """odomRescueCheck (OdometryAnalyzer.cpp:153-223): transform T_slam
    into the footprint frame (T_fp = tfLaser · T · tfLaser⁻¹), derive
    velocities over the inter-scan dt recorded by `update`, and when
    implausible replace it with tfLaser⁻¹ · relOdom · tfLaser.

    Returns (T_out, rescued)."""
    tl = se2.make(*params.tf_laser, dtype=T_slam.dtype, device=T_slam.device)
    tl_inv = se2.invert(tl)

    T_fp = tl @ T_slam @ tl_inv
    dt = state.dt
    dtrans = torch.sqrt(T_fp[0, 2] ** 2 + T_fp[1, 2] ** 2)
    drot = calc_angle_02pi(T_fp)
    drot = torch.minimum(drot, 2.0 * math.pi - drot)   # rotation magnitude
    vtrans = dtrans / dt

    implausible = ((dtrans > params.cell_size * 0.5)
                   & ((drot > params.rot_vel_max * dt)
                      | (vtrans > params.trns_vel_max)))
    rescued = state.valid & (implausible | params.always_rescue)

    T_odom = tl_inv @ state.rel_odom @ tl
    return torch.where(rescued, T_odom, T_slam), rescued


def to_arrays(state: OdomState) -> Dict[str, np.ndarray]:
    """The state as numpy arrays (the counterpart of
    grid/state.py::to_arrays): a checkpoint, or a state handed across to
    or from the JAX package."""
    return {f: getattr(state, f).detach().cpu().numpy()
            for f in _STATE_FIELDS}


def from_arrays(d: Dict[str, object], dtype=None, device=None) -> OdomState:
    """An OdomState from numpy arrays (or anything torch.as_tensor takes),
    keyed as `to_arrays` writes them; `dtype` (default: that of
    `odom_old`) applies to every field but `valid`."""
    odom_old = torch.as_tensor(np.array(d["odom_old"]), device=device)
    dtype = dtype or odom_old.dtype
    return OdomState(
        **{f: torch.as_tensor(np.array(d[f]), dtype=dtype, device=device)
           for f in _STATE_FIELDS[:-1]},
        valid=torch.as_tensor(np.array(d["valid"]), dtype=torch.bool,
                              device=device))
