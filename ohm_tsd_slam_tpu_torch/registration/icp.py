"""ICP engine (port of ohm_tsd_slam_tpu/registration/icp.py).

The reference's Icp class (src/obvision/registration/icp/Icp.cpp) as one
loop body over fixed-shape masks.  The JAX package runs it as a
`lax.scan` whose carry freezes once the reference would have left its
while loop (Icp.cpp:493-508); here it is a Python loop over all
`iterations` with the same frozen carry.  The loop never reads a value
back to the host, so it queues its work without a sync.

Semantics replicated:
  * rms <= maxRMS / rms plateau (|Δrms| < 10e-10 for conv_cnt
    iterations) / max-iteration exits (Icp.cpp:480-511)
  * step: assign → filters → estimator RMS → estimate → apply →
    Tfinal = Tlast·Tfinal (Icp.cpp:410-462), NOTMATCHABLE under 3 pairs
  * the shrinking distance gate restarts each registration
    (Icp.cpp:333-339)
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch

from ohm_tsd_slam_tpu_torch.config import IcpConfig
from ohm_tsd_slam_tpu_torch.core import se2
from ohm_tsd_slam_tpu_torch.registration import filters as flt
from ohm_tsd_slam_tpu_torch.registration.estimators import (
    closed_form_2d,
    closed_form_2d_paired,
    point_to_line_2d,
    point_to_line_2d_paired,
)
from ohm_tsd_slam_tpu_torch.registration.nn import (
    assign_pairs_fused,
    nearest_neighbors,
)
from ohm_tsd_slam_tpu_torch.utils.compiled import compiled


class IcpState(enum.IntEnum):
    """EnumIcpState (Icp.h:25-32)."""

    IDLE = 0
    PROCESSING = 1
    NOTMATCHABLE = 2
    MAXITERATIONS = 3
    TIMEELAPSED = 4
    SUCCESS = 5
    CONVERGED = 6
    ERROR = 7


class IcpResult(NamedTuple):
    T: torch.Tensor            # (3,3) final scene->model transform
    rms: torch.Tensor          # last RMS (mean squared pair distance)
    pairs: torch.Tensor        # last pair count
    iterations: torch.Tensor   # iterations executed
    state: torch.Tensor        # IcpState code
    rms_history: torch.Tensor  # per iteration (NaN after exit)
    pair_history: torch.Tensor  # per iteration (0 after exit)
    # per-iteration pair assignments ([iters, S] model index / active
    # mask), filled when IcpParams.record_pairs (Trace's addAssignment
    # pair payload, Trace.cpp:123-142)
    pair_idx_history: Optional[torch.Tensor] = None
    pair_mask_history: Optional[torch.Tensor] = None
    # per-iteration accumulated transforms ([iters, 3, 3]; frozen copies
    # of T after exit), filled when IcpParams.record_T: the golden
    # per-iteration diff against the compiled reference (Icp.cpp:493-508)
    T_history: Optional[torch.Tensor] = None


@dataclass(frozen=True)
class IcpParams:
    """Static ICP parameters (hashable)."""

    iterations: int = 25
    max_rms: float = 0.0
    convergence_count: int = 5
    conv_eps: float = 10e-10          # rms-plateau epsilon (Icp.cpp:498)
    dist_min: float = 0.2
    dist_max: float = 1.0
    # the DistanceFilter's own iteration count (None = iterations); see
    # from_config for the reference's unsigned wrap
    dist_iterations: Optional[int] = None
    use_distance_filter: bool = True
    use_reciprocal_filter: bool = True
    # grid AABB for the out-of-bounds prefilter (ThreadLocalize.cpp:218)
    bounds: Optional[Tuple[float, float, float, float]] = None
    # "closed_form" (ClosedFormEstimator2D, the reference default) or
    # "point_to_line" (PointToLine2DEstimator; needs model normals)
    estimator: str = "closed_form"
    # record per-iteration pair assignments for the Trace subsystem
    # (costly: [iters, S] extra outputs; off by default)
    record_pairs: bool = False
    # record per-iteration accumulated transforms (golden parity diff)
    record_T: bool = False
    # fused pair assignment (nn.assign_pairs_fused) instead of the modular
    # nearest_neighbors + filter chain; equal results
    fused: bool = True

    @staticmethod
    def from_config(cfg: IcpConfig, bounds=None) -> "IcpParams":
        # ThreadLocalize's stack: DistanceFilter(max, min,
        # (unsigned)(icpIterations - 10)), convergence counter =
        # icpIterations (ThreadLocalize.cpp:213,226)
        dist_it = cfg.dist_iterations
        if dist_it is None:
            dist_it = (cfg.iterations - 10) & 0xFFFFFFFF
        conv = cfg.convergence_count
        if conv is None:
            conv = cfg.iterations
        return IcpParams(
            iterations=cfg.iterations,
            max_rms=cfg.max_rms,
            convergence_count=conv,
            dist_min=cfg.dist_filter_min,
            dist_max=cfg.dist_filter_max,
            dist_iterations=dist_it,
            use_distance_filter=cfg.use_distance_filter,
            use_reciprocal_filter=cfg.use_reciprocal_filter,
            bounds=bounds,
            estimator=cfg.estimator,
        )


def icp(model: torch.Tensor, model_mask: torch.Tensor,
        scene: torch.Tensor, scene_mask: torch.Tensor,
        params: IcpParams,
        T_init: Optional[torch.Tensor] = None,
        sensor_pose: Optional[torch.Tensor] = None,
        model_normals: Optional[torch.Tensor] = None) -> IcpResult:
    """Register `scene` onto `model`.

    Args:
      model: (M, 2) model points (beam-aligned); model_mask: (M,).
      scene: (S, 2) scene points (beam-aligned); scene_mask: (S,).
      params: static parameters.
      T_init: optional (3,3) initial transform (Icp.cpp:482-487).
      sensor_pose: (3,3) pose for the out-of-bounds prefilter
        (ThreadLocalize.cpp:571-573).
      model_normals: (M, 2), required by the "point_to_line" estimator.
    Returns:
      IcpResult with T = accumulated transform (includes T_init).
    """
    dtype, dev = scene.dtype, scene.device
    M = model.shape[0]
    if T_init is None:
        T_init = torch.eye(3, dtype=dtype, device=dev)
    if sensor_pose is None:
        sensor_pose = torch.eye(3, dtype=dtype, device=dev)
    if params.estimator == "point_to_line":
        if model_normals is None:
            raise ValueError("point_to_line estimator requires model_normals")
        payload = torch.cat([model, model_normals], dim=1)
    elif params.estimator == "closed_form":
        payload = model
    else:
        raise ValueError(f"unknown estimator {params.estimator!r}")

    dist_it = (params.dist_iterations if params.dist_iterations is not None
               else params.iterations)
    thresh2 = flt.distance_threshold_schedule(
        params.dist_max, params.dist_min, dist_it,
        length=params.iterations, dtype=dtype, device=dev)

    T = T_init.to(dtype)
    rms_prev = torch.full((), 10e12, dtype=dtype, device=dev)
    conv_cnt = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    state = torch.full((), int(IcpState.PROCESSING), dtype=torch.int32,
                       device=dev)
    rms_h, pair_h, ran = [], [], []
    idx_h, mask_h, T_h = [], [], []
    for it in range(params.iterations):
        scene_cur = se2.transform_points(T, scene)

        smask = scene_mask
        if params.bounds is not None:
            x0, x1, y0, y1 = params.bounds
            smask = flt.out_of_bounds_filter_2d(
                scene_cur, smask, sensor_pose, x0, x1, y0, y1)

        gate = thresh2[it] if params.use_distance_filter else None
        if params.fused:
            idx, d2, pmask, paired = assign_pairs_fused(
                model, model_mask, scene_cur, smask, payload,
                thresh2=gate, use_reciprocal=params.use_reciprocal_filter)
            if params.estimator == "point_to_line":
                T_last, rms = point_to_line_2d_paired(
                    paired[:, :2], paired[:, 2:], scene_cur, pmask)
            else:
                T_last, rms = closed_form_2d_paired(paired, scene_cur, pmask)
        else:
            idx, d2 = nearest_neighbors(model, model_mask, scene_cur, smask)
            pmask = smask & torch.isfinite(d2)
            if gate is not None:
                pmask = flt.distance_filter(d2, pmask, gate)
            if params.use_reciprocal_filter:
                pmask = flt.reciprocal_filter(idx, d2, pmask, M)
            if params.estimator == "point_to_line":
                T_last, rms = point_to_line_2d(model, model_normals,
                                               scene_cur, idx, pmask)
            else:
                T_last, rms = closed_form_2d(model, scene_cur, idx, pmask)

        npairs = pmask.sum()
        matchable = npairs > 2      # Icp.cpp:421
        T_new = torch.where(matchable, T_last @ T, T)
        rms = torch.where(matchable, rms, rms_prev)

        plateau = (rms - rms_prev).abs() < params.conv_eps
        conv_new = torch.where(plateau, conv_cnt + 1, 0).to(torch.int32)
        success = matchable & ((rms <= params.max_rms)
                               | (conv_new >= params.convergence_count))
        maxed = it + 1 >= params.iterations
        new_state = torch.where(
            ~matchable, int(IcpState.NOTMATCHABLE),
            torch.where(success, int(IcpState.SUCCESS),
                        int(IcpState.MAXITERATIONS) if maxed
                        else int(IcpState.PROCESSING))).to(torch.int32)

        # freeze once done (the reference leaves its while loop here)
        rms_h.append(torch.where(done, torch.nan, rms))
        pair_h.append(torch.where(done, 0, npairs))
        ran.append(~done)
        if params.record_pairs:
            idx_h.append(idx.to(torch.int32))
            mask_h.append(pmask & ~done)
        T = torch.where(done, T, T_new)
        if params.record_T:
            T_h.append(T)
        conv_cnt = torch.where(done, conv_cnt, conv_new)
        state = torch.where(done, state, new_state)
        rms_prev = torch.where(done, rms_prev, rms)
        done = done | ~matchable | success

    pair_h = torch.stack(pair_h)
    iters = torch.stack(ran).sum()
    last = (iters - 1).clamp(min=0).reshape(1)
    # index_select, not pair_h[last]: a tensor index would be read back
    return IcpResult(T=T, rms=rms_prev,
                     pairs=pair_h.index_select(0, last)[0], iterations=iters,
                     state=state, rms_history=torch.stack(rms_h),
                     pair_history=pair_h,
                     pair_idx_history=(torch.stack(idx_h)
                                       if params.record_pairs else None),
                     pair_mask_history=(torch.stack(mask_h)
                                        if params.record_pairs else None),
                     T_history=torch.stack(T_h) if params.record_T else None)


# icp compiled (ohm_tsd_slam_tpu/registration/icp.py::icp_jit): on the card
# one CUDA graph of the whole loop a key (params, record_pairs and record_T
# among them; `maxed` is a Python bool of the iteration index, so it is
# frozen correctly), replayed with one launch; eager on the CPU
icp_jit = compiled(icp, static_argnames=("params",), name="icp_jit")
