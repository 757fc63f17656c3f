"""ICP engine (port of ohm_tsd_slam_tpu/registration/icp.py).

The reference's Icp class (src/obvision/registration/icp/Icp.cpp) as one
loop body over fixed-shape masks.  The JAX package runs it as a
`lax.scan` whose carry freezes once the reference would have left its
while loop (Icp.cpp:493-508); here it is a Python loop over all
`iterations` with the same frozen carry.  The loop never reads a value
back to the host, so it queues its work without a sync.

On the card a CUDA graph replays each op of the loop as a kernel of a
couple of microseconds whatever its size (1081 pairs, a 3x3 transform),
so an iteration is written in few, wide ops: both frames of the scene in
one product, the estimator's sums in two reductions
(estimators.py::closed_form_2d_paired), and the carry (rms, convergence
count, state) one small vector of the scans' dtype, frozen together with
the iteration's history entry by one `where`.

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
    # both frames of the scene in one pass: T's (the registration's) and
    # sensor_pose·T's (world, for the out-of-bounds prefilter,
    # OutOfBoundsFilter2D.cpp:27-37), the translation by a column of ones
    frames = torch.cat([torch.eye(3, dtype=dtype, device=dev)[:2],
                        sensor_pose.to(dtype)[:2]])            # [4, 3]
    scene_h = torch.cat([scene, torch.ones_like(scene[:, :1])], dim=1)
    x0, x1, y0, y1 = params.bounds if params.bounds is not None else (0,) * 4
    # the constants by fills, never by a copy from the host: the box,
    # the history's frozen entry [rms NaN, 0 pairs, not run], the carry
    # [rms_prev, conv_cnt, state] (small whole numbers: exact in dtype),
    # and the states a step can end in
    const = torch.stack([torch.full((), float(v), dtype=dtype, device=dev)
                         for v in (x0, y0, x1, y1, torch.nan, 0, 0, 10e12,
                                   0, IcpState.PROCESSING, 1,
                                   IcpState.NOTMATCHABLE, IcpState.SUCCESS,
                                   IcpState.MAXITERATIONS)])
    lo, hi, frozen, carry = const[0:2], const[2:4], const[4:7], const[7:10]
    zero = const[5]
    processing, one, unmatched, succeeded, maxed_out = const[9:]
    done = torch.zeros((), dtype=torch.bool, device=dev)
    hist, idx_h, mask_h, T_h = [], [], [], []
    for it in range(params.iterations):
        both = (frames @ T).view(2, 1, 2, 3)
        both = (both * scene_h[:, None, :]).sum(3)              # [2, S, 2]
        scene_cur = both[0]

        smask = scene_mask
        if params.bounds is not None:
            w = both[1]
            smask = smask & (w.clamp(lo, hi) == w).all(1)

        gate = thresh2[it] if params.use_distance_filter else None
        if params.fused:
            idx, d2, pmask, paired = assign_pairs_fused(
                model, model_mask, scene_cur, smask, payload,
                thresh2=gate, use_reciprocal=params.use_reciprocal_filter)
            if params.estimator == "point_to_line":
                T_last, rms = point_to_line_2d_paired(
                    paired[:, :2], paired[:, 2:], scene_cur, pmask)
                npairs = pmask.sum().to(dtype)
            else:
                T_last, rms, npairs = closed_form_2d_paired(
                    paired, scene_cur, pmask)
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
            npairs = pmask.sum().to(dtype)

        rms_prev, conv_cnt, state = carry
        unmatchable = npairs <= 2      # Icp.cpp:421
        rms = torch.where(unmatchable, rms_prev, rms)
        plateau = (rms - rms_prev).abs() < params.conv_eps
        conv_new = torch.where(plateau, conv_cnt + 1, zero)
        # an unmatchable step ends NOTMATCHABLE whatever `success` reads
        success = ((rms <= params.max_rms)
                   | (conv_new >= params.convergence_count))
        maxed = it + 1 >= params.iterations
        new_state = torch.where(
            unmatchable, unmatched,
            torch.where(success, succeeded,
                        maxed_out if maxed else processing))

        # freeze once done (the reference leaves its while loop here):
        # this step's history entry and carry, or the frozen ones
        if params.record_pairs:
            idx_h.append(idx.to(torch.int32))
            mask_h.append(pmask & ~done)
        stop = done | unmatchable
        T = torch.where(stop, T, T_last @ T)
        if params.record_T:
            T_h.append(T)
        step = torch.where(done, torch.cat([frozen, carry]),
                           torch.stack([rms, npairs, one, rms, conv_new,
                                        new_state]))
        hist.append(step[:3])
        carry = step[3:]
        done = stop | success

    rms_h, pair_h, ran = torch.stack(hist, dim=1)
    pair_h = pair_h.to(torch.int64)
    iters = ran.sum().to(torch.int64)
    last = (iters - 1).clamp(min=0).reshape(1)
    # index_select, not pair_h[last]: a tensor index would be read back
    return IcpResult(T=T, rms=carry[0],
                     pairs=pair_h.index_select(0, last)[0], iterations=iters,
                     state=carry[2].to(torch.int32), rms_history=rms_h,
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
