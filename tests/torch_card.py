"""What the port's card tests share (tests/test_torch_paths_cuda.py and the
card jobs of tests/torch_mesh_worker.py): the room's 1081-beam sensor and
its scan messages, equality in every bit, the kernel wrappers' launch
counts, the push kernel against the plain push, and the double laser's two
robots set up for the multi-robot step.

The scene itself (the room, the deployments, the trajectories and the
scans) is ohm_tsd_slam_tpu_torch/utils/testing.py's.  Imports torch and
the port only; nothing here touches the card until it is called.
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import torch

from ohm_tsd_slam_tpu_torch.utils.testing import (
    BEAMS,
    DOUBLE_LASER,
    PHI_MIN,
    RES,
    scan_ranges,
    trajectory,
)

# each kernel wrapper: ops/<module>.py::<name>, its plain twin for a CPU
# tensor, and its kernel's name in csrc/*.cu as a trace shows it
WRAPPERS = {
    "push": ("push_cuda", "push", "tsd_push_kernel"),
    "segment_layers": ("segment_layers_cuda", "segment_layers_plain",
                       "segment_layers_kernel"),
    "pack_rows": ("pack_rows_cuda", "pack_rows_plain", "pack_rows_kernel"),
    "segment_min": ("segment_min_cuda", "segment_min_plain",
                    "segment_min_kernel"),
    "window_replay": ("window_replay_cuda", "window_replay_plain",
                      "window_replay_kernel"),
    "window_rounds": ("window_replay_cuda", "window_rounds_plain",
                      "window_rounds_kernel"),
    "compact_channels": ("compact_channels_cuda", "pack_channels_rows",
                         "compact_kernel"),
    "nearest_model": ("nearest_model_cuda", "nearest_model_plain",
                      "nearest_model_kernel"),
}
STEPS_MULTI = 20             # multi-robot steps (ICP) on the double laser
MULTI_TOL = 1e-4             # m: one step's poses, against another route
# the push kernel's largest tsd gap to the plain push (its error before it
# took the cull, 1.28e-5)
PUSH_TOL = 1.3e-5


def geom_1081(max_range=30.0):
    from ohm_tsd_slam_tpu_torch.sensor.polar2d import SensorPolar2D

    return SensorPolar2D(size=BEAMS, angular_res=RES, phi_min=PHI_MIN,
                         max_range=max_range, min_range=0.01)


def scan_msg(ranges, max_range, stamp):
    from ohm_tsd_slam_tpu_torch.slam import LaserScan

    return LaserScan(ranges=ranges, angle_min=PHI_MIN, angle_increment=RES,
                     range_max=max_range, stamp=stamp)


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal in every bit (NaN payloads and signed zeros included)."""
    a, b = a.detach().contiguous().cpu(), b.detach().contiguous().cpu()
    return a.shape == b.shape and a.dtype == b.dtype and \
        a.numpy().tobytes() == b.numpy().tobytes()


def step_results_equal(a, b) -> bool:
    """Two SlamStepResults equal in every bit."""
    return all(bits_equal(getattr(a.grid, f), getattr(b.grid, f))
               for f in ("tsd", "weight", "tile_init", "tile_initw")) and all(
        bits_equal(getattr(a, f), getattr(b, f))
        for f in ("poses", "reg_error", "pose_grad", "rms", "rays_dropped"))


def wrappers() -> dict:
    """name -> the kernel wrapper (with its `launches` count)."""
    return {name: getattr(importlib.import_module(
        f"ohm_tsd_slam_tpu_torch.ops.{mod}"),
        "push_cuda" if name == "push" else name)
        for name, (mod, _, _) in WRAPPERS.items()}


def reset_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()}


def compare_push(g_ref, g_ker) -> dict:
    """The push kernel's grid against the plain push's, with the
    tolerances of tests/test_push_pallas.py (atan2f against torch.atan2
    moves a cell on a bin edge into the next beam) and PUSH_TOL on the
    largest tsd gap; the tile arrays equal."""
    a = g_ref.tsd.cpu().numpy()
    b = g_ker.tsd.cpu().numpy()
    fin = ~np.isnan(a) & ~np.isnan(b)
    d = np.abs(a[fin] - b[fin])
    stats = {
        "nan_mismatch_rate": float((np.isnan(a) != np.isnan(b)).mean()),
        "rate_over_1e-3": float((d > 1e-3).mean()) if d.size else 0.0,
        "median_abs_err": float(np.median(d)) if d.size else 0.0,
        "max_abs_err": float(d.max()) if d.size else 0.0,
        "weight_max_abs_err": float(
            (g_ref.weight - g_ker.weight).abs().max()),
        "finite_cells": int(fin.sum())}
    assert stats["nan_mismatch_rate"] < 5e-4, stats
    assert stats["rate_over_1e-3"] < 5e-4, stats
    assert stats["median_abs_err"] < 1e-5, stats
    assert stats["max_abs_err"] <= PUSH_TOL, stats
    assert stats["weight_max_abs_err"] <= 1e-2, stats
    assert torch.equal(g_ref.tile_init, g_ker.tile_init), stats
    assert torch.equal(g_ref.tile_initw, g_ker.tile_initw), stats
    return stats


def multi_robot_inputs(gts, k, dev):
    """The robots' scans at step k of their trajectories, masked, as
    [R, B] tensors (one geometry: robot0's 30 m laser)."""
    from ohm_tsd_slam_tpu_torch.sensor.polar2d import standard_mask

    geom = geom_1081(30.0)
    pairs = [standard_mask(geom, torch.as_tensor(
        scan_ranges(gt[k], 30.0), dtype=torch.float32, device=dev))
        for gt in gts]
    return (torch.stack([d for d, _ in pairs]),
            torch.stack([m for _, m in pairs]))


def multi_robot_setup(dev, push_fn):
    """configs/double-laser.yaml's two robots for the multi-robot step:
    (cfg, geom, params, gts, grid, poses): robot0's 30 m laser for both
    (the step takes one scan geometry, as the JAX package's), ICP with 25
    iterations, STEPS_MULTI + 1 poses of each robot's trajectory, and the
    grid of each robot's first scan pushed (by `push_fn`) at its start
    pose, as the node starts."""
    from ohm_tsd_slam_tpu_torch.config import from_flat_params
    from ohm_tsd_slam_tpu_torch.core import se2
    from ohm_tsd_slam_tpu_torch.grid.state import create
    from ohm_tsd_slam_tpu_torch.slam.localize import LocalizeParams

    cfg = from_flat_params(DOUBLE_LASER)
    geom = geom_1081(30.0)
    params = dataclasses.replace(
        LocalizeParams.from_config(cfg.robots[0].registration, geom,
                                   cell_size=cfg.grid.cellsize),
        geom=geom)
    assert params.mode == 0 and params.icp.iterations == 25
    half = cfg.grid.size_meters * 0.5
    gts = [trajectory((half + r.local_offset_x, half + r.local_offset_y,
                       r.local_offset_yaw), STEPS_MULTI + 1)
           for r in cfg.robots]
    grid = create(cfg.grid, dtype=torch.float32, device=dev)
    poses = torch.stack([se2.make(*gt[0], device=dev) for gt in gts])
    data, mask = multi_robot_inputs(gts, 0, dev)
    for r in range(len(gts)):
        grid = push_fn(grid, geom, poses[r], data[r], mask[r])
    return cfg, geom, params, gts, grid, poses
