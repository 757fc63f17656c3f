"""The multi-robot step on one card (port of ohm_tsd_slam_tpu/parallel/
without the mesh: shard_raycast, shard_matchers, distributed, mesh and
make_sharded_step wait for ROADMAP.md queue 1 item 15)."""

from ohm_tsd_slam_tpu_torch.parallel.sharded import (
    SlamStepResult,
    map_residual_loss,
    multi_robot_slam_step,
    pose_gradient,
)

__all__ = [
    "SlamStepResult",
    "map_residual_loss",
    "multi_robot_slam_step",
    "pose_gradient",
]
