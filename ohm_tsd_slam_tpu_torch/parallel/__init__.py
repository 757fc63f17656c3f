"""The multi-robot step on one card or over a device mesh (port of
ohm_tsd_slam_tpu/parallel/): the row-sharded raycast, matchers and step
on torch.distributed (mesh.py, distributed.py, shard_raycast.py,
shard_matchers.py, sharded.py)."""

from ohm_tsd_slam_tpu_torch.parallel.mesh import (
    grid_sharding,
    make_mesh,
    replicated,
    robot_sharding,
)
from ohm_tsd_slam_tpu_torch.parallel.sharded import (
    SlamStepResult,
    make_sharded_step,
    map_residual_loss,
    multi_robot_slam_step,
    pose_gradient,
)

__all__ = [
    "grid_sharding",
    "make_mesh",
    "replicated",
    "robot_sharding",
    "SlamStepResult",
    "make_sharded_step",
    "map_residual_loss",
    "multi_robot_slam_step",
    "pose_gradient",
]
