from ohm_tsd_slam_tpu_torch.slam.localize import (
    LocalizeParams,
    LocalizeResult,
    localize_step,
    localize_step_jit,
)
from ohm_tsd_slam_tpu_torch.slam.mapping import Mapper
from ohm_tsd_slam_tpu_torch.slam.grid_pub import GridPublisher
from ohm_tsd_slam_tpu_torch.slam.messages import (
    ImageMsg,
    LaserScan,
    OccupancyGridMsg,
    PoseStamped,
    Transform2D,
)
from ohm_tsd_slam_tpu_torch.slam.node import Localizer, SlamNode

__all__ = [
    "LocalizeParams",
    "LocalizeResult",
    "localize_step",
    "localize_step_jit",
    "Mapper",
    "GridPublisher",
    "ImageMsg",
    "LaserScan",
    "OccupancyGridMsg",
    "PoseStamped",
    "Transform2D",
    "Localizer",
    "SlamNode",
]
