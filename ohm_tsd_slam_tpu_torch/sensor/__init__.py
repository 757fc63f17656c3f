from ohm_tsd_slam_tpu_torch.sensor.polar2d import (
    SensorPolar2D,
    back_project,
    clamp_min_range,
    data_to_cartesian,
    standard_mask,
)

__all__ = [
    "SensorPolar2D",
    "back_project",
    "clamp_min_range",
    "data_to_cartesian",
    "standard_mask",
]
