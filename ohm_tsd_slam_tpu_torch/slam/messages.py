"""ROS-free message structs (a copy of ohm_tsd_slam_tpu/slam/messages.py).

Lightweight stand-ins for the ROS 2 message types the reference consumes/
produces (sensor_msgs/LaserScan, geometry_msgs/PoseStamped,
nav_msgs/OccupancyGrid, sensor_msgs/Image); an optional ROS bridge can map
these 1:1.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class LaserScan:
    """sensor_msgs/LaserScan subset used by the reference
    (src/ThreadLocalize.cpp:248-276,487-497)."""

    ranges: np.ndarray
    angle_min: float
    angle_increment: float
    range_max: float
    stamp: float = 0.0
    frame_id: str = "laser"


@dataclass
class PoseStamped:
    x: float
    y: float
    theta: float
    stamp: float = 0.0
    frame_id: str = "map"

    @property
    def is_nan(self) -> bool:
        return bool(np.isnan(self.x) or np.isnan(self.y)
                    or np.isnan(self.theta))


@dataclass
class Transform2D:
    """tf equivalent: frame-to-frame SE(2) transform."""

    x: float
    y: float
    theta: float
    parent_frame: str = "map"
    child_frame: str = "odom"
    stamp: float = 0.0


@dataclass
class OccupancyGridMsg:
    """nav_msgs/OccupancyGrid subset (src/ThreadGrid.cpp:30-39)."""

    data: np.ndarray            # [H, W] int8: -1/0/100
    resolution: float
    origin_x: float
    origin_y: float
    stamp: float = 0.0
    frame_id: str = "map"

    @property
    def width(self) -> int:
        return self.data.shape[1]

    @property
    def height(self) -> int:
        return self.data.shape[0]


@dataclass
class ImageMsg:
    """sensor_msgs/Image (RGB8) subset for the TSD color map."""

    data: np.ndarray            # [H, W, 3] uint8
    stamp: float = 0.0
    frame_id: str = "map"


# ---------------------------------------------------------------------------
# Wire codec for the native channels (ohm_tsd_slam_tpu_torch.native.Channel)
# ---------------------------------------------------------------------------

_SCAN_HEADER = np.dtype([
    ("stamp", np.float64),
    ("angle_min", np.float64),
    ("angle_increment", np.float64),
    ("range_max", np.float64),
    ("n", np.int64),
])


def pack_scan(scan: LaserScan) -> bytes:
    """Serialize a LaserScan for the native latest-wins channel."""
    ranges = np.ascontiguousarray(scan.ranges, dtype=np.float32)
    head = np.zeros((), dtype=_SCAN_HEADER)
    head["stamp"] = scan.stamp
    head["angle_min"] = scan.angle_min
    head["angle_increment"] = scan.angle_increment
    head["range_max"] = scan.range_max
    head["n"] = ranges.shape[0]
    return head.tobytes() + ranges.tobytes()


def unpack_scan(payload: bytes) -> LaserScan:
    head = np.frombuffer(payload[:_SCAN_HEADER.itemsize],
                         dtype=_SCAN_HEADER)[0]
    n = int(head["n"])
    ranges = np.frombuffer(payload[_SCAN_HEADER.itemsize:],
                           dtype=np.float32, count=n)
    return LaserScan(
        ranges=ranges,
        angle_min=float(head["angle_min"]),
        angle_increment=float(head["angle_increment"]),
        range_max=float(head["range_max"]),
        stamp=float(head["stamp"]),
    )
