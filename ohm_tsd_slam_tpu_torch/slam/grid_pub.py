"""Occupancy-grid / TSD-image publication worker (port of
ohm_tsd_slam_tpu/slam/grid_pub.py).

ThreadGrid (src/ThreadGrid.cpp): on demand, extract the occupancy grid and
the TSD colour image from the current grid state as host numpy arrays.
Both run compiled (occupancy_grid_jit, grid_to_color_image_jit: a CUDA
graph a key on the card, the eager functions on the CPU); the messages
are those of the eager functions in every bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

from ohm_tsd_slam_tpu_torch.config import GridPubConfig
from ohm_tsd_slam_tpu_torch.grid.axis_aligned import occupancy_grid_jit
from ohm_tsd_slam_tpu_torch.grid.color import grid_to_color_image_jit
from ohm_tsd_slam_tpu_torch.grid.state import TsdGrid
from ohm_tsd_slam_tpu_torch.slam.messages import ImageMsg, OccupancyGridMsg


class GridPublisher:
    def __init__(self, config: GridPubConfig, x_offset: float = 0.0,
                 y_offset: float = 0.0):
        self.config = config
        self.x_offset = x_offset
        self.y_offset = y_offset
        self.last_map: Optional[OccupancyGridMsg] = None
        self.last_image: Optional[ImageMsg] = None

    def publish(self, grid: TsdGrid, stamp: float = 0.0
                ) -> Tuple[OccupancyGridMsg, Optional[ImageMsg]]:
        """One ThreadGrid cycle (ThreadGrid.cpp:72-133)."""
        res = occupancy_grid_jit(
            grid,
            use_inflation=self.config.use_object_inflation,
            inflation_factor=self.config.object_inflation_factor)
        # origin as in the ThreadGrid ctor (ThreadGrid.cpp:36-38)
        occ = OccupancyGridMsg(
            data=res.occupancy.cpu().numpy(),
            resolution=grid.cell_size,
            origin_x=-(grid.cells_x * grid.cell_size * 0.5 + self.x_offset),
            origin_y=-(grid.cells_y * grid.cell_size * 0.5 + self.y_offset),
            stamp=stamp,
        )
        img = None
        if self.config.pub_tsd_color_map:
            img = ImageMsg(data=grid_to_color_image_jit(grid).cpu().numpy(),
                           stamp=stamp)
        self.last_map = occ
        self.last_image = img
        return occ, img

    def get_map(self) -> Optional[OccupancyGridMsg]:
        """nav_msgs/GetMap service equivalent (ThreadGrid.cpp:135-142)."""
        return self.last_map
