from ohm_tsd_slam_tpu_torch.grid.state import (
    TsdGrid,
    create,
    free_footprint,
    from_arrays,
    to_arrays,
)
from ohm_tsd_slam_tpu_torch.grid.interpolate import (
    interpolate_bilinear,
    interpolate_normal,
)
from ohm_tsd_slam_tpu_torch.grid.dispatch import best_push
from ohm_tsd_slam_tpu_torch.grid.push import push
from ohm_tsd_slam_tpu_torch.grid.raycast import RaycastResult, raycast

__all__ = [
    "TsdGrid",
    "create",
    "free_footprint",
    "from_arrays",
    "to_arrays",
    "interpolate_bilinear",
    "interpolate_normal",
    "best_push",
    "push",
    "RaycastResult",
    "raycast",
]
