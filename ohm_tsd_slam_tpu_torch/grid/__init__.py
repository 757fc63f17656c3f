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
# as in the JAX package, the raycast_fast function is not bound here: it
# would shadow the grid.raycast_fast submodule
from ohm_tsd_slam_tpu_torch.grid.raycast_fast import (
    SegmentCache,
    extract_segments,
    raycast_checked,
)

__all__ = [
    "SegmentCache",
    "extract_segments",
    "raycast_checked",
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
