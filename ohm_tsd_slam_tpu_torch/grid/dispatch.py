"""Choice between the plain push and the CUDA push kernel."""

from __future__ import annotations

from typing import Callable

from ohm_tsd_slam_tpu_torch.grid.push import push
from ohm_tsd_slam_tpu_torch.grid.state import TsdGrid


def best_push(grid: TsdGrid) -> Callable:
    """The push for this grid: the CUDA kernel for a grid on CUDA (which
    raises for anything but float32), the plain push for a grid on the
    CPU.  A CUDA grid never reaches the plain version from here."""
    from ohm_tsd_slam_tpu_torch.ops.push_cuda import push_cuda

    return push_cuda if grid.tsd.is_cuda else push
