"""Shared by the probes: robot 0's last scan on the node's current grid,
and a CUDA-event timer."""

from __future__ import annotations

import statistics

CALLS = 20
WARMUP = 3


def last_scan(run):
    """(localizer, grid, segment cache, data, mask) of robot 0's last
    scan, prepared as the node prepares a scan."""
    import torch

    from ohm_tsd_slam_tpu_torch.grid.raycast_fast import extract_segments_jit
    from ohm_tsd_slam_tpu_torch.sensor.polar2d import (
        clamp_min_range,
        standard_mask,
    )

    node = run.node
    loc = node.localizers[0]
    r, k = max((rk for rk in run.order[:run.next] if rk[0] == 0),
               key=lambda rk: rk[1])
    data = torch.as_tensor(run.msgs[r][k].ranges, dtype=torch.float32,
                           device=run.device)
    data, mask = standard_mask(
        loc.geom, clamp_min_range(data, loc.config.sensor.laser_min_range))
    grid = node.grid
    return loc, grid, extract_segments_jit(grid), data, mask


def median_ms(fn) -> float:
    """Median ms of CALLS calls of fn() between CUDA events."""
    import torch

    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(CALLS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)
