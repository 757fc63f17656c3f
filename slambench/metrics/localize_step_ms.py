"""Device ms of one localize_step_jit replay (render, matcher, ICP,
gates) on the node's grid, robot 0's pose and its last scan, by CUDA
events: the median of a fixed count after the window."""

from __future__ import annotations


def probe(run):
    import torch

    from ohm_tsd_slam_tpu_torch.slam.localize import localize_step_jit

    from slambench import probes as p

    loc, grid, seg, data, mask = p.last_scan(run)
    gen = torch.Generator(device=run.device)

    def call():
        gen.manual_seed(0)
        localize_step_jit(grid, loc.pose, loc.last_pose, data, mask,
                          loc.params, generator=gen, segments=seg)

    return p.median_ms(call)


def read(run):
    return run.probes.get("localize_step_ms")
