"""Device ms of one icp_jit replay (the registration layer alone: 25 or
30 iterations of pairing, filters and the closed-form estimate) on robot
0's last model and scene, by CUDA events: the median of a fixed count
after the window.  The model is the node's render of that scan from the
robot's pose (raycast_checked_jit with the node's segment cache)."""

from __future__ import annotations


def probe(run):
    from ohm_tsd_slam_tpu_torch.grid.raycast_fast import raycast_checked_jit
    from ohm_tsd_slam_tpu_torch.registration.icp import icp_jit
    from ohm_tsd_slam_tpu_torch.sensor.polar2d import data_to_cartesian

    from slambench import probes as p

    loc, grid, seg, data, mask = p.last_scan(run)
    model = raycast_checked_jit(grid, loc.geom, loc.pose, segments=seg)
    scene, scene_mask = data_to_cartesian(loc.geom, data, mask)
    return p.median_ms(lambda: icp_jit(
        model.coords, model.mask, scene, scene_mask, loc.params.icp,
        sensor_pose=loc.pose, model_normals=model.normals))


def read(run):
    return run.probes.get("icp_ms")
