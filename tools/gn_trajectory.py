#!/usr/bin/env python3
"""Mode GN along the card tests' trajectories, in both packages, on the CPU.

    env JAX_PLATFORMS=cpu python3 tools/gn_trajectory.py [scans]

Drives SlamNode of the JAX package and of the PyTorch port in mode GN
(`registration_mode: 4`, configs/single-laser.yaml's settings, float32,
the 1024^2 grid of 0.025 m cells, 1081 beams) through utils/testing.py's room
twice: on its turning trajectory (2 cm and 0.5 deg a scan, the other
paths') and straight (2 cm a scan, the GN path's), and prints each scan's
|pose - truth| in metres ("nan" marks a scan whose registration was
refused) for both packages side by side.  Gauss-Newton's basin is the
field's truncation band (3 cells here); the script shows where each
trajectory leaves it and that the port follows the JAX package there.
Runs on the CPU only: it needs JAX, which the card's machine lacks.
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def run(pkg: str, turn_deg: float, scans: int) -> list:
    from ohm_tsd_slam_tpu_torch.utils import testing as cs

    if pkg == "jax":
        import jax.numpy as jnp

        from ohm_tsd_slam_tpu.config import from_flat_params
        from ohm_tsd_slam_tpu.slam import LaserScan, SlamNode
        node = SlamNode(from_flat_params(
            {**cs.SINGLE_LASER, "registration_mode": 4}), dtype=jnp.float32)
    else:
        import torch

        from ohm_tsd_slam_tpu_torch.config import from_flat_params
        from ohm_tsd_slam_tpu_torch.slam import LaserScan, SlamNode
        from ohm_tsd_slam_tpu_torch.utils.testing import limit_cpu_threads
        limit_cpu_threads()
        node = SlamNode(from_flat_params(
            {**cs.SINGLE_LASER, "registration_mode": 4}),
            dtype=torch.float32, device="cpu")
    errs = []
    for k, (x, y, th) in enumerate(cs.trajectory((12.8, 12.8, 0.0), scans,
                                                 turn_deg)):
        out = node.process_scan(0, LaserScan(
            ranges=cs.scan_ranges((x, y, th), 30.0), angle_min=cs.PHI_MIN,
            angle_increment=cs.RES, range_max=30.0, stamp=float(k)))
        pose = np.asarray(node.localizers[0].pose)
        err = math.hypot(float(pose[0, 2]) - x, float(pose[1, 2]) - y)
        errs.append(math.nan if out is not None and out.is_nan else err)
    return errs


def main() -> int:
    scans = int(sys.argv[1]) if len(sys.argv) > 1 else 30
    for turn in (0.5, 0.0):
        traces = {pkg: run(pkg, turn, scans) for pkg in ("jax", "torch")}
        print(f"mode GN, {turn} deg a scan: scan, |pose - truth| m (JAX, "
              "port)")
        for k, (a, b) in enumerate(zip(traces["jax"], traces["torch"])):
            print(f"  {k:3d} {a:.6f} {b:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
