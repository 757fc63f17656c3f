"""CLI runner of the port (port of ohm_tsd_slam_tpu/__main__.py): the
launch-script equivalent of the reference's deploy layer
(launch/slam.launch.py + config/*.yaml + docker/).

Subcommands:
  simulate   write a scan log (.npz) of a robot loop through an
             analytic room (stands in for a rosbag of /scan)
  run        run SLAM over a scan log with a YAML profile; writes the
             node's observable outputs: trajectory.csv, map.pgm,
             map_color.ppm, grid.npz (and grid_store.txt with
             --store-text)
  launch     run a reference launch profile (single or multi)
  ros        run the ROS 2 bridge node (requires rclpy; see
             ohm_tsd_slam_tpu_torch/ros_bridge.py)

The node runs on the CUDA card unless --device names another ("cpu"); with
no card and no --device it raises, as SlamNode does.  The scan logs and
grid.npz are the JAX package's formats: either package reads the other's.
The JAX package's persistent XLA compile cache (utils/compile_cache.py)
has no counterpart here: nothing is compiled ahead but the CUDA kernels,
which ops/_build.py keeps built beside the package.

Examples:
  python -m ohm_tsd_slam_tpu_torch simulate --out scans.npz --steps 120
  python -m ohm_tsd_slam_tpu_torch run scans.npz --config configs/single-laser.yaml --out out/
"""

from __future__ import annotations

import argparse
import math
import os
import statistics
import sys
import time

import numpy as np


def _load_config(path):
    from ohm_tsd_slam_tpu_torch.config import from_flat_params, load_yaml

    if path:
        return load_yaml(path)
    return from_flat_params({
        "map_size": 9, "cellsize": 0.025, "registration_mode": 0,
        "icp_iterations": 30, "max_range": 12.0, "min_range": 0.01,
    })


def cmd_simulate(args) -> int:
    """Generate a scan log: robot loop in the analytic room."""
    from ohm_tsd_slam_tpu_torch.utils.testing import rect_walls, simulate_scan

    cfg = _load_config(args.config)
    gw = cfg.grid.size_meters
    B = args.beams
    res = math.radians(270.0 / B)
    phi0 = math.radians(-135.0)
    rmax = cfg.robots[0].sensor.max_range

    margin = 0.2 * gw
    walls = rect_walls(margin, margin, gw - margin, gw - margin)
    pillars = [((gw / 2 + 0.22 * gw, gw / 2), 0.04 * gw),
               ((gw / 2 - 0.18 * gw, gw / 2 + 0.15 * gw), 0.03 * gw)]

    radius = 0.12 * gw
    ranges, gts, stamps = [], [], []
    for k in range(args.steps):
        a = 2.0 * math.pi * k / args.steps
        x = gw / 2 + radius * math.cos(a)
        y = gw / 2 + radius * math.sin(a)
        th = a + math.pi / 2
        T = np.array([[math.cos(th), -math.sin(th), x],
                      [math.sin(th), math.cos(th), y],
                      [0.0, 0.0, 1.0]])
        ranges.append(simulate_scan(T, B, res, phi0, rmax,
                                    segments=walls, circles=pillars))
        gts.append((x, y, th))
        stamps.append(k / args.rate)
    np.savez_compressed(
        args.out, ranges=np.asarray(ranges, np.float32),
        angle_min=phi0, angle_increment=res, range_max=rmax,
        stamps=np.asarray(stamps), ground_truth=np.asarray(gts))
    print(f"wrote {args.out}: {args.steps} scans x {B} beams")
    return 0


def cmd_run(args) -> int:
    """Run SLAM over a scan log; write the node's observable outputs."""
    from ohm_tsd_slam_tpu_torch import native
    from ohm_tsd_slam_tpu_torch.grid import checkpoint
    from ohm_tsd_slam_tpu_torch.slam.messages import LaserScan
    from ohm_tsd_slam_tpu_torch.slam.node import SlamNode

    cfg = _load_config(args.config)
    log = np.load(args.scans)
    ranges = log["ranges"]
    stamps = log["stamps"] if "stamps" in log else np.arange(len(ranges))
    odom = log["odom"] if "odom" in log else None

    node = SlamNode(cfg, seed=args.seed, device=args.device)
    os.makedirs(args.out, exist_ok=True)

    rows, scan_ms = [], []
    for k, r in enumerate(ranges):
        if odom is not None:
            node.on_odometry(0, *odom[k][:3], stamp=float(stamps[k]))
        msg = LaserScan(ranges=r,
                        angle_min=float(log["angle_min"]),
                        angle_increment=float(log["angle_increment"]),
                        range_max=float(log["range_max"]),
                        stamp=float(stamps[k]))
        t0 = time.perf_counter()
        out = node.process_scan(0, msg)
        scan_ms.append((time.perf_counter() - t0) * 1e3)
        if out is not None:
            rows.append((float(stamps[k]), out.x, out.y, out.theta))

    with open(os.path.join(args.out, "trajectory.csv"), "w") as f:
        f.write("stamp,x,y,theta\n")
        for row in rows:
            f.write("%.6f,%.6f,%.6f,%.6f\n" % row)

    occ_msg, img = node.publish_map()
    occ = np.asarray(occ_msg.data)
    # occupancy -> PGM: free=254, unknown=205, occupied=0 (map_server
    # conventions)
    pgm = np.where(occ == 100, 0,
                   np.where(occ == 0, 254, 205)).astype(np.uint8)
    native.serialize_pgm(os.path.join(args.out, "map.pgm"), pgm,
                         pgm.shape[1], pgm.shape[0])
    if img is not None:
        rgb = np.asarray(img.data)
        native.serialize_ppm(os.path.join(args.out, "map_color.ppm"),
                             rgb, rgb.shape[1], rgb.shape[0])
    checkpoint.save_npz(node.grid, os.path.join(args.out, "grid.npz"))
    if args.store_text:
        checkpoint.save_text(node.grid,
                             os.path.join(args.out, "grid_store.txt"))
    print(f"processed {len(ranges)} scans -> {args.out}/ "
          f"(trajectory.csv, map.pgm, map_color.ppm, grid.npz)")
    if len(scan_ms) > 1:
        # the first scan initializes the node and is left out
        print(f"process_scan on {node.device}: median "
              f"{statistics.median(scan_ms[1:]):.3f} ms a scan (host clock, "
              f"{len(scan_ms) - 1} scans after the first)")

    if "ground_truth" in log and len(rows):
        gt = log["ground_truth"]
        k0 = len(gt) - len(rows)

        def se2_mat(x, y, th):
            c, s = math.cos(th), math.sin(th)
            return np.array([[c, -s, x], [s, c, y], [0.0, 0.0, 1.0]])

        # the SLAM frame is anchored at the initial pose (grid center +
        # local offsets); align it to ground truth at the first
        # published estimate and compare positions from there
        est = [se2_mat(r[1], r[2], r[3]) for r in rows]
        anchor = se2_mat(*gt[k0]) @ np.linalg.inv(est[0])
        errs = []
        for k, e in enumerate(est):
            if not np.isfinite(e).all():
                continue
            w = anchor @ e
            errs.append(math.hypot(w[0, 2] - gt[k0 + k][0],
                                   w[1, 2] - gt[k0 + k][1]))
        n_nan = len(est) - len(errs)
        if errs:
            print(f"trajectory error vs ground truth: "
                  f"mean {np.mean(errs):.4f} m, max {np.max(errs):.4f} m"
                  + (f" ({n_nan} failed scans)" if n_nan else ""))
    return 0


def cmd_ros(args) -> int:
    from ohm_tsd_slam_tpu_torch import ros_bridge

    return ros_bridge.main(config=args.config, device=args.device)


# launch-profile table: the reference's launch files select a config
# YAML and spawn static laser->footprint / footprint->odom transform
# publishers so sendTransform's tf lookups succeed
# (launch/slam.launch.py:13-49 resp. launch/multi_slam.launch.py:1-33)
_PROFILES = {
    "single": ("single-laser.yaml",
               dict(laser_footprint=(0.3, 0.0, 1.570796327),
                    footprint_odom=(1.0, 2.0, 1.0))),
    "multi": ("double-laser.yaml", dict()),
}


def cmd_launch(args) -> int:
    """Run a reference launch profile: resolve its config YAML, apply
    the launch file's static transforms, and run the multi-robot node
    over one scan log per robot (simulated when not supplied) — the
    CLI analogue of `ros2 launch ohm_tsd_slam (multi_)slam.launch.py`
    without a ROS graph.  With --ros the ROS 2 bridge is started on the
    profile's config instead."""
    from ohm_tsd_slam_tpu_torch.slam.messages import LaserScan
    from ohm_tsd_slam_tpu_torch.slam.node import SlamNode

    cfg_name, tfs = _PROFILES[args.profile]
    cfg_path = args.config or os.path.join(
        os.path.dirname(__file__), "..", "configs", cfg_name)
    if args.ros:
        from ohm_tsd_slam_tpu_torch import ros_bridge

        return ros_bridge.main(config=cfg_path, device=args.device)

    cfg = _load_config(cfg_path)
    n_robots = len(cfg.robots)
    scans = list(args.scans or [])
    os.makedirs(args.out, exist_ok=True)
    while len(scans) < n_robots:
        # simulate a log per missing robot (offset start angles so the
        # robots traverse different arcs of the room)
        path = os.path.join(args.out, f"scans_r{len(scans)}.npz")
        ns = argparse.Namespace(out=path, config=cfg_path,
                                steps=args.steps, beams=args.beams,
                                rate=10.0)
        cmd_simulate(ns)
        scans.append(path)

    node = SlamNode(cfg, seed=args.seed, device=args.device)
    for r in range(n_robots):
        if "laser_footprint" in tfs:
            node.set_static_tf(r, *tfs["laser_footprint"])
        if "footprint_odom" in tfs:
            node.on_footprint_odom(r, *tfs["footprint_odom"])

    logs = [np.load(p) for p in scans[:n_robots]]
    n_scans = min(len(l["ranges"]) for l in logs)
    rows = {r: [] for r in range(n_robots)}
    for k in range(n_scans):
        for r, log in enumerate(logs):
            msg = LaserScan(ranges=log["ranges"][k],
                            angle_min=float(log["angle_min"]),
                            angle_increment=float(log["angle_increment"]),
                            range_max=float(log["range_max"]),
                            stamp=float(log["stamps"][k]))
            out = node.process_scan(r, msg)
            if out is not None:
                rows[r].append((float(log["stamps"][k]), out.x, out.y,
                                out.theta))

    for r in range(n_robots):
        with open(os.path.join(args.out, f"trajectory_r{r}.csv"),
                  "w") as f:
            f.write("stamp,x,y,theta\n")
            for row in rows[r]:
                f.write("%.6f,%.6f,%.6f,%.6f\n" % row)
    from ohm_tsd_slam_tpu_torch import native

    occ_msg, img = node.publish_map()
    occ = np.asarray(occ_msg.data)
    pgm = np.where(occ == 100, 0,
                   np.where(occ == 0, 254, 205)).astype(np.uint8)
    native.serialize_pgm(os.path.join(args.out, "map.pgm"), pgm,
                         pgm.shape[1], pgm.shape[0])
    print(f"launch[{args.profile}]: {n_robots} robot(s) x {n_scans} "
          f"scans -> {args.out}/")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ohm_tsd_slam_tpu_torch",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("simulate", help="write an analytic-room scan log")
    s.add_argument("--out", default="scans.npz")
    s.add_argument("--config", default=None)
    s.add_argument("--steps", type=int, default=120)
    s.add_argument("--beams", type=int, default=541)
    s.add_argument("--rate", type=float, default=10.0)
    s.set_defaults(fn=cmd_simulate)

    r = sub.add_parser("run", help="run SLAM over a scan log")
    r.add_argument("scans", help="scan log .npz (see `simulate`)")
    r.add_argument("--config", default=None, help="YAML profile")
    r.add_argument("--out", default="out")
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--store-text", action="store_true",
                   help="also write the reference-format text checkpoint")
    r.add_argument("--device", default=None,
                   help="torch device of the node (default: the CUDA card)")
    r.set_defaults(fn=cmd_run)

    rb = sub.add_parser("ros", help="run the ROS 2 bridge node")
    rb.add_argument("--config", default=None)
    rb.add_argument("--device", default=None,
                    help="torch device of the node (default: the CUDA card)")
    rb.set_defaults(fn=cmd_ros)

    lc = sub.add_parser(
        "launch",
        help="run a reference launch profile (slam/multi_slam.launch.py)")
    lc.add_argument("profile", choices=sorted(_PROFILES))
    lc.add_argument("--scans", nargs="*", default=None,
                    help="one scan log per robot (simulated when absent)")
    lc.add_argument("--config", default=None,
                    help="override the profile's YAML")
    lc.add_argument("--out", default="out")
    lc.add_argument("--steps", type=int, default=40)
    lc.add_argument("--beams", type=int, default=541)
    lc.add_argument("--seed", type=int, default=0)
    lc.add_argument("--ros", action="store_true",
                    help="start the ROS 2 bridge on the profile config")
    lc.add_argument("--device", default=None,
                    help="torch device of the node (default: the CUDA card)")
    lc.set_defaults(fn=cmd_launch)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
