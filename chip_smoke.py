#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ohm_tsd_slam_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each of which raises on failure:

1. device: requires torch.cuda; prints the card's name and power limit;
2. build: compiles every CUDA kernel of the main path from csrc/;
3. kernel check: the push kernel against the plain push, both float32 on
   the card, at 1024^2 / 0.025 m / 1081 beams (three poses into one grid,
   a sensor outside the grid, an all-masked scan);
4. main path: SlamNode with configs/double-laser.yaml's settings (two
   robots sharing the grid, 25 ICP iterations, exact-march renderer),
   ~60 simulated scans per robot through process_scan, then publish_map;
5. times: first a check that localize_step and the push wrapper make no
   host sync, then medians and quartiles of 25 runs after a warm-up, each
   printed beside the card's name and power limit.

The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}} and is printed only when every phase
passed.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

CELLS = 1024                 # map_size 10
BEAMS = 1081                 # -135 deg in 0.25 deg steps (270 deg)
PHI_MIN = math.radians(-135.0)
RES = math.radians(0.25)
SCANS_PER_ROBOT = 60
N_TIMED = 25

# configs/double-laser.yaml, as a flat parameter dict
DOUBLE_LASER = {
    "map_size": 10, "cellsize": 0.025, "truncation_radius": 3.0,
    "occ_grid_time_interval": 2.0,
    "robot_nbr": 2, "robot_0/name": "robot0", "robot_1/name": "robot1",
    "registration_mode": 0, "icp_iterations": 25,
    "trials": 50, "epsThresh": 0.15, "sizeControlSet": 140,
    "robot0/max_range": 30.0, "robot0/min_range": 0.01,
    "robot0/local_offset_x": 0.0, "robot0/local_offset_y": 0.0,
    "robot0/local_offset_yaw": 0.0,
    "robot1/max_range": 20.0, "robot1/min_range": 0.01,
    "robot1/local_offset_x": 0.5, "robot1/local_offset_y": 0.0,
    "robot1/local_offset_yaw": 3.14159265,
}


def world():
    """A 13.6 m x 11.6 m room in the 25.6 m grid (segments, circles).
    Robot1 starts facing the wall robot0 cannot see, so the two boxes, the
    wall stubs and the pillars north and south of the start, in both
    robots' fields of view, give robot1 something to register against."""
    from ohm_tsd_slam_tpu_torch.utils.testing import rect_walls

    segs = rect_walls(6.0, 7.0, 19.6, 18.6)
    segs += rect_walls(15.5, 14.5, 16.7, 15.4)
    segs += rect_walls(11.0, 9.0, 12.0, 9.8)
    segs += [((9.0, 16.0), (11.5, 16.0)), ((13.5, 16.5), (13.5, 18.6))]
    circles = [((10.0, 10.0), 0.4), ((16.5, 10.5), 0.3), ((14.2, 15.8), 0.3)]
    return segs, circles


def scan_ranges(xyt, max_range):
    from ohm_tsd_slam_tpu_torch.utils.testing import simulate_scan

    x, y, th = xyt
    pose = np.array([[math.cos(th), -math.sin(th), x],
                     [math.sin(th), math.cos(th), y], [0.0, 0.0, 1.0]])
    segs, circles = world()
    return simulate_scan(pose, BEAMS, RES, PHI_MIN, max_range,
                         segments=segs, circles=circles)


def trajectory(start, n):
    """~2 cm and 0.5 deg per scan (tests/test_slam_e2e.py's motion)."""
    x, y, th = start
    out = []
    for _ in range(n):
        out.append((x, y, th))
        x += 0.02 * math.cos(th)
        y += 0.02 * math.sin(th)
        th += math.radians(0.5)
    return out


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_cuda(fn, n=N_TIMED, warmup=3) -> list:
    """ms of each of n calls of fn() between CUDA events, after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def compare_push(g_ref, g_ker) -> dict:
    """Kernel vs plain push on one grid, with the tolerances of
    tests/test_push_pallas.py (atan2f vs torch.atan2 bin flips)."""
    a = g_ref.tsd.cpu().numpy()
    b = g_ker.tsd.cpu().numpy()
    nan_mism = float((np.isnan(a) != np.isnan(b)).mean())
    fin = ~np.isnan(a) & ~np.isnan(b)
    d = np.abs(a[fin] - b[fin])
    stats = {
        "nan_mismatch_rate": nan_mism,
        "rate_over_1e-3": float((d > 1e-3).mean()) if d.size else 0.0,
        "median_abs_err": float(np.median(d)) if d.size else 0.0,
        "max_abs_err": float(d.max()) if d.size else 0.0,
        "weight_max_abs_err": float(
            (g_ref.weight - g_ker.weight).abs().max()),
        "finite_cells": int(fin.sum()),
    }
    assert stats["nan_mismatch_rate"] < 5e-4, stats
    assert stats["rate_over_1e-3"] < 5e-4, stats
    assert stats["median_abs_err"] < 1e-5, stats
    assert stats["weight_max_abs_err"] <= 1e-2, stats
    assert torch.equal(g_ref.tile_init, g_ker.tile_init), stats
    assert torch.equal(g_ref.tile_initw, g_ker.tile_initw), stats
    return stats


def kernel_check(dev) -> dict:
    from ohm_tsd_slam_tpu_torch.config import GridConfig
    from ohm_tsd_slam_tpu_torch.core import se2
    from ohm_tsd_slam_tpu_torch.grid.push import push
    from ohm_tsd_slam_tpu_torch.grid.state import create
    from ohm_tsd_slam_tpu_torch.ops.push_cuda import push_cuda
    from ohm_tsd_slam_tpu_torch.sensor.polar2d import (
        SensorPolar2D,
        standard_mask,
    )

    geom = SensorPolar2D(size=BEAMS, angular_res=RES, phi_min=PHI_MIN,
                         max_range=30.0, min_range=0.01)
    grid0 = create(GridConfig(map_size=10, cellsize=0.025), device=dev)
    assert grid0.tsd.shape == (CELLS, CELLS)
    results = {}

    g_ref = g_ker = grid0
    for xyt in [(12.8, 12.8, 0.0), (13.1, 12.9, 0.3), (12.4, 13.2, -0.4)]:
        data, mask = standard_mask(geom, torch.as_tensor(
            scan_ranges(xyt, geom.max_range), dtype=torch.float32,
            device=dev))
        pose = se2.make(*xyt, device=dev)
        g_ref = push(g_ref, geom, pose, data, mask)
        g_ker = push_cuda(g_ker, geom, pose, data, mask)
        torch.cuda.synchronize()
    results["three_poses"] = compare_push(g_ref, g_ker)
    assert results["three_poses"]["finite_cells"] > 100_000

    inf = torch.full((BEAMS,), math.inf, device=dev)
    none = torch.zeros(BEAMS, dtype=torch.bool, device=dev)
    for name, xyt in [("sensor_outside", (60.0, 60.0, 0.0)),
                      ("all_masked", (12.8, 12.8, 0.0))]:
        pose = se2.make(*xyt, device=dev)
        g_k = push_cuda(grid0, geom, pose, inf, none)
        torch.cuda.synchronize()
        results[name] = compare_push(push(grid0, geom, pose, inf, none), g_k)
        if name == "sensor_outside":
            assert not bool(g_k.tile_init.any())
    return results


def main_path(dev, label: str):
    """Both robots through SlamNode.process_scan, then publish_map."""
    from ohm_tsd_slam_tpu_torch.config import from_flat_params
    from ohm_tsd_slam_tpu_torch.ops import push_cuda as push_cuda_mod
    from ohm_tsd_slam_tpu_torch.ops.push_cuda import push_cuda
    from ohm_tsd_slam_tpu_torch.slam import LaserScan, SlamNode

    cfg = from_flat_params(DOUBLE_LASER)
    node = SlamNode(cfg, dtype=torch.float32, device=dev)
    assert node.mapper._push_fn is push_cuda, node.mapper._push_fn

    # the plain push must never see a CUDA grid on the main path: the
    # wrapper is the only way there from the mapper
    plain_on_cuda = []
    plain = push_cuda_mod.push

    def watched(grid, *args):
        if grid.tsd.is_cuda:
            plain_on_cuda.append(1)
        return plain(grid, *args)

    push_cuda_mod.push = watched
    n_pushes = []
    kernel_push = node.mapper._push_fn

    def counted(*args):
        n_pushes.append(1)
        return kernel_push(*args)

    node.mapper._push_fn = counted

    half = cfg.grid.size_meters * 0.5
    starts = [(half + rc.local_offset_x, half + rc.local_offset_y,
               rc.local_offset_yaw) for rc in cfg.robots]
    gts = [trajectory(s, SCANS_PER_ROBOT) for s in starts]
    scans = [[scan_ranges(p, rc.sensor.max_range) for p in gt]
             for gt, rc in zip(gts, cfg.robots)]

    push_cuda.launches = 0           # counts from the main path only
    t0 = time.perf_counter()
    errs = [[], []]
    for k in range(SCANS_PER_ROBOT):
        for r in range(2):
            out = node.process_scan(r, LaserScan(
                ranges=scans[r][k], angle_min=PHI_MIN, angle_increment=RES,
                range_max=cfg.robots[r].sensor.max_range, stamp=float(k)))
            if k == 0:
                assert out is None
                continue
            assert out is not None and not out.is_nan, (r, k)
            est = node.localizers[r].pose.cpu().numpy()
            assert np.isfinite(est).all(), (r, k)
            x, y, _ = gts[r][k]
            errs[r].append(math.hypot(est[0, 2] - x, est[1, 2] - y))
    occ, img = node.publish_map()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = push_cuda.launches
    push_cuda_mod.push = plain

    limit = 2.5 * cfg.grid.cellsize
    for r in range(2):
        print(f"main path robot{r}: max |pose - truth| = "
              f"{max(errs[r]):.6f} m, final {errs[r][-1]:.6f} m "
              f"(limit {limit} m)")
        assert max(errs[r]) < limit, (r, max(errs[r]))
    print(f"main path: {len(n_pushes)} pushes, push kernel launches "
          f"{launches}, plain push on CUDA {len(plain_on_cuda)}; "
          f"{2 * SCANS_PER_ROBOT} scans + publish_map in {wall:.3f} s "
          f"(first-call overheads included) [{label}]")
    assert launches >= len(n_pushes) > 2, (launches, len(n_pushes))
    assert not plain_on_cuda
    for f in ("tsd", "weight", "tile_init", "tile_initw"):
        assert getattr(node.grid, f).is_cuda, f
    n_occ = int((occ.data == 100).sum())
    n_free = int((occ.data == 0).sum())
    print(f"main path: occupancy {occ.data.shape} occupied {n_occ} "
          f"free {n_free}; colour image {img.data.shape}")
    assert occ.data.shape == (CELLS, CELLS)
    assert n_occ > 1000 and n_free > 10000
    node.mapper._push_fn = kernel_push
    return node, launches


def stage_times(node, label: str) -> dict:
    """Median times of the main path's stages on the card."""
    from ohm_tsd_slam_tpu_torch.grid.push import push
    from ohm_tsd_slam_tpu_torch.grid.raycast import raycast
    from ohm_tsd_slam_tpu_torch.ops.push_cuda import (
        launch,
        push_cuda,
        tile_meta,
    )
    from ohm_tsd_slam_tpu_torch.registration.icp import icp
    from ohm_tsd_slam_tpu_torch.sensor.polar2d import data_to_cartesian
    from ohm_tsd_slam_tpu_torch.slam import LaserScan
    from ohm_tsd_slam_tpu_torch.slam.localize import localize_step

    loc = node.localizers[0]
    grid, geom, pose = node.grid, loc.geom, loc.pose.contiguous()
    xyt = (float(pose[0, 2]), float(pose[1, 2]),
           math.atan2(float(pose[1, 0]), float(pose[0, 0])))
    data, mask = node._preprocess(loc, scan_ranges(xyt, geom.max_range))

    # localize_step (raycast + ICP + gates) and the push wrapper queue
    # their work without reading anything back: any host sync raises here
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        localize_step(grid, pose, loc.last_pose, data, mask, loc.params)
        push_cuda(grid, geom, pose, data, mask)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print("sync check: localize_step and push_cuda ran with no host sync")

    # device memory a call allocates beyond what the node already holds
    for name, fn in (
            ("localize_step", lambda: localize_step(
                grid, pose, loc.last_pose, data, mask, loc.params)),
            ("push_cuda", lambda: push_cuda(grid, geom, pose, data, mask))):
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - held
        print(f"peak device memory {name}: {peak / 2**20:.1f} MiB above "
              f"the {held / 2**20:.1f} MiB held [{label}]")
    t = {}
    t["push kernel (push_cuda: tile cull + copy + kernel)"] = time_cuda(
        lambda: push_cuda(grid, geom, pose, data, mask))
    t["push plain (grid/push.py::push on the card)"] = time_cuda(
        lambda: push(grid, geom, pose, data, mask))

    # the kernel launch alone, on the same inputs
    touch, empty_inc, meta, table = tile_meta(grid, geom, pose, data, mask)
    tsd, w = grid.tsd.clone(), grid.weight.clone()
    t["push kernel launch alone (tsd_push_f32)"] = time_cuda(
        lambda: launch(grid, geom, tsd, w, table, meta, pose))
    active = int((touch | (empty_inc & grid.tile_init)).sum())
    print(f"push: {active} of {touch.numel()} tiles active in the timed push")

    model = raycast(grid, geom, pose)
    scene, smask = data_to_cartesian(geom, data, mask)
    t["raycast (exact march)"] = time_cuda(
        lambda: raycast(grid, geom, pose))
    t["icp (25 iterations)"] = time_cuda(
        lambda: icp(model.coords, model.mask, scene, smask,
                    loc.params.icp, sensor_pose=pose,
                    model_normals=model.normals))
    t["localize_step"] = time_cuda(
        lambda: localize_step(grid, pose, loc.last_pose, data, mask,
                              loc.params))

    # whole process_scan on robot0's continued trajectory (host clock,
    # ends in the node's own reads of the device); some scans push
    gt = trajectory(xyt, N_TIMED + 3)[1:]
    msgs = [LaserScan(ranges=scan_ranges(p, geom.max_range),
                      angle_min=PHI_MIN, angle_increment=RES,
                      range_max=geom.max_range, stamp=100.0 + i)
            for i, p in enumerate(gt)]
    wall, pushed = [], 0
    for i, msg in enumerate(msgs):
        before = push_cuda.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        node.process_scan(0, msg)
        torch.cuda.synchronize()
        if i >= 3:
            wall.append((time.perf_counter() - t0) * 1e3)
            pushed += push_cuda.launches - before
    t[f"process_scan (host clock; {pushed} of {len(wall)} pushed)"] = wall

    pub = []
    for i in range(N_TIMED + 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        node.publish_map()
        if i >= 3:
            pub.append((time.perf_counter() - t0) * 1e3)
    t["publish_map (host clock, incl. copy to host)"] = pub
    medians = {}
    for name, ms in t.items():
        q1, med, q3 = statistics.quantiles(ms, n=4)
        medians[name] = statistics.median(ms)
        print(f"time {name}: median {medians[name]:.4f} ms, quartiles "
              f"{q1:.4f}-{q3:.4f} ms, n={len(ms)} [{label}]")
    return medians


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ohm_tsd_slam_tpu_torch.ops import _build
    from ohm_tsd_slam_tpu_torch.ops.push_cuda import push_cuda

    dev = torch.device("cuda")
    # 1. device
    label = card_label()
    print(f"nvidia-smi name, power.limit: {label}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # 2. build (from the sources in this checkout, never a cached library)
    lib = os.path.join(_build.BUILD_DIR, "libpush.so")
    if os.path.exists(lib):
        os.remove(lib)
    t0 = time.perf_counter()
    _build.load("push")
    print(f"build csrc/push.cu with nvcc: {time.perf_counter() - t0:.2f} s")

    # 3. kernel check
    check = kernel_check(dev)
    for name, stats in check.items():
        print(f"kernel check {name}: {json.dumps(stats)}")

    # 4. main path
    node, launches = main_path(dev, label)

    # 5. times
    times = stage_times(node, label)

    kernels = [{
        "name": "tsd_push_f32",
        "route": "cuda",
        "source": "ohm_tsd_slam_tpu_torch/csrc/push.cu",
        "replaces": "ohm_tsd_slam_tpu/ops/push_pallas.py:272",
        "launches": launches,
        "max_abs_err": check["three_poses"]["max_abs_err"],
        "ms": times["push kernel (push_cuda: tile cull + copy + kernel)"],
        "plain_ms": times["push plain (grid/push.py::push on the card)"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
