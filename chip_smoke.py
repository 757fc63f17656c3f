#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ohm_tsd_slam_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each of which raises on failure:

1. device: requires torch.cuda; prints the card's name and power limit;
2. build: deletes and recompiles every CUDA kernel of the main path from
   csrc/ (five libraries, one nvcc process each, all started together);
3. kernel check: the push kernel against the plain push, both float32 on
   the card, at 1024^2 / 0.025 m / 1081 beams (three poses into one grid,
   a sensor outside the grid, an all-masked scan); the fast caster's four
   kernels (segment layers, row pack, segment min, window replay) against
   their plain twins at every call of the caster (ops/kernel_check.py), on
   four synthetic fields: a thin sliver that forces the candidate rounds,
   a noise field whose segments overflow the capacity (the node falls
   back to the exact march), an empty grid, a sensor outside the grid;
4. main path: SlamNode with configs/double-laser.yaml's settings (two
   robots sharing the grid, 25 ICP iterations, the fast caster), ~60
   simulated scans per robot through process_scan, then publish_map; then
   the caster's kernels against their twins on the grid it built;
5. times: first a check that extract_segments, localize_step and the push
   wrapper make no host sync, then medians and quartiles of 25 runs after
   a warm-up, each printed beside the card's name and power limit, and the
   peak device memory of the caster's stages.

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

# the fast caster's kernels: wrapper module under ops/, C function, source
# and the TPU kernel it replaces
CASTER = [
    ("segment_layers", "segment_layers_f32",
     "ohm_tsd_slam_tpu/ops/segment_layers_pallas.py:180"),
    ("pack_rows", "pack_rows_f32",
     "ohm_tsd_slam_tpu/ops/pack_rows_pallas.py:96"),
    ("segment_min", "segment_min_f32",
     "ohm_tsd_slam_tpu/ops/raycast_pallas.py:202"),
    ("window_replay", "window_replay_f32",
     "ohm_tsd_slam_tpu/ops/window_block_pallas.py:425, :764"),
]

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


def caster_wrappers() -> dict:
    """name -> the wrapper function (with its `launches` count)."""
    import importlib

    return {name: getattr(importlib.import_module(
        f"ohm_tsd_slam_tpu_torch.ops.{name}_cuda"), name)
        for name, _, _ in CASTER}


def geom_1081(max_range=30.0):
    from ohm_tsd_slam_tpu_torch.sensor.polar2d import SensorPolar2D

    return SensorPolar2D(size=BEAMS, angular_res=RES, phi_min=PHI_MIN,
                         max_range=max_range, min_range=0.01)


def merge_stats(total: dict, check) -> None:
    for name, st in check.stats.items():
        t = total.setdefault(name, {"calls": 0, "max_abs_err": 0.0})
        t["calls"] += st["calls"]
        t["max_abs_err"] = max(t["max_abs_err"], st["max_abs_err"])


def checked_render(grid, geom, xyt, total: dict, max_segments=None):
    """Extraction and one render on the kernel path, every kernel call
    held against its twin; returns (cache, result, exact-march result)."""
    from ohm_tsd_slam_tpu_torch.core import se2
    from ohm_tsd_slam_tpu_torch.grid import raycast_fast as rf
    from ohm_tsd_slam_tpu_torch.grid.raycast import raycast
    from ohm_tsd_slam_tpu_torch.ops.kernel_check import KernelCheck

    check = KernelCheck()
    seg = rf.extract_segments(grid, max_segments, kernels=check.kernels)
    pose = se2.make(*xyt, device=grid.tsd.device)
    res = rf.raycast_fast(grid, geom, pose, segments=seg,
                          kernels=check.kernels)
    exact = raycast(grid, geom, pose)
    torch.cuda.synchronize()
    merge_stats(total, check)
    return check, seg, res, exact


def agreement(res, exact) -> dict:
    """Fast caster against the exact march: share of beams whose mask
    agrees, and the largest coordinate gap where both hit."""
    both = res.mask & exact.mask
    gap = (res.coords[both] - exact.coords[both]).abs()
    return {"hits": int(res.mask.sum()), "exact_hits": int(exact.mask.sum()),
            "agree": float((res.mask == exact.mask).float().mean()),
            "max_coord_gap": float(gap.max()) if gap.numel() else 0.0}


def caster_check(dev, total: dict) -> dict:
    """The four caster kernels against their twins on synthetic fields."""
    from ohm_tsd_slam_tpu_torch.config import from_flat_params
    from ohm_tsd_slam_tpu_torch.grid import raycast_fast as rf
    from ohm_tsd_slam_tpu_torch.grid.state import from_arrays
    from ohm_tsd_slam_tpu_torch.slam import LaserScan, SlamNode
    from ohm_tsd_slam_tpu_torch.utils.testing import (
        field_arrays,
        noise_field,
        sliver_field,
    )

    geom = geom_1081()
    s = 0.025
    out = {}

    def grid_of(f):
        return from_arrays(field_arrays(f.astype(np.float32), s), device=dev)

    # a 2 m sliver at x = 15.0 m, a wall from x = 17.5 m; the sensor 5 m
    # left of the sliver: beams that step over it end at the wall, found
    # in the later candidate rounds (fewer than UNRESOLVED_CAP of them)
    sliver = grid_of(sliver_field(CELLS, 600, 700, rows=(472, 552)))
    xyt = (10.0, 12.8, 0.05)
    check, seg, res, exact = checked_render(sliver, geom, xyt, total)
    x_hit = (res.coords[:, 0] * math.cos(xyt[2])
             - res.coords[:, 1] * math.sin(xyt[2]) + xyt[0])
    # C at K=1 then K=ROUNDS-1; D on all beams, then on the round slots
    mins = [f["finite"] for n, _, f in check.log if n == "segment_min"]
    replays = [f["hits"] for n, _, f in check.log if n == "window_replay"]
    out["sliver"] = dict(agreement(res, exact),
                         wall_hits=int((res.mask & (x_hit > 17.0)).sum()),
                         segment_min_finite=mins, window_replay_hits=replays)
    assert len(mins) == 2 and len(mins[1]) == rf.ROUNDS - 1, out["sliver"]
    assert mins[1][0] > 0 and len(replays) == rf.ROUNDS, out["sliver"]
    assert sum(replays[1:]) > 10, out["sliver"]      # hits in the rounds
    assert out["sliver"]["wall_hits"] > 10, out["sliver"]
    assert int(res.n_dropped) == 0, out["sliver"]
    assert torch.equal(res.mask, exact.mask), out["sliver"]

    # noise: far more segments than MAX_SEGMENTS; B counts the drops
    noise = grid_of(noise_field(CELLS, seed=3))
    check, seg, res, _ = checked_render(noise, geom, (12.8, 12.8, 0.0),
                                        total)
    out["noise"] = {"segments": int(seg.count),
                    "n_dropped": int(seg.n_dropped),
                    "rays_dropped": int(res.n_dropped)}
    assert int(seg.count) == rf.MAX_SEGMENTS and int(seg.n_dropped) > 0
    assert int(res.n_dropped) >= int(seg.n_dropped)
    # ... and the node falls back to the exact march on that grid
    cfg = from_flat_params({**DOUBLE_LASER, "robot_nbr": 1})
    node = SlamNode(cfg, dtype=torch.float32, device=dev)
    half = cfg.grid.size_meters * 0.5
    for k in range(2):
        node.process_scan(0, LaserScan(
            ranges=scan_ranges((half, half, 0.0), 30.0), angle_min=PHI_MIN,
            angle_increment=RES, range_max=30.0, stamp=float(k)))
        if k == 0:
            node.grid = noise
    loc = node.localizers[0]
    out["noise"]["node_rays_dropped"] = loc.rays_dropped
    assert loc.params.fast_raycast and loc.rays_dropped > 0, out["noise"]

    for name, grid, xyt in (
            ("empty", from_arrays(field_arrays(
                np.full((CELLS, CELLS), np.nan, np.float32), s), device=dev),
             (12.8, 12.8, 0.0)),
            ("sensor_outside", sliver, (60.0, 60.0, 0.0))):
        check, seg, res, exact = checked_render(grid, geom, xyt, total)
        out[name] = dict(agreement(res, exact), segments=int(seg.count))
        assert not res.mask.any() and not exact.mask.any(), out[name]
    return out


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


def watch_plain(on_cuda: list) -> list:
    """Wrap every plain version a wrapper runs for a CPU tensor so that a
    call with a CUDA tensor is recorded in `on_cuda`; returns the
    (module, name, original) list to restore."""
    import importlib

    targets = [(importlib.import_module(
        "ohm_tsd_slam_tpu_torch.ops.push_cuda"), "push")]
    targets += [(importlib.import_module(
        f"ohm_tsd_slam_tpu_torch.ops.{name}_cuda"), f"{name}_plain")
        for name, _, _ in CASTER]
    saved = []
    for mod, attr in targets:
        orig = getattr(mod, attr)

        def watched(*args, _orig=orig, _name=attr, **kwargs):
            if any(getattr(getattr(a, "tsd", a), "is_cuda", False)
                   for a in args):
                on_cuda.append(_name)
            return _orig(*args, **kwargs)

        setattr(mod, attr, watched)
        saved.append((mod, attr, orig))
    return saved


def main_path(dev, label: str):
    """Both robots through SlamNode.process_scan, then publish_map."""
    from ohm_tsd_slam_tpu_torch.config import from_flat_params
    from ohm_tsd_slam_tpu_torch.ops.push_cuda import push_cuda
    from ohm_tsd_slam_tpu_torch.slam import LaserScan, SlamNode

    cfg = from_flat_params(DOUBLE_LASER)
    node = SlamNode(cfg, dtype=torch.float32, device=dev)
    assert node.mapper._push_fn is push_cuda, node.mapper._push_fn

    # no plain version may see a CUDA tensor on the main path: the
    # wrappers are the only way there
    plain_on_cuda = []
    saved = watch_plain(plain_on_cuda)
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

    wrappers = caster_wrappers()
    push_cuda.launches = 0           # counts from the main path only
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    errs = [[], []]
    n_scans = updates = 0
    for k in range(SCANS_PER_ROBOT):
        for r in range(2):
            before = node.grid.tsd
            out = node.process_scan(r, LaserScan(
                ranges=scans[r][k], angle_min=PHI_MIN, angle_increment=RES,
                range_max=cfg.robots[r].sensor.max_range, stamp=float(k)))
            updates += node.grid.tsd is not before
            if k == 0:
                assert out is None
                continue
            n_scans += 1
            assert node.localizers[r].rays_dropped == 0, (r, k)
            assert out is not None and not out.is_nan, (r, k)
            est = node.localizers[r].pose.cpu().numpy()
            assert np.isfinite(est).all(), (r, k)
            x, y, _ = gts[r][k]
            errs[r].append(math.hypot(est[0, 2] - x, est[1, 2] - y))
    occ, img = node.publish_map()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"push": push_cuda.launches}
    launches.update({name: fn.launches for name, fn in wrappers.items()})
    for mod, attr, orig in saved:
        setattr(mod, attr, orig)

    limit = 2.5 * cfg.grid.cellsize
    for r in range(2):
        print(f"main path robot{r}: max |pose - truth| = "
              f"{max(errs[r]):.6f} m, final {errs[r][-1]:.6f} m "
              f"(limit {limit} m)")
        assert max(errs[r]) < limit, (r, max(errs[r]))
    print(f"main path: {len(n_pushes)} pushes, {updates} grid versions, "
          f"{n_scans} localized scans (fast caster, rays_dropped 0 on "
          f"each); kernel launches {json.dumps(launches)}; plain versions "
          f"on CUDA {len(plain_on_cuda)}; {2 * SCANS_PER_ROBOT} scans + "
          f"publish_map in {wall:.3f} s (first-call overheads included) "
          f"[{label}]")
    assert all(loc.params.fast_raycast for loc in node.localizers)
    assert launches["push"] >= len(n_pushes) > 2, launches
    # A and B once per grid version, C twice and D ROUNDS times per scan
    # (rays_dropped 0 on every scan: no scan fell back to the exact march)
    from ohm_tsd_slam_tpu_torch.grid.raycast_fast import ROUNDS

    assert launches["segment_layers"] == launches["pack_rows"] >= updates
    assert launches["segment_min"] == 2 * n_scans, launches
    assert launches["window_replay"] == ROUNDS * n_scans, launches
    assert not plain_on_cuda, plain_on_cuda
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


def main_grid_check(node, total: dict) -> dict:
    """The caster's kernels against their twins on the grid the main path
    built, from each robot's last pose; the result against the exact
    march (tests/test_raycast_fast.py's bound: 98% of beams agree)."""
    out = {}
    for r, loc in enumerate(node.localizers):
        p = loc.pose
        xyt = (float(p[0, 2]), float(p[1, 2]),
               math.atan2(float(p[1, 0]), float(p[0, 0])))
        _, seg, res, exact = checked_render(node.grid, loc.geom, xyt,
                                            total)
        out[f"robot{r}"] = dict(agreement(res, exact),
                                segments=int(seg.count),
                                n_dropped=int(res.n_dropped))
        assert int(res.n_dropped) == 0, out
        assert out[f"robot{r}"]["agree"] > 0.98, out
        assert out[f"robot{r}"]["max_coord_gap"] < 1e-3, out
        assert out[f"robot{r}"]["hits"] > 500, out
    return out


def peak_mib(fn) -> tuple:
    """Device memory fn() allocates above what is held, and what is held."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - held) / 2**20, held / 2**20


def stage_times(node, label: str) -> dict:
    """Median times of the main path's stages on the card."""
    import dataclasses

    from ohm_tsd_slam_tpu_torch.grid import raycast_fast as rf
    from ohm_tsd_slam_tpu_torch.grid.compact import compact_mask
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
    params = loc.params
    exact_params = dataclasses.replace(params, fast_raycast=False)
    xyt = (float(pose[0, 2]), float(pose[1, 2]),
           math.atan2(float(pose[1, 0]), float(pose[0, 0])))
    data, mask = node._preprocess(loc, scan_ranges(xyt, geom.max_range))
    seg = node._segments_for(grid)

    def localize(p=params):
        return localize_step(grid, pose, loc.last_pose, data, mask, p,
                             segments=seg)

    # extraction, localize_step (fast caster + ICP + gates) and the push
    # wrapper queue their work without reading anything back: any host
    # sync raises here
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rf.extract_segments(grid)
        localize()
        push_cuda(grid, geom, pose, data, mask)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print("sync check: extract_segments, localize_step (fast caster) and "
          "push_cuda ran with no host sync")

    # device memory a call allocates beyond what the node already holds
    for name, fn in (
            ("extract_segments", lambda: rf.extract_segments(grid)),
            ("raycast_fast", lambda: rf.raycast_fast(grid, geom, pose,
                                                     segments=seg)),
            ("localize_step", localize),
            ("push_cuda", lambda: push_cuda(grid, geom, pose, data, mask))):
        peak, held = peak_mib(fn)
        print(f"peak device memory {name}: {peak:.1f} MiB above the "
              f"{held:.1f} MiB held [{label}]")
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

    # the caster's kernels alone against their twins, at the main path's
    # inputs: the layers and pack of this grid, the round-1 candidate
    # sweep and window replay of robot0's 1081 beams
    ks = caster_wrappers()
    S = rf.MAX_SEGMENTS
    lmask, rows = ks["segment_layers"](grid)
    t["A segment_layers kernel"] = time_cuda(
        lambda: ks["segment_layers"](grid))
    t["A segment_layers plain"] = time_cuda(
        lambda: rf.segment_layers_plain(grid))
    t["B pack_rows kernel"] = time_cuda(
        lambda: ks["pack_rows"](grid, lmask, rows, S))
    t["B pack_rows plain"] = time_cuda(
        lambda: rf.pack_rows_plain(grid, lmask, S))
    t["extract_segments (A + B + candidate pack)"] = time_cuda(
        lambda: rf.extract_segments(grid))
    twins = rf.CasterKernels(
        rf.segment_layers_plain,
        lambda g, m, rows, size: rf.pack_rows_plain(g, m, size),
        rf.segment_min_plain, rf.window_replay_plain)
    t["extract_segments plain (twins of A + B, candidate pack)"] = time_cuda(
        lambda: rf.extract_segments(grid, kernels=twins))
    ray, tr, idx_min, idx_max, feasible = rf.beam_geometry(grid, geom, pose)
    lo = (torch.floor(idx_min) - 1.0).clamp(min=0.0)
    hi = torch.ceil(idx_max) + 1.0
    tr_pack = (tr - seg.origin).contiguous()
    cargs = (seg.pack, seg.count, ray, lo, hi, lo, tr_pack)
    t["C segment_min kernel (K=1)"] = time_cuda(
        lambda: ks["segment_min"](*cargs))
    t["C segment_min plain (K=1)"] = time_cuda(
        lambda: rf.segment_min_plain(*cargs))
    t_1 = ks["segment_min"](*cargs)[:, 0]
    has = torch.isfinite(t_1) & feasible
    k_1 = torch.where(has, t_1, 0.0)
    tw0 = idx_min + (torch.floor(k_1 - idx_min) - rf.BACKOFF).clamp(min=0.0)
    dargs = (grid, tw0, ray, idx_max, has, tr.contiguous())
    t["D window_replay kernel (round 1)"] = time_cuda(
        lambda: ks["window_replay"](*dargs))
    t["D window_replay plain (round 1)"] = time_cuda(
        lambda: rf.window_replay_plain(*dargs))

    # the rounds as the main path launches them: C at K=ROUNDS-1 for the
    # beams round 1 left unresolved, D on the first round's compacted slots
    resolved = (ks["window_replay"](*dargs)[:, 1] > 0.0) | ~has
    t_after = torch.where(resolved, math.inf,
                          torch.maximum(lo, k_1 + rf.COVER))
    c3args = (seg.pack, seg.count, ray, lo, hi, t_after, tr_pack,
              rf.ROUNDS - 1, rf.COVER)
    t["C segment_min kernel (K=3, rounds)"] = time_cuda(
        lambda: ks["segment_min"](*c3args))
    t["C segment_min plain (K=3, rounds)"] = time_cuda(
        lambda: rf.segment_min_plain(*c3args))
    t_2 = ks["segment_min"](*c3args)[:, 0]
    need = torch.isfinite(t_2) & ~resolved
    cap = rf.unresolved_cap(ray.shape[0])
    idx_u, uvalid = compact_mask(need, cap)
    k_u = torch.where(uvalid, t_2[idx_u], 0.0)
    tw_u = idx_min[idx_u] + (torch.floor(k_u - idx_min[idx_u])
                             - rf.BACKOFF).clamp(min=0.0)
    uargs = (grid, tw_u, ray[idx_u].contiguous(), idx_max[idx_u], uvalid,
             tr.contiguous())
    t[f"D window_replay kernel (round 2, {cap} slots)"] = time_cuda(
        lambda: ks["window_replay"](*uargs))
    t[f"D window_replay plain (round 2, {cap} slots)"] = time_cuda(
        lambda: rf.window_replay_plain(*uargs))
    print(f"rounds: {int(need.sum())} of {cap} round-2 slots active in the "
          "timed round")

    t["raycast_fast (cached segments, kernels)"] = time_cuda(
        lambda: rf.raycast_fast(grid, geom, pose, segments=seg))
    t["raycast (exact march)"] = time_cuda(
        lambda: raycast(grid, geom, pose))
    model = rf.raycast_fast(grid, geom, pose, segments=seg)
    scene, smask = data_to_cartesian(geom, data, mask)
    t["icp (25 iterations)"] = time_cuda(
        lambda: icp(model.coords, model.mask, scene, smask,
                    params.icp, sensor_pose=pose,
                    model_normals=model.normals))
    t["localize_step (fast caster)"] = time_cuda(localize)
    t["localize_step (exact march)"] = time_cuda(
        lambda: localize(exact_params))

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
        assert loc.rays_dropped == 0
        if i >= 3:
            wall.append((time.perf_counter() - t0) * 1e3)
            pushed += push_cuda.launches - before
    t[f"process_scan (host clock, fast caster; {pushed} of {len(wall)} "
      "pushed)"] = wall

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

    dev = torch.device("cuda")
    # 1. device
    label = card_label()
    print(f"nvidia-smi name, power.limit: {label}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # 2. build (from the sources in this checkout, never a cached library)
    names = ["push"] + [name for name, _, _ in CASTER]
    for name in names:
        if os.path.exists(_build.lib_path(name)):
            os.remove(_build.lib_path(name))
    t0 = time.perf_counter()
    _build.build_all(names)
    for name in names:
        _build.load(name)
    print(f"build {len(names)} sources in csrc/ with nvcc, in parallel: "
          f"{time.perf_counter() - t0:.2f} s")

    # 3. kernel check
    check = kernel_check(dev)
    for name, stats in check.items():
        print(f"kernel check {name}: {json.dumps(stats)}")
    caster_stats: dict = {}
    for name, stats in caster_check(dev, caster_stats).items():
        print(f"kernel check caster {name}: {json.dumps(stats)}")

    # 4. main path, then the caster's kernels on the grid it built
    node, launches = main_path(dev, label)
    for name, stats in main_grid_check(node, caster_stats).items():
        print(f"kernel check caster main-path grid {name}: "
              f"{json.dumps(stats)}")
    print(f"kernel check caster, every call: {json.dumps(caster_stats)}")

    # 5. times
    times = stage_times(node, label)

    kernels = [{
        "name": "tsd_push_f32",
        "route": "cuda",
        "source": "ohm_tsd_slam_tpu_torch/csrc/push.cu",
        "replaces": "ohm_tsd_slam_tpu/ops/push_pallas.py:272",
        "launches": launches["push"],
        "max_abs_err": check["three_poses"]["max_abs_err"],
        "ms": times["push kernel (push_cuda: tile cull + copy + kernel)"],
        "plain_ms": times["push plain (grid/push.py::push on the card)"],
    }]
    for (name, fn, replaces), tag in zip(CASTER, "ABCD"):
        key = next(k for k in times if k.startswith(f"{tag} {name} kernel"))
        kernels.append({
            "name": fn,
            "route": "cuda",
            "source": f"ohm_tsd_slam_tpu_torch/csrc/{name}.cu",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": caster_stats[name]["max_abs_err"],
            "ms": times[key],
            "plain_ms": times[key.replace(" kernel", " plain")],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
