#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ohm_tsd_slam_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each of which raises on failure:

1. device: requires torch.cuda; prints the card's name and power limit;
2. build: deletes and recompiles every CUDA kernel of the main paths from
   csrc/ (six libraries, one nvcc process each, all started together), and
   prints ptxas's registers and stack frame of the push and window replay
   kernels;
3. kernel check: the push kernel against the plain push, both float32 on
   the card, at 1024^2 / 0.025 m / 1081 beams (three poses into one grid,
   a sensor outside the grid, an all-masked scan), its per-tile cull
   (touch, empty_inc, part_weight, tile_init, tile_initw) against
   grid/push.py::tile_cull on every tile (ops/kernel_check.py::PushCheck,
   which also checks every push of every main path); the fast caster's
   kernels (segment layers, row pack, segment min, window replay, window
   rounds) against their plain twins at every call of the caster
   (ops/kernel_check.py), on four synthetic fields: a thin sliver that
   forces the candidate rounds, a noise field whose segments overflow the
   capacity (the node falls back to the exact march), an empty grid, a
   sensor outside the grid; the rounds kernel also with a capacity of 4 on
   the sliver (more needing beams than replays: the drop counts must be
   equal) and with no needing beam; the channel compaction (kernel E)
   against its twin, bit for bit, on the noise field's layer stack
   (overflow), an empty and a full mask, channels with NaN and Inf, a
   float mask, n = 16384;
4. main paths, each with the launch counts set to 0 before and read after
   (one push launch a push, A and B or E once per grid version, C twice
   and D's two entry points once each per scan):
   a. ICP mode: SlamNode with configs/double-laser.yaml's settings (two
      robots sharing the grid, 25 ICP iterations, the fast caster), ~30
      simulated scans per robot through process_scan, then publish_map;
      then the caster's kernels against their twins on the grid it built,
      and kernel E on that grid's layer stack against its twin and against
      the pack of kernels A + B (two routes to one answer);
   b. general extraction: SlamNode at map_size 6 (64 cells a row, narrower
      than kernels A and B take), ICP mode: kernel E once per grid
      version, A and B never;
   c. TSD mode, the reference's shipped default: SlamNode with
      configs/single-laser.yaml's settings (match_tsd seed, then ICP), 60
      scans, twice from one seed (the pose traces must be equal bit for
      bit), then publish_map; then 10 scans each in the modes EXP and PDF;
5. times: first a check that extract_segments, localize_step (in every
   ported mode) and the push wrapper make no host sync, then medians and
   quartiles of 25 runs after a warm-up, each printed beside the card's
   name and power limit, and the peak device memory of the caster's stages
   and of each matcher.

The line before the last is a JSON object describing each kernel, with its
time beside its bound on this card (the larger of the bytes the function
must move over the HBM rate and its operations over the float32 rate, both
counted by `kernel_bounds` from this run's inputs) and, where one PyTorch
call computes the same function, that call's time.  A row's `ms` is its
wrapper's time; the push kernel, kernel D's two entry points and kernel E
also carry `kernel_ms` (the launch alone on held buffers; for D the
wrapper, which holds nothing) and `device_ms` (that launch replayed from a
CUDA graph: the device's share without the host's).  The last line is
{"ok": true, "device": {...}} and is printed only when every phase passed.
Imports nothing of JAX.
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
SCANS_PER_ROBOT = 30         # the ICP-mode path (two robots)
SCANS_TSD = 60               # the TSD-mode path (one robot)
SCANS_OTHER = 10             # EXP and PDF, from the TSD run's start
SCANS_NARROW = 15            # the general-extraction path
N_TIMED = 25

# published peaks of one H100 SXM (NVIDIA's data sheet): the rates the
# kernels' bounds are taken against
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

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
     "ohm_tsd_slam_tpu/ops/window_block_pallas.py:425"),
    ("compact_channels", "compact_channels_f32",
     "ohm_tsd_slam_tpu/ops/compact_pallas.py:200"),
    ("window_rounds", "window_rounds_f32",
     "ohm_tsd_slam_tpu/ops/window_block_pallas.py:764"),
]
# the source (csrc/<source>.cu, wrapped by ops/<source>_cuda.py) of a
# wrapper that is not named after its source
SOURCE = {"window_rounds": "window_replay"}
# the plain version each wrapper runs for a CPU tensor
PLAIN = {name: f"{name}_plain" for name, _, _ in CASTER}
PLAIN["compact_channels"] = "pack_channels_rows"

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

# configs/single-laser.yaml, as a flat parameter dict: one robot, the
# TSD-likelihood RANSAC seed before ICP (the reference's shipped default)
SINGLE_LASER = {
    "map_size": 10, "cellsize": 0.025, "truncation_radius": 3.0,
    "occ_grid_time_interval": 2.0, "x_off_factor": 0.5, "y_off_factor": 0.5,
    "max_range": 30.0, "min_range": 0.01, "low_reflectivity_range": 2.0,
    "laser_min_range": 0.0,
    "registration_mode": 3, "icp_iterations": 30,
    "dist_filter_min": 0.2, "dist_filter_max": 1.0,
    "reg_trs_max": 0.25, "reg_sin_rot_max": 0.17,
    "trials": 100, "epsThresh": 0.15, "sizeControlSet": 180,
    "ransac_phi_max": 30.0,
    "zhit": 0.45, "zshort": 0.25, "zmax": 0.05, "zrand": 0.25,
    "sighit": 0.2, "lamshort": 0.08, "rangemax": 20.0,
    "percentagePointsInC": 0.9,
    "pub_tsd_color_map": True, "use_object_inflation": False,
    "object_inflation_factor": 2,
    "footprint_width": 1.0, "footprint_height": 1.0,
    "footprint_x_offset": 0.28,
}

# a walkable room on a grid narrower than kernels A and B take: 64 cells
# of 0.1 m a side
NARROW = {
    "map_size": 6, "cellsize": 0.1, "truncation_radius": 3.0,
    "registration_mode": 0, "icp_iterations": 25,
    "max_range": 30.0, "min_range": 0.01,
    "footprint_width": 0.6, "footprint_height": 0.6,
    "footprint_x_offset": 0.0,
}
NARROW_WORLD = dict(walls=(0.7, 0.7, 5.7, 5.7),
                    circles=[((4.6, 4.5), 0.35), ((1.9, 4.4), 0.3)])


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


def narrow_world():
    from ohm_tsd_slam_tpu_torch.utils.testing import rect_walls

    return rect_walls(*NARROW_WORLD["walls"]), NARROW_WORLD["circles"]


def scan_ranges(xyt, max_range, scene=world):
    from ohm_tsd_slam_tpu_torch.utils.testing import simulate_scan

    x, y, th = xyt
    pose = np.array([[math.cos(th), -math.sin(th), x],
                     [math.sin(th), math.cos(th), y], [0.0, 0.0, 1.0]])
    segs, circles = scene()
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


GRAPH_REPS = 20              # calls captured into one graph by time_device


def time_device(fn, n=N_TIMED, reps=GRAPH_REPS) -> list:
    """ms of fn()'s device work alone: `reps` calls in a row are captured
    into a CUDA graph, each replay is timed between CUDA events and divided
    by `reps`, so the host's work per launch (Python, ctypes, the CUDA
    runtime's queueing) is left out and the replay's own launch (some 10 us)
    is spread over the calls.  fn must launch on the current stream; the
    calls run back to back, each on the caches the one before left."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return [ms / reps for ms in time_cuda(graph.replay, n)]


def compact_launch(mask, chans, size):
    """Kernel E's launch alone on buffers held here, as a closure."""
    from ohm_tsd_slam_tpu_torch.ops import compact_channels_cuda as cc

    dev = mask.device
    packed = torch.empty((len(chans) + 1, size + cc.ROW),
                         dtype=torch.float32, device=dev)
    row_cnt = torch.empty(mask.numel() // cc.ROW, dtype=torch.int32,
                          device=dev)
    row_off, total = torch.empty_like(row_cnt), row_cnt.new_empty(1)
    return lambda: cc.launch(mask, chans, packed, row_cnt, row_off, total)


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
        f"ohm_tsd_slam_tpu_torch.ops.{SOURCE.get(name, name)}_cuda"), name)
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


def checked_render(grid, geom, xyt, total: dict, max_segments=None,
                   rounds_args: list = None):
    """Extraction and one render on the kernel path, every kernel call
    held against its twin; returns (check, cache, result, exact-march
    result).  `rounds_args` takes a copy of what the render gave the
    rounds kernel."""
    from ohm_tsd_slam_tpu_torch.core import se2
    from ohm_tsd_slam_tpu_torch.grid import raycast_fast as rf
    from ohm_tsd_slam_tpu_torch.grid.raycast import raycast
    from ohm_tsd_slam_tpu_torch.ops.kernel_check import KernelCheck

    check = KernelCheck()
    kernels = check.kernels
    if rounds_args is not None:
        def grab(grid_, S, *rest):
            rounds_args[:] = [grid_, S.clone(), *rest]
            return check.kernels.window_rounds(grid_, S, *rest)

        kernels = kernels._replace(window_rounds=grab)
    seg = rf.extract_segments(grid, max_segments, kernels=kernels)
    pose = se2.make(*xyt, device=grid.tsd.device)
    res = rf.raycast_fast(grid, geom, pose, segments=seg, kernels=kernels)
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
    rounds_args: list = []
    check, seg, res, exact = checked_render(sliver, geom, xyt, total,
                                            rounds_args=rounds_args)
    x_hit = (res.coords[:, 0] * math.cos(xyt[2])
             - res.coords[:, 1] * math.sin(xyt[2]) + xyt[0])
    # C at K=1 then K=ROUNDS-1; D on all beams, then its rounds in one call
    mins = [f["finite"] for n, _, f in check.log if n == "segment_min"]
    replays = [f["hits"] for n, _, f in check.log if n == "window_replay"]
    rounds = [f for n, _, f in check.log if n == "window_rounds"]
    out["sliver"] = dict(agreement(res, exact),
                         wall_hits=int((res.mask & (x_hit > 17.0)).sum()),
                         segment_min_finite=mins, window_replay_hits=replays,
                         window_rounds=rounds)
    assert len(mins) == 2 and len(mins[1]) == rf.ROUNDS - 1, out["sliver"]
    assert mins[1][0] > 0 and len(replays) == len(rounds) == 1, out["sliver"]
    assert rounds[0]["new_hits"] > 10, out["sliver"]   # hits in the rounds
    assert rounds[0]["dropped"] == 0, out["sliver"]
    assert out["sliver"]["wall_hits"] > 10, out["sliver"]
    assert int(res.n_dropped) == 0, out["sliver"]
    assert torch.equal(res.mask, exact.mask), out["sliver"]

    # the rounds kernel at the same inputs with 4 replays a round (more
    # beams need one: the drop count must equal the twin's) and with no
    # candidate at all (nothing replayed, every beam resolved)
    from ohm_tsd_slam_tpu_torch.ops.kernel_check import KernelCheck

    check = KernelCheck()
    g_, S, lev, *beams, cap = rounds_args
    check.kernels.window_rounds(g_, S.clone(), lev, *beams, 4)
    S_none, dropped = check.kernels.window_rounds(
        g_, S.clone(), torch.full_like(lev, math.inf), *beams, cap)
    torch.cuda.synchronize()
    forced, none = [f for _, _, f in check.log]
    out["rounds_forced_overflow"] = dict(forced, cap=4)
    out["rounds_none_needed"] = dict(none, cap=cap)
    assert forced["dropped"] > 0 and forced["finite"][0] > 4, forced
    assert none["dropped"] == int(dropped) == 0 and none["new_hits"] == 0
    assert bool((S_none[:, 1] > 0).all()), none
    assert check.stats["window_rounds"] == {"calls": 2, "max_abs_err": 0.0}
    merge_stats(total, check)

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


def kernel_check(dev, push_check) -> dict:
    """The push kernel against the plain push; `push_check`
    (ops/kernel_check.py::PushCheck) launches it and holds its cull
    against tile_cull on every tile."""
    from ohm_tsd_slam_tpu_torch.config import GridConfig
    from ohm_tsd_slam_tpu_torch.core import se2
    from ohm_tsd_slam_tpu_torch.grid.push import push
    from ohm_tsd_slam_tpu_torch.grid.state import create
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
        g_ker = push_check(g_ker, geom, pose, data, mask)
        torch.cuda.synchronize()
    results["three_poses"] = compare_push(g_ref, g_ker)
    assert results["three_poses"]["finite_cells"] > 100_000
    # the error of the kernel before it took the cull (1.28e-5) is the limit
    assert results["three_poses"]["max_abs_err"] <= 1.3e-5, results

    inf = torch.full((BEAMS,), math.inf, device=dev)
    none = torch.zeros(BEAMS, dtype=torch.bool, device=dev)
    for name, xyt in [("sensor_outside", (60.0, 60.0, 0.0)),
                      ("all_masked", (12.8, 12.8, 0.0))]:
        pose = se2.make(*xyt, device=dev)
        g_k = push_check(grid0, geom, pose, inf, none)
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
        f"ohm_tsd_slam_tpu_torch.ops.{SOURCE.get(name, name)}_cuda"),
        PLAIN[name]) for name, _, _ in CASTER]
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


def reset_counts() -> None:
    """Every wrapper's launch count to 0, just before a main path."""
    from ohm_tsd_slam_tpu_torch.ops.push_cuda import push_cuda

    push_cuda.launches = 0
    for fn in caster_wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    """The launch counts, just after a main path."""
    from ohm_tsd_slam_tpu_torch.ops.push_cuda import push_cuda

    counts = {"push": push_cuda.launches}
    counts.update({name: fn.launches
                   for name, fn in caster_wrappers().items()})
    return counts


def drive(node, cfg, gts, scans) -> dict:
    """Every robot's scans through node.process_scan, in turns.  Returns
    the tracking errors per robot, the localized scans, the grid versions
    made after the first and the pose trace (on the card)."""
    n_robots = len(gts)
    errs = [[] for _ in range(n_robots)]
    trace = []
    n_scans = updates = 0
    for k in range(len(gts[0])):
        for r in range(n_robots):
            before = node.grid.tsd
            out = node.process_scan(r, scan_msg(
                scans[r][k], cfg.robots[r].sensor.max_range, float(k)))
            updates += node.grid.tsd is not before
            if k == 0:
                assert out is None
                continue
            n_scans += 1
            assert node.localizers[r].rays_dropped == 0, (r, k)
            assert out is not None and not out.is_nan, (r, k)
            trace.append(node.localizers[r].pose)
    poses = torch.stack(trace).cpu()
    assert bool(torch.isfinite(poses).all())
    i = 0
    for k in range(1, len(gts[0])):
        for r in range(n_robots):
            x, y, _ = gts[r][k]
            errs[r].append(math.hypot(float(poses[i, 0, 2]) - x,
                                      float(poses[i, 1, 2]) - y))
            i += 1
    return {"errs": errs, "n_scans": n_scans, "updates": updates,
            "trace": poses}


def scan_msg(ranges, max_range, stamp):
    from ohm_tsd_slam_tpu_torch.slam import LaserScan

    return LaserScan(ranges=ranges, angle_min=PHI_MIN, angle_increment=RES,
                     range_max=max_range, stamp=stamp)


def main_path(dev, label: str, push_check):
    """The ICP-mode path: both robots through SlamNode.process_scan, then
    publish_map.  The mapper pushes through `push_check`, which calls
    push_cuda and holds the kernel's cull against tile_cull."""
    from ohm_tsd_slam_tpu_torch.config import from_flat_params
    from ohm_tsd_slam_tpu_torch.ops.push_cuda import push_cuda
    from ohm_tsd_slam_tpu_torch.slam import SlamNode

    cfg = from_flat_params(DOUBLE_LASER)
    node = SlamNode(cfg, dtype=torch.float32, device=dev)
    assert node.mapper._push_fn is push_cuda, node.mapper._push_fn

    # no plain version may see a CUDA tensor on the main path: the
    # wrappers are the only way there
    plain_on_cuda = []
    saved = watch_plain(plain_on_cuda)
    kernel_push = node.mapper._push_fn
    node.mapper._push_fn = push_check
    pushes_before = push_check.stats["calls"]

    half = cfg.grid.size_meters * 0.5
    starts = [(half + rc.local_offset_x, half + rc.local_offset_y,
               rc.local_offset_yaw) for rc in cfg.robots]
    gts = [trajectory(s, SCANS_PER_ROBOT) for s in starts]
    scans = [[scan_ranges(p, rc.sensor.max_range) for p in gt]
             for gt, rc in zip(gts, cfg.robots)]

    reset_counts()                   # counts from the main path only
    t0 = time.perf_counter()
    run = drive(node, cfg, gts, scans)
    errs, n_scans, updates = run["errs"], run["n_scans"], run["updates"]
    occ, img = node.publish_map()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    n_pushes = push_check.stats["calls"] - pushes_before
    for mod, attr, orig in saved:
        setattr(mod, attr, orig)

    limit = 2.5 * cfg.grid.cellsize
    for r in range(2):
        print(f"main path robot{r}: max |pose - truth| = "
              f"{max(errs[r]):.6f} m, final {errs[r][-1]:.6f} m "
              f"(limit {limit} m)")
        assert max(errs[r]) < limit, (r, max(errs[r]))
    print(f"main path (ICP mode): {n_pushes} pushes, {updates} grid "
          f"versions, "
          f"{n_scans} localized scans (fast caster, rays_dropped 0 on "
          f"each); kernel launches {json.dumps(launches)}; plain versions "
          f"on CUDA {len(plain_on_cuda)}; {2 * SCANS_PER_ROBOT} scans + "
          f"publish_map in {wall:.3f} s (first-call overheads included) "
          f"[{label}]")
    assert all(loc.params.fast_raycast for loc in node.localizers)
    # one launch a push; A and B once per grid version; C twice and D's
    # two entry points once each per scan (rays_dropped 0 on every scan: no
    # scan fell back to the exact march)
    assert launches["push"] == n_pushes > 2, launches
    assert launches["segment_layers"] == launches["pack_rows"] >= updates
    assert launches["segment_min"] == 2 * n_scans, launches
    assert launches["window_replay"] == n_scans, launches
    assert launches["window_rounds"] == n_scans, launches
    assert launches["compact_channels"] == 0, launches   # a 1024-wide grid
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


def compact_check(dev, total: dict) -> dict:
    """Kernel E against its twin, every bit, on synthetic inputs."""
    from ohm_tsd_slam_tpu_torch.grid import raycast_fast as rf
    from ohm_tsd_slam_tpu_torch.grid.state import from_arrays
    from ohm_tsd_slam_tpu_torch.ops.kernel_check import KernelCheck
    from ohm_tsd_slam_tpu_torch.utils.testing import field_arrays, noise_field

    check = KernelCheck()
    compact = check.kernels.compact_channels
    S = rf.MAX_SEGMENTS
    out = {}

    # the noise field: 4 Mi lanes, far more set lanes than the capacity
    noise = from_arrays(field_arrays(
        noise_field(CELLS, seed=3).astype(np.float32), 0.025), device=dev)
    mask, chans = rf._segment_layers(noise)
    packed, count = compact(mask, chans, S)
    out["noise_overflow"] = {"lanes": mask.numel(), "set": int(count),
                             "stored": int((packed[4] > 0).sum())}
    assert int(count) == int(mask.sum()) > S + 128, out
    assert out["noise_overflow"]["stored"] == S + 128, out

    rng = np.random.default_rng(6)
    n = 16384                      # a 64^2 grid's layer stack
    base = [torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(dev)
            for _ in range(4)]
    sparse = torch.from_numpy(rng.random(n) < 0.02).to(dev)
    special = [c.clone() for c in base]
    for c, v in zip(special, (math.nan, math.inf, -math.inf, math.nan)):
        # at set and at unset lanes alike
        c[torch.from_numpy(rng.choice(n, 600, replace=False)).to(dev)] = v
    for name, m, cs, size in (
            ("empty", torch.zeros(n, dtype=torch.bool, device=dev), base, 256),
            ("full", torch.ones(n, dtype=torch.bool, device=dev), base, 256),
            ("nan_inf", sparse, special, 512),
            ("float_mask", sparse.float(), base, 512),
            ("one_channel", sparse, base[:1], 128)):
        packed, count = compact(m, tuple(cs), size)
        out[name] = {"lanes": n, "set": int(count),
                     "nan_slots": int(torch.isnan(packed).sum())}
    assert out["empty"]["set"] == 0 and out["full"]["set"] == n, out
    assert out["nan_inf"]["nan_slots"] > 0, out
    torch.cuda.synchronize()
    merge_stats(total, check)
    return out


def main_grid_compact_check(node, total: dict) -> dict:
    """Kernel E on the layer stack of the grid the ICP-mode path built
    (4 Mi lanes, 4 channels, the full capacity) against its twin, and its
    pack against the pack of kernels A + B on the same grid."""
    from ohm_tsd_slam_tpu_torch.grid import raycast_fast as rf
    from ohm_tsd_slam_tpu_torch.ops.kernel_check import (
        POS_TOL,
        KernelCheck,
        bit_mismatch,
    )

    check = KernelCheck()
    S = rf.MAX_SEGMENTS
    general, n_g = rf._pack_general(node.grid, S, check.kernels)
    fused, n_f = rf._pack_fused(node.grid, S, rf.cuda_kernels())
    torch.cuda.synchronize()
    merge_stats(total, check)
    out = {"lanes": 4 * CELLS * CELLS, "segments": int(n_g),
           "segments_a_b": int(n_f),
           "general_vs_a_b_max_abs_err": bit_mismatch(general, fused)}
    assert out["segments"] == out["segments_a_b"] > 1000, out
    assert out["general_vs_a_b_max_abs_err"] <= POS_TOL, out
    return out


def narrow_path(dev, label: str, total: dict, push_check):
    """The general-extraction path: SlamNode at map_size 6 on the card,
    whose 64-cell rows kernels A and B do not take, ICP mode."""
    from ohm_tsd_slam_tpu_torch.config import from_flat_params
    from ohm_tsd_slam_tpu_torch.grid import raycast_fast as rf
    from ohm_tsd_slam_tpu_torch.slam import SlamNode

    cfg = from_flat_params(NARROW)
    node = SlamNode(cfg, dtype=torch.float32, device=dev)
    assert not rf.fused_extraction(node.grid)
    kernel_push = node.mapper._push_fn
    node.mapper._push_fn = push_check
    pushes_before = push_check.stats["calls"]
    half = cfg.grid.size_meters * 0.5
    gts = [trajectory((half, half, 0.0), SCANS_NARROW)]
    scans = [[scan_ranges(p, 30.0, scene=narrow_world) for p in gts[0]]]

    plain_on_cuda = []
    saved = watch_plain(plain_on_cuda)
    reset_counts()
    run = drive(node, cfg, gts, scans)
    torch.cuda.synchronize()
    launches = read_counts()
    n_pushes = push_check.stats["calls"] - pushes_before
    node.mapper._push_fn = kernel_push
    for mod, attr, orig in saved:
        setattr(mod, attr, orig)

    limit = 2.5 * cfg.grid.cellsize
    err = max(run["errs"][0])
    print(f"general-extraction path (map_size 6, {cfg.grid.cellsize} m "
          f"cells): {run['n_scans']} localized scans, {run['updates']} grid "
          f"versions, max |pose - truth| = {err:.6f} m (limit {limit} m), "
          f"rays_dropped 0 on each; kernel launches {json.dumps(launches)} "
          f"[{label}]")
    assert err < limit, err
    # E once per grid version (the first scan's and every drain's), A and
    # B never; C and D as on every path
    assert launches["compact_channels"] == run["updates"] > 2, launches
    assert launches["segment_layers"] == launches["pack_rows"] == 0
    assert launches["segment_min"] == 2 * run["n_scans"], launches
    assert launches["window_replay"] == run["n_scans"], launches
    assert launches["window_rounds"] == run["n_scans"], launches
    assert launches["push"] == n_pushes >= run["updates"], launches
    assert not plain_on_cuda, plain_on_cuda

    # the render on that grid: the kernels against their twins, the result
    # against the exact march
    loc = node.localizers[0]
    p = loc.pose
    xyt = (float(p[0, 2]), float(p[1, 2]),
           math.atan2(float(p[1, 0]), float(p[0, 0])))
    check, seg, res, exact = checked_render(node.grid, loc.geom, xyt, total)
    stats = dict(agreement(res, exact), segments=int(seg.count),
                 n_dropped=int(res.n_dropped))
    print(f"kernel check caster general-extraction grid: {json.dumps(stats)}")
    assert check.stats["compact_channels"]["calls"] == 1, check.stats
    assert check.stats["segment_layers"]["calls"] == 0, check.stats
    assert stats["n_dropped"] == 0 and stats["agree"] > 0.98, stats
    assert stats["max_coord_gap"] < 1e-3 and stats["hits"] > 500, stats
    return node, launches


def ransac_paths(dev, label: str, push_check):
    """The RANSAC pre-registration paths at full width: TSD mode with
    configs/single-laser.yaml's settings (1024^2 cells, 1081 beams, 100
    trials, the yaml's control set), twice from one seed; then EXP and PDF
    from the same start."""
    from ohm_tsd_slam_tpu_torch.config import RegMode, from_flat_params
    from ohm_tsd_slam_tpu_torch.slam import SlamNode

    cfg = from_flat_params(SINGLE_LASER)
    half = cfg.grid.size_meters * 0.5
    gts = [trajectory((half, half, 0.0), SCANS_TSD)]
    scans = [[scan_ranges(p, 30.0) for p in gts[0]]]
    limit = 2.5 * cfg.grid.cellsize

    def run_mode(mode, n, seed=0):
        flat = {**SINGLE_LASER, "registration_mode": int(mode)}
        c = from_flat_params(flat)
        node = SlamNode(c, dtype=torch.float32, device=dev, seed=seed)
        kernel_push = node.mapper._push_fn
        node.mapper._push_fn = push_check
        pushes_before = push_check.stats["calls"]
        plain_on_cuda = []
        saved = watch_plain(plain_on_cuda)
        reset_counts()
        t0 = time.perf_counter()
        run = drive(node, c, [gts[0][:n]], [scans[0][:n]])
        torch.cuda.synchronize()
        run["wall"] = time.perf_counter() - t0
        run["launches"] = read_counts()
        n_pushes = push_check.stats["calls"] - pushes_before
        node.mapper._push_fn = kernel_push    # the node as its users run it
        for mod, attr, orig in saved:
            setattr(mod, attr, orig)
        loc = node.localizers[0]
        assert loc.params.mode == int(mode) and loc.params.fast_raycast
        assert loc.params.ransac.trials == SINGLE_LASER["trials"]
        assert (loc.params.ransac.size_control_set
                == SINGLE_LASER["sizeControlSet"])
        assert loc.scan_count == run["n_scans"] == n - 1
        assert not plain_on_cuda, plain_on_cuda
        err = max(run["errs"][0])
        print(f"{RegMode(mode).name} path: {run['n_scans']} localized "
              f"scans, {run['updates']} grid versions, max |pose - truth| = "
              f"{err:.6f} m, final {run['errs'][0][-1]:.6f} m (limit {limit} "
              f"m), rays_dropped 0 on each; kernel launches "
              f"{json.dumps(run['launches'])}; {run['wall']:.3f} s "
              f"[{label}]")
        assert err < limit, (mode, err)
        la = run["launches"]
        assert la["segment_layers"] == la["pack_rows"] >= run["updates"], la
        assert la["segment_min"] == 2 * run["n_scans"], la
        assert la["window_replay"] == la["window_rounds"] == run["n_scans"]
        assert la["push"] == n_pushes >= run["updates"] > 2, la
        return node, run

    node, run = run_mode(RegMode.TSD, SCANS_TSD)
    occ, _ = node.publish_map()
    n_occ = int((occ.data == 100).sum())
    n_free = int((occ.data == 0).sum())
    print(f"TSD path: occupancy {occ.data.shape} occupied {n_occ} free "
          f"{n_free}")
    assert occ.data.shape == (CELLS, CELLS)
    assert n_occ > 1000 and n_free > 10000
    _, again = run_mode(RegMode.TSD, SCANS_TSD)
    assert torch.equal(run["trace"], again["trace"]), \
        "TSD mode: the same seed gave another pose trace"
    _, other = run_mode(RegMode.TSD, SCANS_OTHER, seed=1)
    n = len(other["trace"])
    print(f"TSD path: the same seed gives the same {len(run['trace'])}-pose "
          f"trace bit for bit; seed 1 differs from seed 0 in "
          f"{int((other['trace'] != run['trace'][:n]).any(-1).any(-1).sum())}"
          f" of its first {n} poses")
    for mode in (RegMode.EXP, RegMode.PDF):
        run_mode(mode, SCANS_OTHER + 1)
    return node, run["launches"]


def peak_mib(fn) -> tuple:
    """Device memory fn() allocates above what is held, and what is held."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - held) / 2**20, held / 2**20


def device_kernels(fn):
    """(device kernels and copies launched, their summed device time in
    ms) of one fn(), from torch.profiler after a warm-up call; None where
    the profiler shows no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    on_device = [e for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
    if not on_device:
        return None
    return len(on_device), sum(e.device_time for e in on_device) * 1e-3


def device_kernel_counts(node, label: str) -> None:
    """Device kernels each stage of the main path launches (the render and
    the step are bound by their count, not by the device's work).  Run
    after every time is taken: once the profiler has run, its tracing hooks
    stay in the process and slow every later launch."""
    from ohm_tsd_slam_tpu_torch.grid import raycast_fast as rf
    from ohm_tsd_slam_tpu_torch.ops.push_cuda import push_cuda
    from ohm_tsd_slam_tpu_torch.slam.localize import localize_step

    loc = node.localizers[0]
    grid, geom, pose = node.grid, loc.geom, loc.pose.contiguous()
    xyt = (float(pose[0, 2]), float(pose[1, 2]),
           math.atan2(float(pose[1, 0]), float(pose[0, 0])))
    data, mask = node._preprocess(loc, scan_ranges(xyt, geom.max_range))
    seg = node._segments_for(grid)
    for name, fn in (
            ("push_cuda", lambda: push_cuda(grid, geom, pose, data, mask)),
            ("extract_segments", lambda: rf.extract_segments(grid)),
            ("raycast_fast", lambda: rf.raycast_fast(grid, geom, pose,
                                                     segments=seg)),
            ("localize_step", lambda: localize_step(
                grid, pose, loc.last_pose, data, mask, loc.params,
                segments=seg))):
        found = device_kernels(fn)
        print(f"device kernels {name}: " + (
            "not measured (the profiler shows no device activity)"
            if found is None else
            f"{found[0]} launched, {found[1]:.4f} ms of device time")
            + f" [{label}]")


def stage_times(node, label: str) -> dict:
    """Median times of the main path's stages on the card."""
    import dataclasses

    from ohm_tsd_slam_tpu_torch.grid import raycast_fast as rf
    from ohm_tsd_slam_tpu_torch.grid.compact import pack_channels_rows
    from ohm_tsd_slam_tpu_torch.grid.push import push, tile_cull
    from ohm_tsd_slam_tpu_torch.grid.raycast import raycast
    from ohm_tsd_slam_tpu_torch.ops.push_cuda import (
        empty_like,
        launch,
        push_cuda,
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
    t["push kernel (push_cuda: four allocations + one launch)"] = time_cuda(
        lambda: push_cuda(grid, geom, pose, data, mask))
    t["push plain (grid/push.py::push on the card)"] = time_cuda(
        lambda: push(grid, geom, pose, data, mask))

    # the kernel launch alone into a held result, on the same inputs
    held = empty_like(grid)
    t["push kernel launch alone (tsd_push_f32)"] = time_cuda(
        lambda: launch(grid, geom, pose, data, mask, held))
    t["push kernel device time (tsd_push_f32 replayed from a CUDA graph)"] = \
        time_device(lambda: launch(grid, geom, pose, data, mask, held))
    touch, empty_inc, _ = tile_cull(grid, geom, pose, data, mask)
    active = int((touch | (empty_inc & grid.tile_init)).sum())
    print(f"push: {active} of {touch.numel()} tiles active in the timed push")
    facts = {"push_active_tiles": active, "tile_dim": grid.tile_dim,
             "tiles": touch.numel()}

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
    # the one PyTorch call that computes B's and E's function: boolean
    # selection of each dense channel (it reads the count back to the host)
    dmask, dchans = rf._segment_layers(grid)
    t["B pack_rows library (masked_select of 4 dense channels)"] = time_cuda(
        lambda: [torch.masked_select(c, dmask) for c in dchans])
    t["E compact_channels kernel (n=4194304, this grid's layer stack)"] = \
        time_cuda(lambda: ks["compact_channels"](dmask, dchans, S))
    big_launch = compact_launch(dmask, dchans, S)
    t["E compact_channels launch alone (n=4194304: compact_channels_f32 on "
      "held buffers)"] = time_cuda(big_launch)
    t["E compact_channels device time (n=4194304: replayed from a CUDA "
      "graph)"] = time_device(big_launch)
    t["E compact_channels plain (n=4194304, this grid's layer stack)"] = \
        time_cuda(lambda: pack_channels_rows(dmask, dchans, S))
    t["E compact_channels library (n=4194304: masked_select of 4 "
      "channels)"] = t["B pack_rows library (masked_select of 4 dense "
                       "channels)"]
    facts.update(lanes=dmask.numel(), segments=int(seg.count),
                 nonzero_rows=int((rows > 0).sum()))
    t["extract_segments (A + B + candidate pack)"] = time_cuda(
        lambda: rf.extract_segments(grid))
    twins = rf.CasterKernels(
        rf.segment_layers_plain,
        lambda g, m, rows, size: rf.pack_rows_plain(g, m, size),
        rf.segment_min_plain, rf.window_replay_plain, pack_channels_rows,
        rf.window_rounds_plain)
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
    dargs = (grid, k_1, ray, idx_min, idx_max, has, tr.contiguous())
    t["D window_replay kernel (round 1)"] = time_cuda(
        lambda: ks["window_replay"](*dargs))
    t["D window_replay plain (round 1)"] = time_cuda(
        lambda: rf.window_replay_plain(*dargs))
    # the wrapper holds nothing but its result: its launch alone is the
    # wrapper, and its device work the wrapper replayed from a CUDA graph
    t["D window_replay device time (round 1, replayed from a CUDA graph)"] = \
        time_device(lambda: ks["window_replay"](*dargs))

    # the rounds as the main path launches them: C at K=ROUNDS-1 for the
    # beams round 1 left unresolved, then D's rounds entry point once
    S0 = ks["window_replay"](*dargs)
    resolved = (S0[:, 1] > 0.0) | ~has
    S0[:, 1] = resolved.to(S0.dtype)
    t_after = torch.where(resolved, math.inf,
                          torch.maximum(lo, k_1 + rf.COVER))
    c3args = (seg.pack, seg.count, ray, lo, hi, t_after, tr_pack,
              rf.ROUNDS - 1, rf.COVER)
    t["C segment_min kernel (K=3, rounds)"] = time_cuda(
        lambda: ks["segment_min"](*c3args))
    t["C segment_min plain (K=3, rounds)"] = time_cuda(
        lambda: rf.segment_min_plain(*c3args))
    lev = ks["segment_min"](*c3args)
    cap = rf.unresolved_cap(ray.shape[0])
    rargs = (lev, ray, idx_min, idx_max, tr.contiguous(), cap)
    # the kernel resolves its state in place: every timed call gets a
    # fresh copy of round 1's state, made before the clock starts
    fresh = iter([S0.clone() for _ in range(N_TIMED + 3)])
    t["D window_rounds kernel (rounds 2-4)"] = time_cuda(
        lambda: ks["window_rounds"](grid, next(fresh), *rargs))
    t["D window_rounds plain (rounds 2-4)"] = time_cuda(
        lambda: rf.window_rounds_plain(grid, S0, *rargs))
    # from a graph the state must be restored on the device: the copy of
    # its 8 floats a beam is timed with the kernel, and alone beside it
    S_work = S0.clone()
    t["D window_rounds device time (rounds 2-4 after a copy of the state, "
      "replayed from a CUDA graph)"] = time_device(
        lambda: (S_work.copy_(S0), ks["window_rounds"](grid, S_work, *rargs)))
    t["D window_rounds state copy alone (replayed from a CUDA graph)"] = \
        time_device(lambda: S_work.copy_(S0))
    needing = [int(n) for n in torch.isfinite(lev).sum(0)]
    print(f"rounds: beams with a candidate in rounds 2-4 of the timed call: "
          f"{needing} (capacity {cap})")
    facts.update(rounds_needing=sum(needing), rounds=rf.ROUNDS - 1)

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
    return report_times(t, label), facts


def report_times(t: dict, label: str) -> dict:
    """Print median and quartiles of each list of ms; return the medians."""
    medians = {}
    for name, ms in t.items():
        q1, _, q3 = statistics.quantiles(ms, n=4)
        medians[name] = statistics.median(ms)
        print(f"time {name}: median {medians[name]:.4f} ms, quartiles "
              f"{q1:.4f}-{q3:.4f} ms, n={len(ms)} [{label}]")
    return medians


def ransac_times(node, narrow, label: str) -> tuple:
    """Sync checks and times of this slice's stages: the matchers and the
    TSD-mode step on `node` (the TSD path's), the general extraction and
    kernel E at its main-path shape on `narrow` (the map_size 6 node)."""
    import dataclasses

    from ohm_tsd_slam_tpu_torch.config import RegMode
    from ohm_tsd_slam_tpu_torch.grid import raycast_fast as rf
    from ohm_tsd_slam_tpu_torch.grid.compact import pack_channels_rows
    from ohm_tsd_slam_tpu_torch.ops.compact_channels_cuda import (
        compact_channels,
    )
    from ohm_tsd_slam_tpu_torch.registration import ransac
    from ohm_tsd_slam_tpu_torch.sensor.polar2d import data_to_cartesian
    from ohm_tsd_slam_tpu_torch.slam.localize import localize_step

    loc = node.localizers[0]
    grid, geom, pose = node.grid, loc.geom, loc.pose.contiguous()
    xyt = (float(pose[0, 2]), float(pose[1, 2]),
           math.atan2(float(pose[1, 0]), float(pose[0, 0])))
    data, mask = node._preprocess(loc, scan_ranges(xyt, geom.max_range))
    seg = node._segments_for(grid)
    model = rf.raycast_fast(grid, geom, pose, segments=seg)
    scene, smask = data_to_cartesian(geom, data, mask)
    rp, beam = loc.params.ransac, loc.params.beam
    clouds = (model.coords, model.mask, scene, smask)
    modes = {m: dataclasses.replace(loc.params, mode=int(m))
             for m in (RegMode.TSD, RegMode.EXP, RegMode.PDF)}

    def localize(mode=RegMode.TSD):
        return localize_step(grid, pose, loc.last_pose, data, mask,
                             modes[mode], generator=node._draws(0, 1000),
                             segments=seg)

    matchers = {
        "match_tsd": lambda p=rp: ransac.match_tsd(
            node._draws(0, 1000), grid, pose, *clouds, p),
        "match_normal": lambda p=rp: ransac.match_normal(
            node._draws(0, 1000), *clouds, p),
        "match_pdf": lambda p=rp: ransac.match_pdf(
            node._draws(0, 1000), *clouds, p, beam),
    }

    # no ported mode reads the device inside localize_step; the general
    # extraction queues its work like the fused one
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for m in modes:
            localize(m)
        rf.extract_segments(narrow.grid)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print("sync check: localize_step in the modes TSD, EXP and PDF and the "
          "general extract_segments ran with no host sync")

    for name, fn in (*matchers.items(), ("localize_step (TSD)", localize)):
        peak, held = peak_mib(fn)
        print(f"peak device memory {name}: {peak:.1f} MiB above the "
              f"{held:.1f} MiB held [{label}]")

    t = {}
    # kernel E at the shape its main path gives it: the 64^2 grid's stack
    nmask, nchans = rf._segment_layers(narrow.grid)
    S = rf.MAX_SEGMENTS
    t["E compact_channels kernel (n=16384, map_size 6 stack)"] = time_cuda(
        lambda: compact_channels(nmask, nchans, S))
    small_launch = compact_launch(nmask, nchans, S)
    t["E compact_channels launch alone (n=16384: compact_channels_f32 on "
      "held buffers)"] = time_cuda(small_launch)
    t["E compact_channels device time (n=16384: replayed from a CUDA "
      "graph)"] = time_device(small_launch)
    t["E compact_channels plain (n=16384, map_size 6 stack)"] = time_cuda(
        lambda: pack_channels_rows(nmask, nchans, S))
    t["E compact_channels library (n=16384: masked_select of 4 "
      "channels)"] = time_cuda(
        lambda: [torch.masked_select(c, nmask) for c in nchans])
    t["extract_segments general (map_size 6: layers + E + candidate "
      "pack)"] = time_cuda(lambda: rf.extract_segments(narrow.grid))
    facts = {"narrow_lanes": nmask.numel(),
             "narrow_segments": int(nmask.sum())}

    K = rp.trials * 2 * rp.span
    print(f"matchers: {geom.size} beams, {rp.trials} trials x "
          f"{2 * rp.span} offsets = {K} candidates, {rp.size_control_set} "
          f"control points, chunk {rp.chunk}; model {int(model.mask.sum())} "
          f"and scene {int(smask.sum())} valid points")
    t["_prepare"] = time_cuda(lambda: ransac._prepare(
        node._draws(0, 1000), *clouds, rp))
    for name, fn in matchers.items():
        t[name] = time_cuda(fn)
    t["localize_step (TSD mode, fast caster)"] = time_cuda(localize)
    t["localize_step (ICP mode, same scan)"] = time_cuda(
        lambda: localize_step(
            grid, pose, loc.last_pose, data, mask,
            dataclasses.replace(loc.params, mode=int(RegMode.ICP)),
            segments=seg))

    # EXP and PDF by chunk: time (5 runs) and peak memory
    for chunk in (64, 256, 1024):
        p = dataclasses.replace(rp, chunk=chunk)
        for name in ("match_normal", "match_pdf"):
            fn = matchers[name]
            peak, _ = peak_mib(lambda: fn(p))
            ms = statistics.median(time_cuda(lambda: fn(p), n=5, warmup=1))
            print(f"chunk {chunk}: {name} median {ms:.4f} ms (n=5), peak "
                  f"{peak:.1f} MiB [{label}]")

    # whole process_scan in TSD mode on the continued trajectory (host
    # clock, ends in the node's own reads of the device); some scans push
    from ohm_tsd_slam_tpu_torch.ops.push_cuda import push_cuda

    gt = trajectory(xyt, N_TIMED + 3)[1:]
    wall, pushed = [], 0
    for i, p in enumerate(gt):
        msg = scan_msg(scan_ranges(p, geom.max_range), geom.max_range,
                       100.0 + i)
        before = push_cuda.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        node.process_scan(0, msg)
        torch.cuda.synchronize()
        assert loc.rays_dropped == 0
        if i >= 3:
            wall.append((time.perf_counter() - t0) * 1e3)
            pushed += push_cuda.launches - before
    t[f"process_scan (TSD mode, host clock; {pushed} of {len(wall)} "
      "pushed)"] = wall
    return report_times(t, label), facts


def kernel_bounds(facts: dict) -> dict:
    """name -> (bound_ms, bound_by): the least time this card could take
    for each kernel's work at the inputs of this run's timed call, the
    larger of bytes / HBM rate and operations / float32 rate.  Bytes count
    each input the work needs once and each output once; where the work
    depends on the data (active tiles, rows that hold a segment, segments
    kept) the counts are this run's.  Operations per element are counted
    from the sources, roughly."""
    beams = BEAMS
    cells = CELLS * CELLS
    rows = 4 * cells // 128
    cap = 32768 + 128
    segs = facts["segments"]
    work = {
        # out of place: tsd and weight of the whole grid read and written
        # (an inactive tile is copied through), the ranges and their mask,
        # the two tile arrays in and out; ~60 operations a cell of an
        # active tile (atan2, bin, running average), ~150 a tile for the
        # cull (four corner bins) and 4 a beam of the scan for its spans
        "push": (cells * 16 + beams * 5 + facts["tiles"] * 10,
                 facts["push_active_tiles"] * facts["tile_dim"] ** 2 * 60
                 + facts["tiles"] * 150 + beams * 4),
        # the field read, the 4-layer mask and the row counts written
        "segment_layers": (cells * 4 + 4 * cells * 4 + rows * 4, cells * 40),
        # row counts read, the mask rows that hold a segment, 4 field taps
        # a segment, the pack written (zeros included)
        "pack_rows": (rows * 4 + facts["nonzero_rows"] * 512 + segs * 16
                      + 5 * cap * 4, segs * 40),
        # K = 1: the kept segments' 8 pack rows, 7 values a beam, one t
        # out; ~20 operations a beam-segment pair
        "segment_min": (segs * 32 + beams * 28 + beams * 4,
                        beams * segs * 20),
        # round 1: 8 samples + 4 normal taps of 4 cells a beam, 7 values
        # in, 8 out; ~25 operations a tap
        "window_replay": (beams * (12 * 16 + 28 + 32), beams * 12 * 25),
        # the rounds: a beam's candidates and its resolved flag read, the
        # flag written; a replay (taps, 5 values in, a row out) for each
        # beam with a candidate in this run; ~6 operations a beam a round
        "window_rounds": (beams * (facts["rounds"] * 4 + 8)
                          + facts["rounds_needing"] * (12 * 16 + 20 + 32),
                          beams * facts["rounds"] * 6
                          + facts["rounds_needing"] * 12 * 25),
        # main-path shape: the bool mask read, 4 values a set lane, the
        # pack written; one compare a lane
        "compact_channels": (facts["narrow_lanes"]
                             + facts["narrow_segments"] * 16 + 5 * cap * 4,
                             facts["narrow_lanes"]),
        "compact_channels_large": (facts["lanes"] + segs * 16 + 5 * cap * 4,
                                   facts["lanes"]),
    }
    out = {}
    for name, (n_bytes, n_ops) in work.items():
        by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        by_ops = n_ops / F32_FLOP_PER_S * 1e3
        out[name] = (max(by_bytes, by_ops),
                     "bytes" if by_bytes >= by_ops else "operations")
    return out


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
    names = ["push"] + [name for name, _, _ in CASTER if name not in SOURCE]
    for name in names:
        if os.path.exists(_build.lib_path(name)):
            os.remove(_build.lib_path(name))
    t0 = time.perf_counter()
    _build.build_all(names)
    for name in names:
        _build.load(name)
    print(f"build {len(names)} sources in csrc/ with nvcc, in parallel: "
          f"{time.perf_counter() - t0:.2f} s")
    for name in ("push", "window_replay"):
        frames = []
        for line in _build.resource_usage(name):
            if ("Used" in line or "Function properties" in line
                    or "stack frame" in line):
                print(f"ptxas csrc/{name}.cu: {line}")
            if "stack frame" in line:
                frames.append(line)
        # neither kernel indexes a local array at run time or spills
        assert frames and all(f.startswith("0 bytes stack frame, 0 bytes "
                                           "spill stores") for f in frames), \
            (name, frames)

    # 3. kernel check
    from ohm_tsd_slam_tpu_torch.ops.kernel_check import PushCheck

    push_check = PushCheck()
    check = kernel_check(dev, push_check)
    for name, stats in check.items():
        print(f"kernel check {name}: {json.dumps(stats)}")
    print(f"kernel check push cull vs tile_cull: "
          f"{json.dumps(push_check.stats)}")
    caster_stats: dict = {}
    for name, stats in caster_check(dev, caster_stats).items():
        print(f"kernel check caster {name}: {json.dumps(stats)}")
    for name, stats in compact_check(dev, caster_stats).items():
        print(f"kernel check compact_channels {name}: {json.dumps(stats)}")

    # 4a. the ICP-mode path, then the caster's kernels on the grid it built
    node, launches = main_path(dev, label, push_check)
    for name, stats in main_grid_check(node, caster_stats).items():
        print(f"kernel check caster main-path grid {name}: "
              f"{json.dumps(stats)}")
    print("kernel check compact_channels main-path grid: "
          f"{json.dumps(main_grid_compact_check(node, caster_stats))}")

    # 4b. the general-extraction path; 4c. TSD, then EXP and PDF
    narrow, narrow_launches = narrow_path(dev, label, caster_stats,
                                          push_check)
    tsd_node, tsd_launches = ransac_paths(dev, label, push_check)
    print(f"kernel check caster, every call: {json.dumps(caster_stats)}")
    # every push of the kernel check and of the five paths: PushCheck
    # raises on the first tile that disagrees, so the counts below are 0
    print(f"kernel check push cull vs tile_cull, every push: "
          f"{json.dumps(push_check.stats)}")
    st = push_check.stats
    assert st["touch_flips"] == st["empty_inc_flips"] == 0, st
    assert st["part_weight_mismatches"] == st["tile_init_mismatches"] == 0
    assert st["tile_initw_mismatches"] == 0 and st["touched"] > 1000, st
    for name, st in caster_stats.items():
        assert st["calls"] > 0, (name, st)

    # 5. times
    times, facts = stage_times(node, label)
    more, more_facts = ransac_times(tsd_node, narrow, label)
    times.update(more)
    facts.update(more_facts)
    bounds = kernel_bounds(facts)
    device_kernel_counts(node, label)

    def entry(name, fn, replaces, key, launches_, err, bound, library=None,
              **extra):
        return {
            "name": fn, "route": "cuda",
            "source": f"ohm_tsd_slam_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches_, "max_abs_err": err,
            "ms": times[key],
            "plain_ms": times[key.replace(" kernel", " plain")],
            "bound_ms": bounds[bound][0], "bound_by": bounds[bound][1],
            "library_ms": times[library] if library else None, **extra}

    # every row's `ms` is its wrapper's time, as `plain_ms` is the whole
    # plain function's.  Where the launch was also timed apart from the
    # wrapper's host work, `kernel_ms` is the launch alone on held buffers
    # and `device_ms` its device work replayed from a CUDA graph
    times["push kernel"] = times["push kernel (push_cuda: four allocations "
                                 "+ one launch)"]
    times["push plain"] = times["push plain (grid/push.py::push on the card)"]
    kernels = [entry(
        "push", "tsd_push_f32", "ohm_tsd_slam_tpu/ops/push_pallas.py:272",
        "push kernel", launches["push"],
        check["three_poses"]["max_abs_err"], "push",
        kernel_ms=times["push kernel launch alone (tsd_push_f32)"],
        device_ms=times["push kernel device time (tsd_push_f32 replayed "
                        "from a CUDA graph)"],
        launches_tsd_path=tsd_launches["push"])]
    for (name, fn, replaces), tag in zip(CASTER, "ABCDED"):
        key = next(k for k in times if k.startswith(f"{tag} {name} kernel"))
        extra = {"launches_tsd_path": tsd_launches[name]}
        library = None
        count = launches[name]
        if tag == "D":
            # the wrapper holds no buffer: its launch alone is the wrapper
            extra.update(kernel_ms=times[key], device_ms=times[next(
                k for k in times if k.startswith(f"D {name} device time"))])
        if name == "window_rounds":
            extra["state_copy_device_ms"] = times[
                "D window_rounds state copy alone (replayed from a CUDA "
                "graph)"]
        if name == "pack_rows":
            library = "B pack_rows library (masked_select of 4 dense channels)"
        if name == "compact_channels":
            # its main path is the general extraction: the 64^2 grid's stack
            key = "E compact_channels kernel (n=16384, map_size 6 stack)"
            library = ("E compact_channels library (n=16384: masked_select "
                       "of 4 channels)")
            count = narrow_launches[name]
            big = ("E compact_channels kernel (n=4194304, this grid's layer "
                   "stack)")
            extra = {
                "launches_tsd_path": tsd_launches[name],
                "kernel_ms": times[
                    "E compact_channels launch alone (n=16384: "
                    "compact_channels_f32 on held buffers)"],
                "device_ms": times[
                    "E compact_channels device time (n=16384: replayed "
                    "from a CUDA graph)"],
                "kernel_ms_4mi_lanes": times[
                    "E compact_channels launch alone (n=4194304: "
                    "compact_channels_f32 on held buffers)"],
                "device_ms_4mi_lanes": times[
                    "E compact_channels device time (n=4194304: replayed "
                    "from a CUDA graph)"],
                "ms_4mi_lanes": times[big],
                "plain_ms_4mi_lanes": times[big.replace(" kernel", " plain")],
                "library_ms_4mi_lanes": times[
                    "E compact_channels library (n=4194304: masked_select "
                    "of 4 channels)"],
                "bound_ms_4mi_lanes": bounds["compact_channels_large"][0]}
        kernels.append(entry(SOURCE.get(name, name), fn, replaces, key,
                             count, caster_stats[name]["max_abs_err"], name,
                             library, **extra))
    for k in kernels:
        assert k["launches"] > 0, k
        # the bound is held against the device's share where that was
        # measured, else against the wrapper's time
        own = k.get("device_ms", k["ms"])
        apart = ("not timed apart" if "kernel_ms" not in k else
                 f"launch alone {k['kernel_ms']:.4f} ms, device "
                 f"{k['device_ms']:.4f} ms")
        library = ("none" if k["library_ms"] is None
                   else f"{k['library_ms']:.4f} ms")
        print(f"kernel {k['name']}: wrapper {k['ms']:.4f} ms, {apart}, "
              f"bound {k['bound_ms']:.6f} ms by {k['bound_by']} "
              f"({k['bound_ms'] / own:.2%} of {own:.4f} ms), plain "
              f"{k['plain_ms']:.4f} ms, library {library} [{label}]")
    print(f"nvidia-smi name, power.limit: {label}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
