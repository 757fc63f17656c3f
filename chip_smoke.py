#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ohm_tsd_slam_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each of which raises on failure:

1. device: requires torch.cuda; prints the card's name and power limit;
2. build: deletes and recompiles every CUDA kernel of the main paths from
   csrc/ (seven libraries, ICP's pair assignment among them, one nvcc
   process each, all started together, and the conditional nodes' setter
   of utils/compiled.py::when, glue), and prints ptxas's registers and
   stack frame of the push, window replay, candidate sweep, row pack,
   channel compaction and pair assignment kernels (none may have a stack
   frame or spill);
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
   equal) and with no needing beam; the candidate sweep (kernel C) at K =
   1, 3 and 4 on the sliver, on the noise field's full pack, with a count
   of 0, with every beam resolved and on a fence of segments that the
   forward beams cross one and all (more candidates than a beam keeps in
   shared memory); the row pack (kernel B, whose prefix is a look-back
   across blocks) on 2048^2 fields (512 tiles: more than are resident at
   once; one that overflows the pack) and 200 launches on one input, which
   must give the same bits; the channel compaction (kernel E)
   against its twin, bit for bit, on the noise field's layer stack
   (overflow), an empty and a full mask, channels with NaN and Inf, a
   float mask, n = 16384;
4. main paths, each with the launch counts set to 0 before and read after
   (one push launch a push, A and B or E once per grid version, C and D's
   two entry points once each per scan).  The node phases a-d run the
   node's step and extraction eager (eager_step: a replay calls no
   wrapper, so only the eager step passes each launch through the wrappers
   that count it and the hooks that check it); c' holds the compiled step
   against it:
   a. ICP mode: SlamNode with configs/double-laser.yaml's settings (two
      robots sharing the grid, 25 ICP iterations, the fast caster), ~30
      simulated scans per robot through process_scan, then publish_map;
      then the caster's kernels against their twins on the grid it built,
      and kernel E on that grid's layer stack against its twin and against
      the pack of kernels A + B (two routes to one answer); then the ICP
      histories: ICP_RECORD_SCANS of the path's icp calls, with the
      arguments localize_step passed (1081 beams, 25 iterations, float32),
      run again with IcpParams.record_pairs and record_T off and then on
      (on without a host sync): T, rms, pairs, iterations, state and the
      rms and pair histories equal in every bit, to each other and to the
      path's own call, T_history at the last iteration equal to T, each
      iteration's recorded mask summing to its pair count;
   b. general extraction: SlamNode at map_size 6 (64 cells a row, narrower
      than kernels A and B take), ICP mode: kernel E once per grid
      version, A and B never;
   a-c. ICP's pair assignment (csrc/assign_pairs.cu) on every ICP
      iteration of the ICP path and of the TSD, EXP and PDF paths: the
      kernel's idx, dist2, pair_mask and paired equal to its twin
      assign_pairs_plain's in every bit (AssignCheck), one wrapper launch
      an iteration;
   c. TSD mode, the reference's shipped default: SlamNode with
      configs/single-laser.yaml's settings (match_tsd seed, then ICP), 60
      scans, twice from one seed (the pose traces must be equal bit for
      bit), then publish_map; then 10 scans each in the modes EXP and PDF;
   c'. the compiled step (compiled_path): the ICP, map_size 6 and TSD
      paths again on the same scans through SlamNode on localize_step_jit
      and extract_segments_jit (CUDA graphs captured when each localizer
      starts), every call of the step held against the eager step on the
      same inputs in all ten fields, bit for bit (the draws included),
      the pose traces equal to the eager paths' in every bit; then the
      threaded runtime (threaded_path: SlamNode.start(), the double
      laser's two robots fed at 40 Hz, the graphs captured while the other
      threads run): no thread raises, rays_dropped 0, each robot's last
      pose within 2.5 cells of the truth.  Their device launches are
      counted from a trace after the times (compiled_device_launches);
   c''. the overflow guard (overflow_path): the ICP path, 20 scans a
      robot, on the compiled step with raycast_fast.MAX_SEGMENTS forced
      just above the first grid's segments (the first scans fit, the
      growing map overflows): every call equal to the eager step in all
      ten fields and, where it overflowed, to the exact march's step in
      every bit; one graph a robot for both kinds of scan; the node as
      it is reads the card twice a scan, runs no eager step and captures
      nothing; process_scan timed on both kinds of scan;
      raycast_checked_jit and render_ranges_jit (with gradients) on its
      grid against the eager calls and the exact march; the one-card
      multi-robot step over a capacity below its grid's segments;
   c'''. the site (site_path): configs/double-laser.yaml's settings at
      map_size 12 (slambench's double-laser-site: 4096^2 cells, 102.4 m,
      a segment capacity of 16 x MAX_SEGMENTS, the reach cull before
      kernel C), eager: 35 copies of the room over the grid, 34 of them
      mapped by a push from their own start, then the ICP path's first
      10 scans a robot in the middle copy and publish_map; more than
      MAX_SEGMENTS segments, none dropped; every call of A, B, C, D, the
      rounds and E (the cull's compaction) equal to its twin in every
      bit, every push equal to the plain push in every cell; the launch
      counts from this path alone (E, C, D and the rounds once a scan);
      then, from each robot's last pose, the render on the culled pack
      equal to the whole pack's in every bit, and both timed beside the
      cull, E and C alone (site_cull_times);
   d. the same settings in mode GN (30 scans straight ahead; the push is
      its only kernel: no render, no extraction), in mode AMCL (20 scans
      and a 0.35 m / 0.35 m kidnap it must recover from within 3 cells,
      twice from one seed: equal traces) and in ICP mode with the
      odometry rescue (20 scans, odometry through SlamNode.on_odometry,
      one scan 0.35 m off the path that the rescue, and only it, must
      replace); then render_ranges on the ICP path's grid (launches with
      and without a segment cache, the unrefined forward equal to
      raycast_checked's ranges, pose and cell gradients against the CPU
      port within RENDER_TOL), and match_twinpoint and icp_multi_init on
      the TSD path's scene against the CPU port within TWIN_TOL;
   e. the pose batch: raycast_fast_batch at P = 128 poses (bench.py's
      spread) on the ICP path's grid, C, D and D's rounds (a cooperative
      launch at 138,368 beams) launched once each and equal to their
      twins, every pose's rows equal bit for bit to its own raycast_fast,
      and the rounds with 16 replays a round on the batch's state against
      their twin (the same drops, the same beams replayed); the
      multi-robot step (parallel/sharded.py) on configs/double-laser.yaml's
      settings, two robots, 20 ICP steps within 2.5 cells (one C, D and
      rounds launch a step for both robots, the push once a robot), one
      step each in the modes TSD and GN, one step's poses against the CPU
      port within MULTI_TOL and its pose gradient, at one pose, within
      RENDER_TOL; the command line as a subprocess (`python -m
      ohm_tsd_slam_tpu_torch simulate` of configs/single-laser.yaml, then
      `run` on the card): every output file, the printed trajectory error
      within 2.5 cells, grid.npz equal to the text checkpoint of the same
      grid;
   f. the row-sharded step (parallel/: mesh, distributed, shard_raycast,
      shard_matchers, make_sharded_step) in three worlds of rank
      processes on this card (this file with --mesh-rank): one rank on
      NCCL, 2 ranks as (sp, dp) = (2, 1) and 4 as make_mesh's (2, 2) on
      gloo (NCCL refuses two ranks on one card).  Each rank checks its
      push into its row block against the whole grid's push, bit for bit;
      the sharded render of each robot against the one-card caster
      (coordinates within SHARD_COORD_TOL, hits within SHARD_MASK_FLIPS,
      and whether every bit is equal), kernels A, B and C on the 513-row
      block and D on the rank's halo'd block (every round) against their
      twins, max_abs_err 0; 20 ICP steps of make_sharded_step on
      configs/double-laser.yaml's two robots within 2.5 cells, the first
      against one-card multi_robot_slam_step within MULTI_TOL, with
      their launches (A and B once and C and D four times a render, the
      push once a robot a step on every rank); one TSD and one GN step;
      then prints the render's wrapper and device time and device-kernel
      count beside raycast_fast's on the whole grid in the same world,
      the collectives a render and a step with their time, and the
      step's time (against the one-card step's in this run).  Kernels A and B also run on row
      blocks of 257 and 513 rows of the ICP path's grid against their
      twins;
   g. the functions ported last (inventory_path): push_tree along the ICP
      path's poses into a new grid (the push kernel with branch_gate's
      tile gate, one launch a push, each launch checked by PushCheck
      against tile_cull & gate), every grid equal in every bit to the
      ungated kernel's and within compare_push of the plain push with the
      gate; the short-range case of tests/test_inventory.py (map_size 9,
      0.5 m), which must prune tiles; the gated and the ungated launch
      timed on the ICP path's grid; projective_pairs_3d and
      occlusion_filter on a 640 x 480 depth image, trimmed_filter on the
      ICP path's last scan's pairs and surface_points on its grid, each
      equal to the CPU port's in every element;
   h. the compiled entry points (entry_points_path): raycast_checked_jit,
      raycast_jit, push_jit, push_tree_jit, occupancy_grid_jit and
      grid_to_color_image_jit on the ICP path's grid, each call equal to
      the eager call in every bit, captures and their seconds, eager
      against compiled by CUDA events and by the host clock,
      push_tree_jit's call against push_cuda's wrapper (ROADMAP item 21);
      render_ranges_jit's forward and backward graphs against eager
      autograd (ranges, hits and both gradients in every bit) and timed;
      publish_map compiled against eager (the same messages); the memory
      each entry point's graphs hold.  In 4f the world of one NCCL rank
      holds make_sharded_step's compiled step, replay by replay, against
      the eager step in every bit and times both; on gloo the step runs
      eagerly (gloo's collectives run on the host and cannot be
      captured);
5. times: first a check that extract_segments and the push wrapper make
   no host sync and the eager localize_step one in every mode that renders
   (the overflow guard's read of the drop count; none in mode GN), then
   medians and
   quartiles of 25 runs after a warm-up, each printed beside the card's
   name and power limit, and the peak device memory of the caster's stages
   and of each matcher; the modes GN and AMCL, the render's forward and
   backward, TwinPoint and multi-init are timed too, and at the batch's
   shape raycast_fast_batch (wrapper, device, rays a second), C, D and the
   rounds against their twins, and the multi-robot step; ICP's pair
   assignment (wrapper and device time) against its twin on the ICP
   path's last iteration; process_scan and
   localize_step, eager against compiled, on the ICP and TSD paths, with
   the scan period's 25 ms stated as met or not, after a check that the
   compiled step and extraction replay with no host sync, and the device
   memory each node reserves on those paths (its graphs' pools included);
   the device kernels of one replay of each graph beside the eager step's;
   last, the compiled ICP, map_size 6 and TSD paths driven once more under
   torch.profiler, their launch counts set to 0 just before: each
   kernel's device launches read from that trace by kernel name (a
   replay's included), which must equal the eager path's plus each
   localizer's priming replay and each new capture's warm-up; then the
   overflow path and the entry points the same way (new_path_launches).

The line before the last is a JSON object describing each kernel, with its
time beside its bound on this card (the larger of the bytes the function
must move over the HBM rate and its operations over the float32 rate, both
counted by `kernel_bounds` from this run's inputs) and, where one PyTorch
call computes the same function, that call's time.  A row's `ms` is its
wrapper's time; `kernel_ms` is the launch alone on held buffers (for A and
D the wrapper, which holds nothing but its result) and `device_ms` that
launch replayed from a CUDA graph: the device's share without the host's.
The last line is
{"ok": true, "device": {...}} and is printed only when every phase passed.
Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
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
SCANS_GN = 30                # mode GN (one robot)
SCANS_AMCL = 20              # mode AMCL, then the kidnap scan
SCANS_ODOM = 20              # the ICP path with the odometry rescue
ICP_RECORD_SCANS = 20        # ICP-path icp calls rerun with the histories on
N_TIMED = 25
# render gradients, card against the CPU port (float32), as a share of the
# largest magnitude; TwinPoint and multi-init transforms, card against CPU
RENDER_TOL = 1e-3
HIT_FLIPS = 0.005            # share of beams whose hit may differ card/CPU
TWIN_TOL = 1e-4
TWIN_TRIALS = 10             # TwinPoint trials held against the CPU port

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


def trajectory(start, n, turn_deg=0.5):
    """~2 cm and `turn_deg` per scan (tests/test_slam_e2e.py's motion)."""
    x, y, th = start
    out = []
    for _ in range(n):
        out.append((x, y, th))
        x += 0.02 * math.cos(th)
        y += 0.02 * math.sin(th)
        th += math.radians(turn_deg)
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


def time_host(fn, n=N_TIMED, warmup=3) -> list:
    """ms of each of n calls of fn() on the host's clock, between two
    synchronisations of the card, after a warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
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

    buf = cc.empty_pack(mask.device, mask.numel() // cc.ROW, size,
                        len(chans) + 1)
    total = torch.empty(1, dtype=torch.int32, device=mask.device)
    return lambda: cc.launch(mask, chans, buf, total)


# the kernel's largest tsd gap to the plain push (its error before it took
# the cull, 1.28e-5)
PUSH_TOL = 1.3e-5


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
    """Add a KernelCheck's calls and errors (or its `stats` dict) into
    `total`."""
    for name, st in getattr(check, "stats", check).items():
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
    # C once at K=ROUNDS; D on all beams, then its rounds in one call
    mins = [f["finite"] for n, _, f in check.log if n == "segment_min"]
    replays = [f["hits"] for n, _, f in check.log if n == "window_replay"]
    rounds = [f for n, _, f in check.log if n == "window_rounds"]
    out["sliver"] = dict(agreement(res, exact),
                         wall_hits=int((res.mask & (x_hit > 17.0)).sum()),
                         segment_min_finite=mins, window_replay_hits=replays,
                         window_rounds=rounds)
    assert len(mins) == 1 and len(mins[0]) == rf.ROUNDS, out["sliver"]
    assert mins[0][1] > 0 and len(replays) == len(rounds) == 1, out["sliver"]
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
    with eager_step():
        for k in range(2):
            node.process_scan(0, LaserScan(
                ranges=scan_ranges((half, half, 0.0), 30.0),
                angle_min=PHI_MIN, angle_increment=RES, range_max=30.0,
                stamp=float(k)))
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


def blob_field(cells: int, seed: int) -> np.ndarray:
    """A sliver, a wall and scattered 5 x 5 blobs: segments in rows all
    over the layer mask, a few thousand of them."""
    from ohm_tsd_slam_tpu_torch.utils.testing import sliver_field

    rng = np.random.default_rng(seed)
    f = sliver_field(cells, cells // 3, cells // 2)
    for _ in range(40):
        y, x = rng.integers(8, cells - 8, 2)
        f[y - 2:y + 3, x - 2:x + 3] = -0.2
    return f


def sweep_pack_check(dev, total: dict) -> dict:
    """Kernel C at K = 1, 3 and 4 (sliver, the noise field's full pack,
    count 0, every beam resolved, a fence of segments that overflows a
    beam's candidate list) and kernel B beyond the 1024^2 grids of
    the renders (2048^2: 512 tiles; an overflow there; 200 launches on
    one input), each against its twin."""
    from ohm_tsd_slam_tpu_torch.core import se2
    from ohm_tsd_slam_tpu_torch.grid import raycast_fast as rf
    from ohm_tsd_slam_tpu_torch.grid.state import from_arrays
    from ohm_tsd_slam_tpu_torch.ops.kernel_check import KernelCheck
    from ohm_tsd_slam_tpu_torch.utils.testing import (
        fence_segments,
        field_arrays,
        noise_field,
        sliver_field,
    )

    def grid_of(f):
        return from_arrays(field_arrays(f.astype(np.float32), 0.025),
                           device=dev)

    check = KernelCheck()
    geom = geom_1081()
    out = {}
    fields = {"sliver": (sliver_field(CELLS, 600, 700, rows=(472, 552)),
                         (10.0, 12.8, 0.05)),
              "noise_full_pack": (noise_field(CELLS, seed=3),
                                  (12.8, 12.8, 0.0))}
    for name, (f, xyt) in fields.items():
        grid = grid_of(f)
        seg = rf.extract_segments(grid)
        ray, tr, idx_min, idx_max, _ = rf.beam_geometry(
            grid, geom, se2.make(*xyt, device=dev))
        lo = (torch.floor(idx_min) - 1.0).clamp(min=0.0)
        hi = torch.ceil(idx_max) + 1.0
        tr_pack = (tr - seg.origin).contiguous()
        cases = {name: (seg.pack, seg.count, lo)}
        if name == "sliver":
            cases["count_0"] = (seg.pack, torch.zeros_like(seg.count), lo)
            cases["all_resolved"] = (seg.pack, seg.count,
                                     torch.full_like(lo, math.inf))
            # a fence before the sensor: the forward beams cross all 4096
            # segments, more candidates than a beam keeps in shared memory
            p0, p1 = (torch.as_tensor(p, dtype=torch.float32, device=dev)
                      for p in fence_segments(4096, float(tr_pack[0]) + 0.5,
                                              float(tr_pack[1])))
            cases["fence"] = (*rf.pack_segments(p0, p1, torch.ones(
                4096, dtype=torch.bool, device=dev)), lo)
        for case, (pack, count, t_after) in cases.items():
            for levels in (1, rf.ROUNDS - 1, rf.ROUNDS):
                check.kernels.segment_min(pack, count, ray, lo, hi, t_after,
                                          tr_pack, levels, rf.COVER)
            out[f"C {case}"] = {"segments": int(count),
                                "finite": check.log[-1][2]["finite"]}
    assert out["C noise_full_pack"]["segments"] == rf.MAX_SEGMENTS, out
    assert min(out["C sliver"]["finite"][:2]) > 0, out
    assert min(out["C fence"]["finite"]) > 100, out
    assert not any(out["C count_0"]["finite"]), out
    assert not any(out["C all_resolved"]["finite"]), out
    assert check.stats["segment_min"] == {"calls": 15, "max_abs_err": 0.0}

    S = rf.MAX_SEGMENTS
    for name, f in (("2048", blob_field(2 * CELLS, seed=11)),
                    ("2048_overflow", noise_field(2 * CELLS, seed=5))):
        grid = grid_of(f)
        mask, row_cnt = check.kernels.segment_layers(grid)
        packed, count = check.kernels.pack_rows(grid, mask, row_cnt, S)
        wrapper = caster_wrappers()["pack_rows"]
        same = 0
        for _ in range(200):
            again, count2 = wrapper(grid, mask, row_cnt, S)
            same += int(torch.equal(again.view(torch.int32),
                                    packed.view(torch.int32))
                        and torch.equal(count2, count))
        out[f"B {name}"] = {"tiles": row_cnt.numel() // 256,
                            "segments": int(count),
                            "stored": int((packed[4] > 0).sum()),
                            "launches_equal": same}
        assert same == 200, out
    assert 1000 < out["B 2048"]["segments"] <= S, out
    assert out["B 2048_overflow"]["segments"] > S + 128, out
    assert out["B 2048_overflow"]["stored"] == S + 128, out
    assert check.stats["pack_rows"] == {"calls": 2, "max_abs_err": 0.0}
    torch.cuda.synchronize()
    merge_stats(total, check)
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
    assert results["three_poses"]["max_abs_err"] <= PUSH_TOL, results

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


@contextlib.contextmanager
def eager_step():
    """SlamNode's step and extraction eager on the card, for the phases
    whose hooks must see every launch (a replay calls no wrapper):
    slam/node.py's localize_step_jit and extract_segments_jit become
    localize_step and extract_segments, and a localizer that starts primes
    nothing (there is no graph to capture)."""
    from ohm_tsd_slam_tpu_torch.grid import raycast_fast as rf
    from ohm_tsd_slam_tpu_torch.slam import localize
    from ohm_tsd_slam_tpu_torch.slam import node as node_mod

    saved = (node_mod.localize_step_jit, node_mod.extract_segments_jit,
             node_mod.SlamNode._prime_step)
    node_mod.localize_step_jit = localize.localize_step
    node_mod.extract_segments_jit = rf.extract_segments
    node_mod.SlamNode._prime_step = lambda *args: None
    try:
        yield
    finally:
        (node_mod.localize_step_jit, node_mod.extract_segments_jit,
         node_mod.SlamNode._prime_step) = saved


def on_eager_step(fn):
    """fn run inside eager_step()."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with eager_step():
            return fn(*args, **kwargs)
    return run


def drive(node, cfg, gts, scans, ks=None, around=None,
          dropped=None) -> dict:
    """Every robot's scans through node.process_scan, in turns (those of
    the scan indices `ks`, all by default; index 0 starts each
    localizer), `around(call)` wrapped about each after the first where
    given (timing, counting).  Every scan's rays_dropped must be 0, or,
    where the list `dropped` is given, is appended to it.  Returns the
    tracking errors per robot, the localized scans, the grid versions made
    after the first and the pose trace (on the card)."""
    n_robots = len(gts)
    errs = [[] for _ in range(n_robots)]
    trace = []
    n_scans = updates = 0
    ks = range(len(gts[0])) if ks is None else ks
    for k in ks:
        for r in range(n_robots):
            before = node.grid.tsd
            msg = scan_msg(scans[r][k], cfg.robots[r].sensor.max_range,
                           float(k))
            if k == 0:
                assert node.process_scan(r, msg) is None
                updates += node.grid.tsd is not before
                continue
            out = (around or (lambda call: call()))(
                lambda: node.process_scan(r, msg))
            updates += node.grid.tsd is not before
            n_scans += 1
            if dropped is None:
                assert node.localizers[r].rays_dropped == 0, (r, k)
            else:
                dropped.append(node.localizers[r].rays_dropped)
            assert out is not None and not out.is_nan, (r, k)
            trace.append(node.localizers[r].pose)
    poses = torch.stack(trace).cpu()
    assert bool(torch.isfinite(poses).all())
    i = 0
    for k in (k for k in ks if k):
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


@on_eager_step
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
    run.update(gts=gts, scans=scans)
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
    # one launch a push; A and B once per grid version; C and D's two
    # entry points once each per scan (rays_dropped 0 on every scan: no
    # scan fell back to the exact march)
    assert launches["push"] == n_pushes > 2, launches
    assert launches["segment_layers"] == launches["pack_rows"] >= updates
    assert launches["segment_min"] == n_scans, launches
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
    return node, launches, run


def keep_icp_calls(calls: list):
    """Wrap the icp that localize_step calls so that each call's arguments
    and result are kept (references: no copy, no launch, no sync); returns
    the function that puts the original back."""
    from ohm_tsd_slam_tpu_torch.slam import localize

    orig = localize.icp

    def kept(*args, **kwargs):
        res = orig(*args, **kwargs)
        calls.append((args, kwargs, res))
        return res

    localize.icp = kept
    return lambda: setattr(localize, "icp", orig)


def icp_record_check(calls: list, label: str) -> dict:
    """ICP_RECORD_SCANS of the ICP path's icp calls, spread over the path,
    run again on their own arguments with both history flags off, then
    with both on (under set_sync_debug_mode("error")).  Every output the
    two share is equal in every bit, and equal to the path's own call;
    T_history[iterations - 1] is T; each iteration's recorded mask sums to
    its pair count.  Prints the counts checked and both calls' times on
    the path's last call; returns those two calls for icp_kernel_counts."""
    from ohm_tsd_slam_tpu_torch.registration.icp import icp

    fields = ("T", "rms", "pairs", "iterations", "state", "rms_history",
              "pair_history")
    assert len(calls) >= ICP_RECORD_SCANS, len(calls)
    picked = calls[::len(calls) // ICP_RECORD_SCANS][:ICP_RECORD_SCANS]
    out = {"calls": 0, "iterations": 0, "fields_equal": 0}
    for args, kwargs, path_res in picked:
        scene, params = args[2], args[4]
        assert not (params.record_pairs or params.record_T), params
        assert params.iterations == 25 and scene.shape == (BEAMS, 2)
        assert scene.dtype == torch.float32
        on_params = dataclasses.replace(params, record_pairs=True,
                                        record_T=True)
        off = icp(*args, **kwargs)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            on = icp(*args[:4], on_params, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert off.T_history is off.pair_idx_history is None
        assert off.pair_mask_history is None
        for f in fields:
            assert bits_equal(getattr(off, f), getattr(on, f)), f
            assert bits_equal(getattr(off, f), getattr(path_res, f)), f
            out["fields_equal"] += 2
        n = int(on.iterations)
        assert 0 < n <= params.iterations
        assert tuple(on.pair_idx_history.shape) == (25, BEAMS)
        assert tuple(on.pair_mask_history.shape) == (25, BEAMS)
        assert tuple(on.T_history.shape) == (25, 3, 3)
        assert on.pair_idx_history.dtype == torch.int32
        assert bits_equal(on.T_history[n - 1], on.T)
        assert torch.equal(on.pair_mask_history.sum(1), on.pair_history)
        out["calls"] += 1
        out["iterations"] += n
    args, kwargs, _ = calls[-1]
    on_params = dataclasses.replace(args[4], record_pairs=True,
                                    record_T=True)
    fns = {"icp flags off (the ICP path's last call)":
           lambda: icp(*args, **kwargs),
           "icp flags on (the same call)":
           lambda: icp(*args[:4], on_params, **kwargs)}
    t = {name: statistics.median(time_cuda(fn)) for name, fn in fns.items()}
    print(f"icp histories: {out['calls']} of the ICP path's "
          f"{len(calls)} icp calls ({BEAMS} beams, 25 iterations, float32) "
          f"run again flags off and on: {out['fields_equal']} outputs equal "
          f"in every bit (off to on, off to the path's call), "
          f"T_history[iterations - 1] == T and the mask sums equal to "
          f"pair_history on {out['iterations']} iterations, shapes "
          f"[25, {BEAMS}] and [25, 3, 3], no host sync with the flags on; "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items())
          + f" [{label}]")
    return fns


class AssignCheck:
    """Stands in for registration/icp.py's assign_pairs_fused on a path
    (install() puts it there and returns the function that puts the
    original back): runs the kernel (assign_pairs_fused on the card), then
    its plain twin assign_pairs_plain on the same inputs, and asserts the
    four outputs (idx, dist2, pair_mask, paired) equal in every bit.  Counts
    the calls and the pairs checked and keeps the last call's arguments
    (assign_times times the kernel on them)."""

    def __init__(self):
        self.calls = self.pairs = 0
        self.last = None

    def __call__(self, *args, **kwargs):
        from ohm_tsd_slam_tpu_torch.registration import nn

        got = nn.assign_pairs_fused(*args, **kwargs)
        want = nn.assign_pairs_plain(*args, **kwargs)
        for name, a, b in zip(("idx", "dist2", "pair_mask", "paired"), got,
                              want):
            assert bits_equal(a, b), (self.calls, name)
        self.calls += 1
        self.pairs += int(got[2].sum())
        self.last = (args, kwargs)
        return got

    def install(self):
        import importlib

        # (the package's `icp` is the function, not the module)
        icp_mod = importlib.import_module(
            "ohm_tsd_slam_tpu_torch.registration.icp")
        orig = icp_mod.assign_pairs_fused
        icp_mod.assign_pairs_fused = self
        return lambda: setattr(icp_mod, "assign_pairs_fused", orig)


def checked_assignments(path: str, label: str, run, *args) -> dict:
    """run(*args) with AssignCheck standing in for ICP's assignment and
    the icp calls kept: every assignment of the path equal to the twin's
    in every bit, and one wrapper launch an ICP iteration.  Returns run's
    result, the check and the launches."""
    from ohm_tsd_slam_tpu_torch.ops.assign_pairs_cuda import assign_pairs

    check, icp_calls = AssignCheck(), []
    restore_check = check.install()
    restore_icp = keep_icp_calls(icp_calls)
    n0 = assign_pairs.launches
    try:
        out = run(*args)
    finally:
        restore_icp()
        restore_check()
    launches = assign_pairs.launches - n0
    iterations = sum(a[4].iterations for a, _, _ in icp_calls)
    print(f"kernel check assign_pairs, {path}: {check.calls} assignments "
          f"of {len(icp_calls)} icp calls equal to assign_pairs_plain's in "
          f"every bit of idx, dist2, pair_mask and paired ({check.pairs} "
          f"pairs kept); {launches} wrapper launches [{label}]")
    assert icp_calls and launches == check.calls == iterations, \
        (path, launches, check.calls, iterations)
    return {"out": out, "check": check, "launches": launches}


def assign_times(check: AssignCheck, label: str) -> tuple:
    """The assignment kernel against its twin on the last checked call's
    inputs (an ICP iteration of the path: 1081 scene and model points):
    the wrapper and the twin between CUDA events, and each one's device
    work replayed from a CUDA graph.  Returns the times and the facts
    kernel_bounds counts from."""
    from ohm_tsd_slam_tpu_torch.ops.assign_pairs_cuda import assign_pairs
    from ohm_tsd_slam_tpu_torch.registration.nn import assign_pairs_plain

    args, kwargs = check.last
    model, scene, payload = args[0], args[2], args[4]
    assert scene.dtype == torch.float32 and scene.shape == (BEAMS, 2)
    tag = (f"S={scene.shape[0]}, M={model.shape[0]}, K={payload.shape[1]}"
           f", gate {'on' if kwargs.get('thresh2') is not None else 'off'}"
           f", reciprocal {'on' if kwargs.get('use_reciprocal') else 'off'}")
    t = {f"assign_pairs kernel ({tag})":
         time_cuda(lambda: assign_pairs(*args, **kwargs)),
         f"assign_pairs device time ({tag}: replayed from a CUDA graph)":
         time_device(lambda: assign_pairs(*args, **kwargs)),
         f"assign_pairs plain ({tag})":
         time_cuda(lambda: assign_pairs_plain(*args, **kwargs)),
         f"assign_pairs plain device time ({tag}: replayed from a CUDA "
         f"graph)": time_device(lambda: assign_pairs_plain(*args, **kwargs))}
    facts = {"assign_S": scene.shape[0], "assign_M": model.shape[0],
             "assign_K": payload.shape[1]}
    return report_times(t, label), facts


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


@on_eager_step
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
    run.update(gts=gts, scans=scans, launches=launches)
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
    assert launches["segment_min"] == run["n_scans"], launches
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
    return node, run


@on_eager_step
def run_node(dev, label: str, push_check, flat: dict, gts, scans,
             seed: int = 0, name: str = None):
    """One robot's scans through SlamNode.process_scan on the card with
    the settings `flat`, the launch counts set to 0 just before and read
    just after, the mapper pushing through `push_check`.  Returns the node
    (pushing through push_cuda again, as its users run it) and the run."""
    from ohm_tsd_slam_tpu_torch.config import RegMode, from_flat_params
    from ohm_tsd_slam_tpu_torch.slam import SlamNode

    c = from_flat_params(flat)
    node = SlamNode(c, dtype=torch.float32, device=dev, seed=seed)
    kernel_push = node.mapper._push_fn
    node.mapper._push_fn = push_check
    pushes_before = push_check.stats["calls"]
    plain_on_cuda = []
    saved = watch_plain(plain_on_cuda)
    reset_counts()
    t0 = time.perf_counter()
    run = drive(node, c, gts, scans)
    torch.cuda.synchronize()
    run.update(wall=time.perf_counter() - t0, gts=gts, scans=scans)
    run["launches"] = read_counts()
    run["pushes"] = push_check.stats["calls"] - pushes_before
    node.mapper._push_fn = kernel_push
    for mod, attr, orig in saved:
        setattr(mod, attr, orig)
    loc = node.localizers[0]
    assert loc.params.mode == int(flat["registration_mode"])
    assert loc.scan_count == run["n_scans"] == len(gts[0]) - 1
    assert not plain_on_cuda, plain_on_cuda
    limit = 2.5 * c.grid.cellsize
    err = max(run["errs"][0])
    print(f"{name or RegMode(loc.params.mode).name} path: {run['n_scans']} "
          f"localized scans, {run['updates']} grid versions, max |pose - "
          f"truth| = {err:.6f} m, final {run['errs'][0][-1]:.6f} m (limit "
          f"{limit} m), rays_dropped 0 on each; kernel launches "
          f"{json.dumps(run['launches'])}; {run['wall']:.3f} s [{label}]")
    assert err < limit, (flat["registration_mode"], err)
    la = run["launches"]
    assert la["push"] == run["pushes"] >= run["updates"] > 2, la
    assert la["compact_channels"] == 0, la       # a 1024-wide grid
    return node, run


def assert_rendering_launches(run) -> None:
    """A and B once per grid version, C and D's two entry points once per
    scan (rays_dropped 0: no scan re-rendered with the exact march)."""
    la = run["launches"]
    assert la["segment_layers"] == la["pack_rows"] >= run["updates"], la
    assert la["segment_min"] == run["n_scans"], la
    assert la["window_replay"] == la["window_rounds"] == run["n_scans"], la


def ransac_paths(dev, label: str, push_check):
    """The RANSAC pre-registration paths at full width: TSD mode with
    configs/single-laser.yaml's settings (1024^2 cells, 1081 beams, 100
    trials, the yaml's control set), twice from one seed; then EXP and PDF
    from the same start."""
    from ohm_tsd_slam_tpu_torch.config import RegMode, from_flat_params

    cfg = from_flat_params(SINGLE_LASER)
    half = cfg.grid.size_meters * 0.5
    gts = [trajectory((half, half, 0.0), SCANS_TSD)]
    scans = [[scan_ranges(p, 30.0) for p in gts[0]]]

    def run_mode(mode, n, seed=0):
        flat = {**SINGLE_LASER, "registration_mode": int(mode)}
        node, run = run_node(dev, label, push_check, flat, [gts[0][:n]],
                             [scans[0][:n]], seed)
        loc = node.localizers[0]
        assert loc.params.fast_raycast
        assert loc.params.ransac.trials == SINGLE_LASER["trials"]
        assert (loc.params.ransac.size_control_set
                == SINGLE_LASER["sizeControlSet"])
        assert_rendering_launches(run)
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
    return node, run


class StepCheck:
    """Stands in for slam/node.py's localize_step_jit in compiled_path:
    runs the compiled step (a graph replay), then the eager localize_step
    on the same inputs with a generator of the same state, and holds all
    ten fields of the two results, and the generator's state after, in
    every bit."""

    def __init__(self):
        from ohm_tsd_slam_tpu_torch.slam import localize

        self.jit = localize.localize_step_jit
        self.eager = localize.localize_step
        self.calls = self.fields = 0

    def __call__(self, grid, pose, last_pose, data, mask, params,
                 T_prereg=None, generator=None, odom_state=None,
                 segments=None):
        twin = None
        if generator is not None:
            twin = torch.Generator(device=generator.device)
            twin.set_state(generator.get_state())
        got = self.jit(grid, pose, last_pose, data, mask, params, T_prereg,
                       generator, odom_state, segments)
        want = self.eager(grid, pose, last_pose, data, mask, params,
                          T_prereg, twin, odom_state, segments)
        for f in got._fields:
            assert bits_equal(getattr(got, f), getattr(want, f)), \
                (self.calls, f, getattr(got, f), getattr(want, f))
        if twin is not None:
            assert torch.equal(generator.get_state(), twin.get_state())
        self.fields += len(got._fields)
        self.calls += 1
        return got


def compiled_graphs() -> dict:
    """The node's two compiled entry points (utils/compiled.py)."""
    from ohm_tsd_slam_tpu_torch.grid import raycast_fast as rf
    from ohm_tsd_slam_tpu_torch.slam import localize

    return {"localize_step_jit": localize.localize_step_jit.compiled,
            "extract_segments_jit": rf.extract_segments_jit.compiled}


def compiled_path(dev, label: str, push_check, paths) -> dict:
    """The ICP path (double laser, two robots), the general-extraction
    path (map_size 6: kernel E) and the TSD path (single laser) through
    SlamNode on the compiled step (localize_step_jit and
    extract_segments_jit: CUDA graphs, captured when each localizer
    starts), on the scans of their eager runs: `paths` holds (name, flat
    settings, the eager run).  Every call of the step is held against the
    eager step in every bit (StepCheck); the pose traces, hence the
    tracking errors, equal the eager paths' in every bit; rays_dropped is
    0 on every scan; each robot's localizer captures one graph.  Returns
    per path the captures and their seconds, warm-up included (the
    launches the device ran are counted by compiled_device_launches)."""
    from ohm_tsd_slam_tpu_torch.config import from_flat_params
    from ohm_tsd_slam_tpu_torch.slam import SlamNode
    from ohm_tsd_slam_tpu_torch.slam import node as node_mod

    graphs = compiled_graphs()
    out = {}
    for name, flat, ref in paths:
        cfg = from_flat_params(flat)
        node = SlamNode(cfg, dtype=torch.float32, device=dev)
        kernel_push = node.mapper._push_fn
        node.mapper._push_fn = push_check
        check = StepCheck()
        node_mod.localize_step_jit = check
        captures = {k: g.captures for k, g in graphs.items()}
        seconds = {k: len(g.capture_s) for k, g in graphs.items()}
        t0 = time.perf_counter()
        try:
            run = drive(node, cfg, ref["gts"], ref["scans"])
            torch.cuda.synchronize()
        finally:
            node_mod.localize_step_jit = check.jit
            node.mapper._push_fn = kernel_push
        wall = time.perf_counter() - t0
        new = {k: g.captures - captures[k] for k, g in graphs.items()}
        capture_s = {k: g.capture_s[seconds[k]:] for k, g in graphs.items()}
        robots = len(cfg.robots)
        assert bits_equal(run["trace"], ref["trace"]), name
        assert run["errs"] == ref["errs"], name
        assert check.calls == run["n_scans"] + robots, check.calls
        assert new["localize_step_jit"] == robots, new
        errs = ", ".join(f"{max(e):.6f}" for e in run["errs"])
        print(f"compiled path {name}: {run['n_scans']} localized scans, "
              f"{check.calls} calls of localize_step_jit (the priming call "
              f"of each robot included) equal to the eager step in all "
              f"{check.fields} fields, bit for bit; the pose trace equal "
              f"to the eager path's in every bit, max |pose - truth| "
              f"{errs} m, rays_dropped 0 on each; captures "
              f"{json.dumps(new)} in "
              f"{json.dumps({k: [round(t, 3) for t in v] for k, v in capture_s.items()})} s; "
              f"{wall:.3f} s with the checks [{label}]")
        out[name] = {"captures": new, "capture_s": capture_s}
    return out


THREAD_LATE = 4           # robot 1 starts this many scans after robot 0


def threaded_path(dev, label: str, ref: dict) -> dict:
    """The threaded runtime on the compiled step: SlamNode.start() (the
    mapper, the grid publisher and a localizer thread a robot) with the
    double laser's two robots, the ICP path's scans (`ref`, its eager
    run) fed through on_scan every 25 ms, robot 1's starting THREAD_LATE
    scans after robot 0's.  Both graphs' caches are emptied first, so that robot 0's step is
    captured before the threads have work and robot 1's while robot 0's
    thread replays and the mapper pushes.  No thread may raise
    (threading.excepthook); every robot's last scan is localized, with
    rays_dropped 0 and within 2.5 cells of the truth."""
    from ohm_tsd_slam_tpu_torch.config import from_flat_params
    from ohm_tsd_slam_tpu_torch.slam import SlamNode

    cfg = from_flat_params(DOUBLE_LASER)
    gts, scans = ref["gts"], ref["scans"]
    n = len(gts[0])
    graphs = compiled_graphs()
    for g in graphs.values():
        g.clear_cache()
    captures = {k: g.captures for k, g in graphs.items()}
    raised = []
    hook = threading.excepthook
    threading.excepthook = raised.append
    node = SlamNode(cfg, dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    node.start()
    try:
        for k in range(n + THREAD_LATE):
            for r, rc in enumerate(cfg.robots):
                j = k - (THREAD_LATE if r else 0)   # the robot's own scan
                if 0 <= j < n:
                    node.on_scan(r, scan_msg(scans[r][j],
                                             rc.sensor.max_range, float(j)))
            time.sleep(SCAN_PERIOD_MS * 1e-3)
        deadline = time.monotonic() + 60.0
        while not raised and any(
                loc.last_result is None or loc.last_result.stamp != n - 1
                for loc in node.localizers):
            assert time.monotonic() < deadline, "threaded path: no result"
            time.sleep(0.01)
    finally:
        node.stop()
        threading.excepthook = hook
    wall = time.perf_counter() - t0
    assert not raised, [(a.thread.name, repr(a.exc_value)) for a in raised]
    new = {k: g.captures - captures[k] for k, g in graphs.items()}
    assert new["localize_step_jit"] == len(cfg.robots), new
    errs = []
    for loc, gt in zip(node.localizers, gts):
        pose = loc.pose.cpu()
        x, y, _ = gt[-1]
        errs.append(math.hypot(float(pose[0, 2]) - x, float(pose[1, 2]) - y))
        assert loc.rays_dropped == 0, loc.rays_dropped
    assert max(errs) < 2.5 * cfg.grid.cellsize, errs
    print(f"threaded path: SlamNode.start() with {len(cfg.robots)} robots "
          f"on the compiled step, {n} scans each fed every "
          f"{SCAN_PERIOD_MS} ms (robot 1 {THREAD_LATE} scans later), the "
          f"graphs captured while the threads ran: captures "
          f"{json.dumps(new)}, no thread raised, rays_dropped 0, "
          f"|last pose - truth| {', '.join(f'{e:.6f}' for e in errs)} m "
          f"(limit {2.5 * cfg.grid.cellsize} m), {wall:.3f} s [{label}]")
    return {"captures": new, "errs": errs}


# each wrapper's kernel by its name in csrc/*.cu, as a trace shows it
def host_syncs(fn) -> int:
    """The synchronising CUDA operations fn() makes, from the warnings of
    torch.cuda.set_sync_debug_mode("warn")."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchronizing" in str(w.message) for w in caught)


@contextlib.contextmanager
def count_host_reads(reads: list):
    """Inside, every read of a CUDA tensor's values by the host (tolist,
    cpu, item, bool, int, float) appends its method's name to `reads`."""
    names = ("tolist", "cpu", "item", "__bool__", "__int__", "__float__")
    saved = {name: getattr(torch.Tensor, name) for name in names}

    def counted(name, orig):
        def read(self, *args, **kwargs):
            if self.is_cuda:
                reads.append(name)
            return orig(self, *args, **kwargs)
        return read

    for name, orig in saved.items():
        setattr(torch.Tensor, name, counted(name, orig))
    try:
        yield
    finally:
        for name, orig in saved.items():
            setattr(torch.Tensor, name, orig)


KERNEL_SYMBOLS = {"push": "tsd_push_kernel",
                  "segment_layers": "segment_layers_kernel",
                  "pack_rows": "pack_rows_kernel",
                  "segment_min": "segment_min_kernel",
                  "window_replay": "window_replay_kernel",
                  "window_rounds": "window_rounds_kernel",
                  "compact_channels": "compact_kernel"}


TRACE_PAD_S = 0.05           # idle host time at each end of a trace


def traced_launches(fn) -> tuple:
    """fn() under torch.profiler (device activity only): the device
    launches of each kernel of KERNEL_SYMBOLS by name, those inside graph
    replays included, or None where the trace shows no device activity;
    and fn's result."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # the profiler drops device activity that its clock places outside
        # the session's window: keep fn's work away from both edges
        time.sleep(TRACE_PAD_S)
        out = fn()
        torch.cuda.synchronize()
        time.sleep(TRACE_PAD_S)
    patterns = {k: re.compile(rf"(?<!\w){sym}(?!\w)")
                for k, sym in KERNEL_SYMBOLS.items()}
    names: dict = {}
    counts = dict.fromkeys(KERNEL_SYMBOLS, 0)
    on_device = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        on_device += 1
        name = e.name()
        if name not in names:
            names[name] = next((k for k, p in patterns.items()
                                if p.search(name)), None)
        if names[name] is not None:
            counts[names[name]] += 1
    return (counts if on_device else None), out


TRACE_SCANS = 15             # scan indices a profiler session traces


def traced_drive(node, cfg, gts, scans) -> tuple:
    """drive() under traced_launches, TRACE_SCANS scan indices a profiler
    session (a whole compiled TSD path is some 380,000 kernel records);
    the sessions' counts summed, their runs joined."""
    found, runs = {}, []
    n = len(gts[0])
    for k0 in range(0, n, TRACE_SCANS):
        part, run = traced_launches(lambda k0=k0: drive(
            node, cfg, gts, scans, range(k0, min(n, k0 + TRACE_SCANS))))
        runs.append(run)
        if part is None or found is None:
            found = None
        else:
            for k, v in part.items():
                found[k] = found.get(k, 0) + v
    trace = torch.cat([r["trace"] for r in runs])
    return found, {"trace": trace,
                   "n_scans": sum(r["n_scans"] for r in runs)}


def compiled_device_launches(dev, label: str, paths) -> dict:
    """The compiled ICP, map_size 6 and TSD paths (`paths`: name, flat
    settings, the eager run) once more through SlamNode, each with the
    launch counts set to 0 just before and read just after, under
    torch.profiler: each kernel's device launches are read from the trace
    by name, a replay's included.  They must equal the eager path's plus,
    for C, D and the rounds, each localizer's priming replay and each new
    capture's warm-up of the step, and for A, B or E each new capture's
    warm-up of the extraction; the pose trace equals the eager path's.
    The wrappers' own counts (the warm-ups' and captures' calls: a replay
    calls no wrapper) are printed beside.  Run after every time is taken:
    the profiler's hooks stay in the process.  Returns per path the
    trace's counts, or None where the profiler shows no device
    activity."""
    from ohm_tsd_slam_tpu_torch.config import from_flat_params
    from ohm_tsd_slam_tpu_torch.slam import SlamNode

    graphs = compiled_graphs()
    out = {}
    for name, flat, ref in paths:
        cfg = from_flat_params(flat)
        node = SlamNode(cfg, dtype=torch.float32, device=dev)
        captures = {k: g.captures for k, g in graphs.items()}
        reset_counts()
        found, run = traced_drive(node, cfg, ref["gts"], ref["scans"])
        wrappers = read_counts()
        new = {k: g.captures - captures[k] for k, g in graphs.items()}
        assert bits_equal(run["trace"], ref["trace"]), name
        want = dict(ref["launches"])
        for k in ("segment_min", "window_replay", "window_rounds"):
            want[k] += len(cfg.robots) + new["localize_step_jit"]
        for k in ("segment_layers", "pack_rows", "compact_channels"):
            if want[k]:
                want[k] += new["extract_segments_jit"]
        if found is not None:
            assert found == want, (name, found, want)
        print(f"compiled device launches {name}: " + (
            "not measured (the profiler shows no device activity)"
            if found is None else json.dumps(found))
            + f" from the trace; the eager path's {json.dumps(ref['launches'])}"
            f"; new captures {json.dumps(new)}; the wrappers' calls "
            f"{json.dumps(wrappers)} [{label}]")
        out[name] = found
    return out


SCAN_PERIOD_MS = 25.0        # the UTM-30LX's 40 Hz: one robot's budget


def compiled_times(dev, label: str) -> tuple:
    """process_scan and localize_step, the eager step against the
    compiled one, on the ICP and TSD paths (tools/torch_step_times.py's
    timers: the two nodes in turns scan by scan, each process_scan between
    two synchronisations; localize_step by CUDA events and by the host's
    clock on the compiled node's last grid and pose), after a check that
    localize_step_jit and extract_segments_jit replay with no host sync.
    States the scan period's yardstick on the TSD path as met or not.
    Then the device memory each node reserves over each path run alone
    (tools/torch_step_times.py::path_memory: the compiled node's captures,
    their buffers and pools included).  Returns the medians and, for
    device_kernel_counts, one replay of each graph beside the eager step
    on the same inputs."""
    import importlib.util

    from ohm_tsd_slam_tpu_torch.grid import raycast_fast as rf
    from ohm_tsd_slam_tpu_torch.slam.localize import (
        localize_step,
        localize_step_jit,
    )

    spec = importlib.util.spec_from_file_location(
        "torch_step_times", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "tools", "torch_step_times.py"))
    steps = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(steps)
    me = sys.modules[__name__]
    t, fns, first = {}, {}, {}
    for path, flat, n in (("ICP", DOUBLE_LASER, SCANS_PER_ROBOT),
                          ("TSD", SINGLE_LASER, SCANS_TSD)):
        runs = steps.path_times(me, dev, flat, n, (False, True))
        for v, how in ((False, "eager"), (True, "compiled")):
            t[f"process_scan {path} path, {how} step (host clock between "
              f"synchronisations)"] = runs[v]["process_scan"]
            first[f"{path} {how}"] = [round(ms, 4) for ms in runs[v]["first"]]
        node = runs[True]["node"]
        grid, pose, last, data, mask, params, gen, seg = steps.step_inputs(
            me, node)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            localize_step_jit(grid, pose, last, data, mask, params,
                              generator=gen(), segments=seg)
            rf.extract_segments_jit(grid)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        for name, ms in steps.step_times(me, node, N_TIMED, True).items():
            t[f"localize_step {path} path, {name}"] = ms
        args = (grid, pose, last, data, mask, params)
        for name, fn in (("localize_step_jit", localize_step_jit),
                         ("localize_step", localize_step)):
            how = "one replay" if fn is localize_step_jit else "eager"
            fns[f"{name} ({path} path, {how})"] = (
                lambda fn=fn, a=args, g=gen, s=seg: fn(*a, generator=g(),
                                                        segments=s))
        fns[f"extract_segments_jit ({path} path's grid, one replay)"] = (
            lambda g=grid: rf.extract_segments_jit(g))
        del runs, node
    for path, flat, n in (("ICP", DOUBLE_LASER, SCANS_PER_ROBOT),
                          ("TSD", SINGLE_LASER, SCANS_TSD)):
        for v, how in ((False, "eager"), (True, "compiled")):
            mib = steps.path_memory(me, dev, flat, n, v)
            print(f"device memory {path} path, {how} node, run alone (MiB "
                  f"above what the process held before it): "
                  f"{json.dumps(mib)} [{label}]")
    print("sync check: localize_step_jit and extract_segments_jit replayed "
          "with no host sync (set_sync_debug_mode error) on both paths")
    print(f"compiled path: first scan of each robot (initialisation; the "
          f"compiled node primes its step there) ms {json.dumps(first)} "
          f"[{label}]")
    medians = report_times(t, label)
    for path in ("ICP", "TSD"):
        e, c = (medians[f"process_scan {path} path, {how} step (host clock "
                        f"between synchronisations)"]
                for how in ("eager", "compiled"))
        budget = SCAN_PERIOD_MS / (2 if path == "ICP" else 1)
        print(f"compiled path {path}: process_scan median {c:.4f} ms "
              f"compiled against {e:.4f} ms eager in this run; the limit "
              f"{budget} ms a robot is {'met' if c < budget else 'not met'}"
              f" [{label}]")
    return medians, fns


SCANS_OVERFLOW = 20          # the forced-overflow ICP path, scans a robot


def overflow_capacity(dev, cfg, scans) -> int:
    """MAX_SEGMENTS for the overflow phase: the least multiple of 128
    above the segments of the grid the ICP path starts from (robot 0's
    first scan pushed at its start), so that the first scans fit and, as
    the map grows, the later ones overflow (a fixed 1024 would overflow
    from the first scan: that grid has some 1300 segments)."""
    from ohm_tsd_slam_tpu_torch.grid import raycast_fast as rf
    from ohm_tsd_slam_tpu_torch.slam import SlamNode

    with eager_step():
        node = SlamNode(cfg, dtype=torch.float32, device=dev)
        node.process_scan(0, scan_msg(scans[0][0],
                                      cfg.robots[0].sensor.max_range, 0.0))
    return 128 * (int(rf.extract_segments(node.grid).count) // 128 + 1)


class GuardCheck(StepCheck):
    """StepCheck in overflow_path: the compiled step against the eager
    step (its guard branching on the host) in all ten fields; where the
    fast caster overflowed, also against the eager step with the exact
    march on the same draws, in every field but rays_dropped and
    segments_swept (the exact march drops and sweeps nothing)."""

    def __init__(self):
        super().__init__()
        self.over = self.clean = 0

    def __call__(self, grid, pose, last_pose, data, mask, params,
                 T_prereg=None, generator=None, odom_state=None,
                 segments=None):
        twin = None
        if generator is not None:
            twin = torch.Generator(device=generator.device)
            twin.set_state(generator.get_state())
        got = super().__call__(grid, pose, last_pose, data, mask, params,
                               T_prereg, generator, odom_state, segments)
        if int(got.rays_dropped) == 0:
            self.clean += 1
            return got
        exact = self.eager(grid, pose, last_pose, data, mask,
                           dataclasses.replace(params, fast_raycast=False),
                           T_prereg, twin, odom_state, segments)
        # the exact march drops nothing and sweeps no segment
        for f in got._fields:
            if f not in ("rays_dropped", "segments_swept"):
                assert bits_equal(getattr(got, f), getattr(exact, f)), \
                    (self.calls, f)
        assert int(exact.rays_dropped) == int(exact.segments_swept) == 0
        assert int(got.segments_swept) == int(segments.count)
        self.over += 1
        return got


def overflow_path(dev, label: str, ref: dict) -> dict:
    """The ICP path (double laser, two robots, SCANS_OVERFLOW scans a
    robot) on the compiled step with raycast_fast.MAX_SEGMENTS forced
    below the map's segments (overflow_capacity; restored after): the
    first scans fit, the later ones overflow.

    1. Every call of the compiled step is held against the eager step
       (GuardCheck): on the overflowing scans it equals the exact march's
       step in every bit.  One graph serves both kinds of scan: no capture
       after each localizer's priming one.
    2. The node as it is, on the same scans: each process_scan timed on
       the host's clock between synchronisations, the host's reads of the
       card counted (2 a scan: the gate flags with the drop count, then
       the pose), the eager localize_step's calls counted (0: the node
       never runs the eager step; a capture's warm-up would call it too).
    3. raycast_checked_jit and render_ranges_jit (forward and both
       gradients) on that node's grid and poses, against the eager calls
       in every bit, and against the exact march.
    4. The one-card multi-robot step (two robots) over the same capacity:
       every robot rendered with the exact march under the batch's one
       guard, rays_dropped the fast caster's."""
    from ohm_tsd_slam_tpu_torch.config import from_flat_params
    from ohm_tsd_slam_tpu_torch.core import se2
    from ohm_tsd_slam_tpu_torch.grid import raycast_fast as rf
    from ohm_tsd_slam_tpu_torch.grid.raycast import raycast
    from ohm_tsd_slam_tpu_torch.grid.render import (
        render_ranges,
        render_ranges_jit,
    )
    from ohm_tsd_slam_tpu_torch.ops.push_cuda import push_cuda
    from ohm_tsd_slam_tpu_torch.parallel import multi_robot_slam_step
    from ohm_tsd_slam_tpu_torch.slam import SlamNode, localize
    from ohm_tsd_slam_tpu_torch.slam import node as node_mod

    cfg = from_flat_params(DOUBLE_LASER)
    gts = [gt[:SCANS_OVERFLOW] for gt in ref["gts"]]
    scans = [sc[:SCANS_OVERFLOW] for sc in ref["scans"]]
    limit = 2.5 * cfg.grid.cellsize
    cap = overflow_capacity(dev, cfg, scans)
    graph = localize.localize_step_jit.compiled
    saved = rf.MAX_SEGMENTS
    rf.MAX_SEGMENTS = cap
    out = {"max_segments": cap}
    try:
        # 1. every call against the eager step
        node = SlamNode(cfg, dtype=torch.float32, device=dev)
        check = GuardCheck()
        node_mod.localize_step_jit = check
        captures = graph.captures
        dropped = []
        try:
            run = drive(node, cfg, gts, scans, dropped=dropped)
        finally:
            node_mod.localize_step_jit = check.jit
        robots = len(cfg.robots)
        assert graph.captures - captures <= robots, (graph.captures, captures)
        assert check.over > 0 and check.clean > 0, (check.over, check.clean)
        assert check.calls == len(dropped) + robots
        for r, e in enumerate(run["errs"]):
            assert max(e) < limit, (r, max(e))
        out.update(checked_calls=check.calls, over=check.over,
                   clean=check.clean, errs=[max(e) for e in run["errs"]])

        # 2. the node as it is: times, host reads, eager steps, captures
        node = SlamNode(cfg, dtype=torch.float32, device=dev)
        captures = graph.captures
        eager_calls, reads, ms = [], [], []
        step = localize.localize_step

        def counted(*args, **kwargs):
            eager_calls.append(1)
            return step(*args, **kwargs)

        def around(call):
            got = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with count_host_reads(got):
                result = call()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            reads.append(got)
            return result

        localize.localize_step = counted
        timed_dropped = []
        try:
            timed = drive(node, cfg, gts, scans, around=around,
                          dropped=timed_dropped)
        finally:
            localize.localize_step = step
        assert bits_equal(timed["trace"], run["trace"])
        assert timed_dropped == dropped
        assert not eager_calls and graph.captures == captures
        assert all(r == ["tolist", "cpu"] for r in reads), reads
        over_ms = [t for t, d in zip(ms, dropped) if d > 0]
        clean_ms = [t for t, d in zip(ms, dropped) if d == 0]
        assert over_ms and clean_ms, dropped
        out.update(process_scan_over_ms=over_ms,
                   process_scan_clean_ms=clean_ms, eager_calls=0,
                   host_reads_per_scan=2, new_captures=0, dropped=dropped)

        # 3. raycast_checked_jit and render_ranges_jit on its grid, the
        # cache extracted at the same capacity (it overflows)
        loc = node.localizers[0]
        grid, geom = node.grid, loc.geom
        seg = node._segments_for(grid)
        assert int(seg.n_dropped) > 0
        tsd = grid.tsd.clone().requires_grad_(True)
        leaf = dataclasses.replace(grid, tsd=tsd)
        with torch.no_grad():
            leaf_seg = rf.extract_segments(leaf)
        w = torch.linspace(0.5, 1.5, geom.size, device=dev)
        checked = []
        for k in range(1, SCANS_OVERFLOW, 6):
            pose = se2.make(*gts[0][k], device=dev)
            got = rf.raycast_checked_jit(grid, geom, pose, segments=seg)
            want = rf.raycast_checked(grid, geom, pose, segments=seg)
            exact = raycast(grid, geom, pose)
            checked.append(
                results_equal(got, want)
                and results_equal(got._replace(n_dropped=exact.n_dropped),
                                  exact)
                and int(got.n_dropped) > 0)
            grads = []
            for fn in (render_ranges_jit, render_ranges):
                x = torch.tensor(gts[0][k], device=dev, requires_grad=True)
                tsd.grad = None
                r_, hit, res = fn(leaf, geom,
                                  se2.make(x[0], x[1], x[2], device=dev),
                                  segments=leaf_seg)
                (w * r_).sum().backward()
                grads.append((r_.detach(), hit, x.grad, tsd.grad,
                              res.n_dropped))
            checked.append(all(bits_equal(a, b) for a, b in zip(*grads))
                           and int(grads[0][4]) > 0)
        assert all(checked), checked
        out["raycast_checked_jit_and_render_ranges_jit_equal"] = checked

        # 4. the one-card multi-robot step
        _, _, params, mgts, g, p = multi_robot_setup(
            dev, lambda *a, **k: push_cuda(*a, **k))
        # a capacity below this grid's segments (both robots' first scans)
        rf.MAX_SEGMENTS = 128 * ((int(rf.extract_segments(g).count) - 1)
                                 // 128)
        out["max_segments_multi_robot"] = rf.MAX_SEGMENTS
        steps = []
        for k in range(1, 4):
            data, mask = multi_robot_inputs(mgts, k, dev)
            res = multi_robot_slam_step(g, p, data, mask, params, seed=k)
            seg_k = rf.extract_segments(g)
            steps.append({"rays_dropped": int(res.rays_dropped),
                          "extraction_dropped": int(seg_k.n_dropped),
                          "reg_error": res.reg_error.tolist()})
            assert int(res.rays_dropped) >= p.shape[0] * int(
                seg_k.n_dropped) > 0, steps
            assert not bool(res.reg_error.any()), steps
            g, p = res.grid, res.poses
            for r, gt in enumerate(mgts):
                assert math.hypot(float(p[r, 0, 2]) - gt[k][0],
                                  float(p[r, 1, 2]) - gt[k][1]) < limit
        out["multi_robot_steps"] = steps
    finally:
        rf.MAX_SEGMENTS = saved
    med_over = statistics.median(out["process_scan_over_ms"])
    med_clean = statistics.median(out["process_scan_clean_ms"])
    print(f"overflow path (ICP, MAX_SEGMENTS {cap}): {out['checked_calls']}"
          f" calls of localize_step_jit equal to the eager step in all "
          f"ten fields, bit for bit, the {out['over']} that overflowed "
          f"also to the exact march's step in every field but "
          f"rays_dropped and segments_swept ({out['clean']} did not); one "
          f"graph a robot for "
          f"both (no capture after the priming); max |pose - truth| "
          f"{json.dumps([round(e, 6) for e in out['errs']])} m [{label}]")
    print(f"overflow path, the node as it is: process_scan median "
          f"{med_over:.4f} ms on {len(out['process_scan_over_ms'])} "
          f"overflowing scans, {med_clean:.4f} ms on "
          f"{len(out['process_scan_clean_ms'])} that fit (host clock "
          f"between synchronisations); host reads a scan 2 (the gate flags "
          f"with the drop count, the pose); eager localize_step calls 0; "
          f"new captures 0; rays_dropped a scan "
          f"{json.dumps(out['dropped'])} [{label}]")
    print(f"overflow path: raycast_checked_jit and render_ranges_jit "
          f"(ranges, hits, pose and cell gradients) on its grid equal to "
          f"the eager calls and the exact march in every bit "
          f"{checked}; the one-card multi-robot step "
          f"{json.dumps(out['multi_robot_steps'])} [{label}]")
    return out


SITE = {**DOUBLE_LASER, "map_size": 12}    # slambench's double-laser-site
SITE_CELLS = 4096            # 102.4 m a side
SCANS_SITE = 10              # the site path's scans a robot
SITE_ROOMS = (5, 7)          # copies of world()'s room, east and north
SITE_PITCH = (16.0, 14.0)    # m between their centres (2.4 m between walls)


def site_rooms() -> list:
    """The offsets (m) that carry world()'s room onto its copies on the
    site's 4096^2 grid, nearest the grid's centre first: the middle copy,
    where the robots start, takes the offset that carries world()'s
    25.6 m grid's centre onto the site's.  Each room is closed by its
    walls, so a scan taken inside a copy is world()'s scan from the pose
    less the offset."""
    c = (SITE_CELLS - CELLS) * 0.025 * 0.5
    nx, ny = SITE_ROOMS
    out = [(c + SITE_PITCH[0] * (i - nx // 2),
            c + SITE_PITCH[1] * (j - ny // 2))
           for j in range(ny) for i in range(nx)]
    return sorted(out, key=lambda o: math.hypot(o[0] - c, o[1] - c))


class SitePush:
    """`push_check` (PushCheck: the kernel's cull against tile_cull) with
    the plain push (grid/push.py::push) on the same inputs: the two grids
    must be equal in every cell of tsd, weight and the tile flags (NaN
    where the other is NaN).  Stands in for the mapper's push."""

    def __init__(self, push_check):
        self.push_check = push_check
        self.calls = 0
        self.cells = 0

    def __call__(self, grid, geom, pose, data, mask):
        from ohm_tsd_slam_tpu_torch.grid.push import push

        out = self.push_check(grid, geom, pose, data, mask)
        ref = push(grid, geom, pose, data, mask)
        for f in ("tsd", "weight", "tile_init", "tile_initw"):
            a, b = getattr(out, f), getattr(ref, f)
            same = a == b
            if a.is_floating_point():
                same |= torch.isnan(a) & torch.isnan(b)
            bad = int((~same).sum())
            assert bad == 0, (f"the push kernel's {f} differs from the "
                              f"plain push's in {bad} cells", self.calls)
        self.calls += 1
        self.cells += int(torch.isfinite(out.tsd).sum())
        return out


@on_eager_step
def site_path(dev, label: str, push_check, total: dict, ref: dict):
    """The double laser at map_size 12 (slambench's double-laser-site:
    4096^2 cells, 102.4 m, segment capacity 16 x MAX_SEGMENTS, the reach
    cull before kernel C): world()'s room copied over the grid
    (site_rooms), every copy but the middle one mapped first by a push of
    world()'s start scan from its own start, then the ICP path's first
    SCANS_SITE scans a robot (`ref`, carried into the middle copy) through
    SlamNode.process_scan, then publish_map.  Every kernel call is held
    against its plain twin in every bit: the caster's (A, B, C, D, the
    rounds and E, which runs the cull) by KernelCheck standing in for
    grid/raycast_fast.py::cuda_kernels, the push by SitePush.  The launch
    counts are set to 0 before the first push and read after
    publish_map."""
    from ohm_tsd_slam_tpu_torch.config import from_flat_params
    from ohm_tsd_slam_tpu_torch.core import se2
    from ohm_tsd_slam_tpu_torch.grid import raycast_fast as rf
    from ohm_tsd_slam_tpu_torch.ops.kernel_check import KernelCheck
    from ohm_tsd_slam_tpu_torch.sensor.polar2d import standard_mask
    from ohm_tsd_slam_tpu_torch.slam import SlamNode

    cfg = from_flat_params(SITE)
    node = SlamNode(cfg, dtype=torch.float32, device=dev)
    assert node.grid.tsd.shape == (SITE_CELLS, SITE_CELLS)
    assert rf.segment_capacity(node.grid) == 16 * rf.MAX_SEGMENTS
    geom = geom_1081(cfg.robots[0].sensor.max_range)
    assert all(rf.reach_cull_pays(node.grid, geom_1081(rc.sensor.max_range))
               for rc in cfg.robots)
    rooms = site_rooms()
    cx, cy = rooms[0]
    gts = [[(x + cx, y + cy, t) for x, y, t in gt[:SCANS_SITE]]
           for gt in ref["gts"]]
    scans = [s[:SCANS_SITE] for s in ref["scans"]]
    start = ref["gts"][0][0]
    data, mask = standard_mask(geom, torch.as_tensor(
        scans[0][0], dtype=torch.float32, device=dev))

    check = KernelCheck()
    site_push = SitePush(push_check)
    kernel_push = node.mapper._push_fn
    node.mapper._push_fn = site_push
    plain_on_cuda = []
    saved = watch_plain(plain_on_cuda)
    saved_kernels = rf.cuda_kernels
    rf.cuda_kernels = lambda: check.kernels
    try:
        reset_counts()               # counts from the site path only
        t0 = time.perf_counter()
        for dx, dy in rooms[1:]:
            pose = se2.make(start[0] + dx, start[1] + dy, start[2],
                            device=dev)
            node.grid = site_push(node.grid, geom, pose, data, mask)
        seeded = site_push.calls
        run = drive(node, cfg, gts, scans)
        occ, _ = node.publish_map()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
    finally:
        rf.cuda_kernels = saved_kernels
        node.mapper._push_fn = kernel_push
        for mod, attr, orig in saved:
            setattr(mod, attr, orig)
    merge_stats(total, check)
    run["launches"] = launches
    seg = node._segments
    kept = [found["segments"] for name, _, found in check.log
            if name == "compact_channels"]
    limit = 2.5 * cfg.grid.cellsize
    errs = [max(e) for e in run["errs"]]
    print(f"site path (map_size 12, {len(rooms)} rooms, {seeded} seed "
          f"pushes): {site_push.calls - seeded} pushes and {run['updates']}"
          f" grid versions from {run['n_scans']} localized scans, "
          f"{int(seg.count)} segments of a capacity of {seg.pack.shape[1]} "
          f"({int(seg.n_dropped)} dropped), the reach cull keeping "
          f"{min(kept)}-{max(kept)} a scan; max |pose - truth| "
          f"{json.dumps([round(e, 6) for e in errs])} m (limit {limit} m); "
          f"kernel launches {json.dumps(launches)}; every call against its "
          f"twin {json.dumps(check.stats)}, {site_push.calls} pushes "
          f"against the plain push over {site_push.cells} finite cells; "
          f"{wall:.3f} s [{label}]")
    assert max(errs) < limit, errs
    assert int(seg.count) > rf.MAX_SEGMENTS and int(seg.n_dropped) == 0
    assert seg.pack.shape[1] == rf.segment_capacity(node.grid)
    assert 0 < min(kept) and max(kept) < int(seg.count), kept
    # every kernel equal to its twin in every bit
    for name, st in check.stats.items():
        assert st["calls"] > 0 and st["max_abs_err"] == 0.0, (name, st)
    # one launch a push; A and B once per grid version; the cull's E, C
    # and D's two entry points once each per scan
    assert launches["push"] == site_push.calls > seeded, launches
    assert launches["segment_layers"] == launches["pack_rows"] \
        >= run["updates"], launches
    for name in ("compact_channels", "segment_min", "window_replay",
                 "window_rounds"):
        assert launches[name] == run["n_scans"], (name, launches)
    assert not plain_on_cuda, plain_on_cuda
    assert occ.data.shape == (SITE_CELLS, SITE_CELLS)
    return node, run


def site_cull_times(node, label: str) -> dict:
    """On the site path's grid, from each robot's last pose: the render
    on the pack the reach cull keeps against the render on the whole pack
    (equal in every bit), and the device times (time_device) of both, of
    the cull alone, of kernel E alone on the cull's mask and of kernel C
    on either pack, with E's and C's bounds."""
    from ohm_tsd_slam_tpu_torch.core import se2
    from ohm_tsd_slam_tpu_torch.grid import raycast_fast as rf
    from ohm_tsd_slam_tpu_torch.ops.segment_min_cuda import segment_min

    grid = node.grid
    seg = rf.extract_segments(grid)
    size = seg.pack.shape[1]
    out = {}
    for r, loc in enumerate(node.localizers):
        geom, pose = loc.geom, loc.pose
        radius = rf.reach_radius(grid, geom)
        culled = rf.reach_cull(seg, pose, radius)
        whole = rf.raycast_fast(grid, geom, pose, segments=seg)
        cut = rf.raycast_fast(grid, geom, pose, segments=culled)
        for f in whole._fields:
            assert bits_equal(getattr(whole, f), getattr(cut, f)), (r, f)
        tr = se2.translation(pose) - seg.origin
        dx, dy = seg.pack[2] - tr[0], seg.pack[3] - tr[1]
        keep = (seg.pack[5] > 0.0) & (dx * dx + dy * dy <= radius * radius)
        ray, tr_b, idx_min, idx_max, _ = rf.beam_geometry(grid, geom, pose)
        lo = (torch.floor(idx_min) - 1.0).clamp(min=0.0)
        hi = torch.ceil(idx_max) + 1.0
        args = (ray, lo, hi, lo, tr_b - seg.origin)
        n_all, n_kept = int(seg.count), int(culled.count)
        t = {
            "render_whole": time_device(lambda: rf.raycast_fast(
                grid, geom, pose, segments=seg)),
            "render_culled": time_device(lambda: rf.raycast_fast(
                grid, geom, pose,
                segments=rf.reach_cull(seg, pose, radius))),
            "cull": time_device(lambda: rf.reach_cull(seg, pose, radius)),
            "E": time_device(compact_launch(
                keep, [seg.pack[i] for i in range(7)], size)),
            "C_whole": time_device(lambda: segment_min(
                seg.pack, seg.count, *args, levels=rf.ROUNDS,
                cover=rf.COVER)),
            "C_culled": time_device(lambda: segment_min(
                culled.pack, culled.count, *args, levels=rf.ROUNDS,
                cover=rf.COVER))}
        med = {k: statistics.median(v) for k, v in t.items()}
        # E reads the mask and 7 rows of the pack and writes the kept
        # columns' 8 rows; C's level 0 tests every (beam, segment) pair
        e_bound = (size * (1 + 7 * 4) + n_kept * 8 * 4) / HBM_BYTES_PER_S
        c_ops = BEAMS * 20 / F32_FLOP_PER_S
        out[f"robot{r}"] = dict(
            segments=n_all, kept=n_kept, reach_m=radius, ms=med,
            E_roofline_pct=100.0 * e_bound * 1e3 / med["E"],
            C_roofline_pct_whole=100.0 * c_ops * n_all * 1e3
            / med["C_whole"],
            C_roofline_pct_culled=100.0 * c_ops * n_kept * 1e3
            / med["C_culled"])
        print(f"site reach cull robot{r} (reach {radius:.3f} m): kept "
              f"{n_kept} of {n_all} segments; render equal to the whole "
              f"pack's in every bit; device ms (medians of {N_TIMED}): "
              f"render whole pack {med['render_whole']:.4f}, culled "
              f"{med['render_culled']:.4f} (saves "
              f"{med['render_whole'] - med['render_culled']:.4f}); the cull "
              f"alone {med['cull']:.4f}, of which E {med['E']:.4f} "
              f"({out[f'robot{r}']['E_roofline_pct']:.2f}% of its bound by "
              f"bytes); C whole pack {med['C_whole']:.4f} "
              f"({out[f'robot{r}']['C_roofline_pct_whole']:.2f}% of its "
              f"bound), culled {med['C_culled']:.4f} "
              f"({out[f'robot{r}']['C_roofline_pct_culled']:.2f}%) "
              f"[{label}]")
    return out


ENTRY_CALLS = 5              # calls of each compiled entry point checked


def results_equal(a, b) -> bool:
    """Two results (tensors in any structure) equal in every bit."""
    from ohm_tsd_slam_tpu_torch.utils.compiled import flatten

    la, lb = [], []
    return flatten(a, la) == flatten(b, lb) and all(
        bits_equal(x, y) for x, y in zip(la, lb))


def graph_mib(c) -> float:
    """MiB that the caching allocator gives back when `c` (a Compiled)
    drops its graphs: their buffers and pools."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    c.clear_cache()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return (before - torch.cuda.memory_reserved()) / 2**20


def entry_points_path(dev, label: str, node, gts) -> tuple:
    """The compiled entry points of this slice on the ICP path's grid
    (robot 0's laser, ENTRY_CALLS poses of its trajectory):
    raycast_checked_jit (with the node's segment cache), raycast_jit,
    push_jit, push_tree_jit, occupancy_grid_jit and
    grid_to_color_image_jit (each on the grid pushed from that pose), each
    call equal in every bit to the eager call on the same inputs; their
    captures and capture seconds; eager against compiled by CUDA events
    and by the host clock; push_tree_jit's call against push_cuda's
    wrapper (ROADMAP item 21: within 2x); render_ranges_jit's forward and
    backward against eager autograd (ranges, hits, pose and cell
    gradients in every bit; times of each); publish_map with the compiled
    publication against the eager one (messages equal in every bit); last
    the memory each entry point's graphs hold (given back when they are
    dropped).  Returns the medians and, for the traced launches, the
    calls."""
    from ohm_tsd_slam_tpu_torch.core import se2
    from ohm_tsd_slam_tpu_torch.grid import raycast_fast as rf
    from ohm_tsd_slam_tpu_torch.grid.axis_aligned import (
        occupancy_grid,
        occupancy_grid_jit,
    )
    from ohm_tsd_slam_tpu_torch.grid.color import (
        grid_to_color_image,
        grid_to_color_image_jit,
    )
    from ohm_tsd_slam_tpu_torch.grid.push import (
        push_jit,
        push_tree,
        push_tree_jit,
    )
    from ohm_tsd_slam_tpu_torch.grid.raycast import raycast, raycast_jit
    from ohm_tsd_slam_tpu_torch.grid.render import (
        render_ranges,
        render_ranges_jit,
    )
    from ohm_tsd_slam_tpu_torch.ops.push_cuda import push_cuda
    from ohm_tsd_slam_tpu_torch.slam import grid_pub

    loc = node.localizers[0]
    grid, geom = node.grid, loc.geom
    seg = node._segments_for(grid)
    ks = list(range(1, len(gts[0]), max(1, len(gts[0]) // ENTRY_CALLS)))
    xyts = [gts[0][k] for k in ks[:ENTRY_CALLS]]
    poses = [se2.make(*xyt, device=dev) for xyt in xyts]
    scans = [node._preprocess(loc, scan_ranges(xyt, geom.max_range))
             for xyt in xyts]
    grids = [push_cuda(grid, geom, pose, *scan)
             for pose, scan in zip(poses, scans)]
    entries = {
        "raycast_checked_jit": (
            rf.raycast_checked_jit,
            lambda i: rf.raycast_checked_jit(grid, geom, poses[i],
                                             segments=seg),
            lambda i: rf.raycast_checked(grid, geom, poses[i],
                                         segments=seg)),
        "raycast_jit": (
            raycast_jit, lambda i: raycast_jit(grid, geom, poses[i]),
            lambda i: raycast(grid, geom, poses[i])),
        "push_jit": (
            push_jit, lambda i: push_jit(grid, geom, poses[i], *scans[i]),
            lambda i: push_cuda(grid, geom, poses[i], *scans[i])),
        "push_tree_jit": (
            push_tree_jit,
            lambda i: push_tree_jit(grid, geom, poses[i], *scans[i]),
            lambda i: push_tree(grid, geom, poses[i], *scans[i])),
        "occupancy_grid_jit": (
            occupancy_grid_jit, lambda i: occupancy_grid_jit(grids[i]),
            lambda i: occupancy_grid(grids[i])),
        "grid_to_color_image_jit": (
            grid_to_color_image_jit,
            lambda i: grid_to_color_image_jit(grids[i]),
            lambda i: grid_to_color_image(grids[i])),
    }
    t, facts = {}, {}
    for name, (fn, jit, eager) in entries.items():
        c = fn.compiled
        captures = c.captures
        equal = [results_equal(jit(i), eager(i))
                 for i in range(len(poses))]
        assert all(equal), (name, equal)
        facts[name] = {"calls_equal": len(equal),
                       "captures": c.captures - captures,
                       "capture_s": [round(s, 4) for s in c.capture_s]}
        for how, timer in (("CUDA events", time_cuda),
                           ("host clock", time_host)):
            t[f"{name} compiled, {how}"] = timer(lambda: jit(0))
            t[f"{name} eager, {how}"] = timer(lambda: eager(0))
    # ROADMAP item 21's yardstick: push_tree's call within 2x the push
    # wrapper's
    t["push_cuda wrapper, host clock"] = time_host(
        lambda: push_cuda(grid, geom, poses[0], *scans[0]))

    # render_ranges_jit: forward, backward, gradients against eager
    # the cell gradient needs a leaf field; its cache is extracted from it
    # (a cache of another tensor would be stale: the exact march)
    w = torch.linspace(0.5, 1.5, geom.size, device=dev)
    tsd = grid.tsd.clone().requires_grad_(True)
    leaf = dataclasses.replace(grid, tsd=tsd)
    with torch.no_grad():
        leaf_seg = rf.extract_segments(leaf)

    def render(fn, i, backward=True):
        x = torch.tensor(xyts[i], device=dev, requires_grad=True)
        tsd.grad = None
        r_, hit, _ = fn(leaf, geom, se2.make(x[0], x[1], x[2], device=dev),
                        segments=leaf_seg)
        loss = (w * r_).sum()
        if not backward:
            return loss
        loss.backward()
        return r_.detach(), hit, x.grad, tsd.grad

    assert int(render_ranges_jit(leaf, geom, poses[0],
                                 segments=leaf_seg)[2].n_dropped) == 0
    forward, backward = render_ranges_jit.compiled
    counts = (forward.captures, backward.captures)
    equal = [all(bits_equal(a, b) for a, b in zip(
        render(render_ranges_jit, i), render(render_ranges, i)))
        for i in range(len(poses))]
    assert all(equal), equal
    facts["render_ranges_jit"] = {
        "calls_equal": len(equal),
        "captures": [forward.captures - counts[0],
                     backward.captures - counts[1]],
        "capture_s": [[round(s, 4) for s in c.capture_s]
                      for c in (forward, backward)]}

    def backward_ms(fn, n=N_TIMED, warmup=3):
        ms = []
        for j in range(n + warmup):
            loss = render(fn, 0, backward=False)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loss.backward()
            end.record()
            end.synchronize()
            if j >= warmup:
                ms.append(start.elapsed_time(end))
        return ms

    for how, fn in (("compiled", render_ranges_jit), ("eager", render_ranges)):
        t[f"render_ranges_jit forward {how}, CUDA events"] = time_cuda(
            lambda fn=fn: render(fn, 0, backward=False))
        t[f"render_ranges_jit backward {how}, CUDA events"] = backward_ms(fn)

    # publish_map, the compiled publication against the eager one
    compiled_msgs = node.publish_map()
    eager_names = {"occupancy_grid_jit": occupancy_grid,
                   "grid_to_color_image_jit": grid_to_color_image}
    saved = {k: getattr(grid_pub, k) for k in eager_names}
    for k, f in eager_names.items():
        setattr(grid_pub, k, f)
    try:
        eager_msgs = node.publish_map()
        t["publish_map eager, host clock"] = time_host(node.publish_map)
    finally:
        for k, f in saved.items():
            setattr(grid_pub, k, f)
    t["publish_map compiled, host clock"] = time_host(node.publish_map)
    for a, b in zip(compiled_msgs, eager_msgs):
        assert np.array_equal(a.data, b.data), (a, b)

    medians = report_times(t, label)
    for name, f in facts.items():
        print(f"compiled entry point {name}: {f['calls_equal']} calls equal "
              f"to the eager call in every bit; captures {f['captures']} "
              f"here, every capture's seconds {f['capture_s']} [{label}]")
    ratio = (medians["push_tree_jit compiled, host clock"]
             / medians["push_cuda wrapper, host clock"])
    print(f"push_tree_jit call {medians['push_tree_jit compiled, host clock']:.4f}"
          f" ms against push_cuda's wrapper "
          f"{medians['push_cuda wrapper, host clock']:.4f} ms (host clock): "
          f"{ratio:.2f}x, ROADMAP item 21's 2x "
          f"{'met' if ratio <= 2.0 else 'not met'} [{label}]")
    print("publish_map: the messages of the compiled publication equal the "
          "eager one's in every bit")
    memory = {name: graph_mib(fn.compiled)
              for name, (fn, _, _) in entries.items()}
    memory["render_ranges_jit"] = sum(graph_mib(c)
                                      for c in render_ranges_jit.compiled)
    memory["raycast_checked_jit (overflow path's graphs too)"] = memory.pop(
        "raycast_checked_jit")
    print(f"device memory the entry points' graphs held (MiB given back "
          f"when they are dropped): "
          f"{json.dumps({k: round(v, 1) for k, v in memory.items()})} "
          f"[{label}]")
    calls = {"raycast_checked_jit": lambda i: entries[
        "raycast_checked_jit"][1](i),
        "push_jit": entries["push_jit"][1],
        "push_tree_jit": entries["push_tree_jit"][1],
        "render_ranges_jit": lambda i: render(render_ranges_jit, i)}
    return medians, {"facts": facts, "memory": memory, "calls": calls,
                     "n": len(poses), "ratio_push_tree": ratio}


def new_path_launches(dev, label: str, ref: dict, overflow: dict,
                      entry: dict) -> dict:
    """The overflow path's node and the entry points once more, under
    torch.profiler (run after every time is taken: the profiler's hooks
    stay), their launch counts set to 0 just before: each kernel's device
    launches by name.  The overflow path (MAX_SEGMENTS as in
    overflow_path): C, D and the rounds once a call of the step (its scans
    and each localizer's priming replay, the fast caster runs on every
    scan, the exact march inside the conditional node on those that
    overflow) and once more a new capture's warm-up.  The entry points:
    ENTRY_CALLS calls each of raycast_checked_jit (cached segments: C, D
    and the rounds once a call), push_jit and push_tree_jit (the push once
    a call) and render_ranges_jit's forward and backward (C, D and the
    rounds once a forward), plus a warm-up a capture (entry_points_path
    dropped their graphs).  Returns each path's counts, or None where the
    profiler shows no device activity."""
    from ohm_tsd_slam_tpu_torch.config import from_flat_params
    from ohm_tsd_slam_tpu_torch.grid import raycast_fast as rf
    from ohm_tsd_slam_tpu_torch.grid.push import push_jit, push_tree_jit
    from ohm_tsd_slam_tpu_torch.grid.render import render_ranges_jit
    from ohm_tsd_slam_tpu_torch.slam import SlamNode, localize

    cfg = from_flat_params(DOUBLE_LASER)
    gts = [gt[:SCANS_OVERFLOW] for gt in ref["gts"]]
    scans = [sc[:SCANS_OVERFLOW] for sc in ref["scans"]]
    out = {}
    step = localize.localize_step_jit.compiled
    saved = rf.MAX_SEGMENTS
    rf.MAX_SEGMENTS = overflow["max_segments"]
    try:
        node = SlamNode(cfg, dtype=torch.float32, device=dev)
        captures = step.captures
        reset_counts()
        found, run = traced_launches(
            lambda: drive(node, cfg, gts, scans, dropped=[]))
    finally:
        rf.MAX_SEGMENTS = saved
    calls = run["n_scans"] + len(cfg.robots) + step.captures - captures
    if found is not None:
        for k in ("segment_min", "window_replay", "window_rounds"):
            assert found[k] == calls, (k, found, calls)
    out["overflow path"] = found
    n = entry["n"]
    graphs = {"raycast_checked_jit": rf.raycast_checked_jit.compiled,
              "push_jit": push_jit.compiled,
              "push_tree_jit": push_tree_jit.compiled,
              "render_ranges_forward": render_ranges_jit.compiled[0]}
    captures = {k: g.captures for k, g in graphs.items()}
    reset_counts()

    def entries():
        for fn in entry["calls"].values():
            for i in range(n):
                fn(i)

    found, _ = traced_launches(entries)
    new = {k: g.captures - captures[k] for k, g in graphs.items()}
    if found is not None:
        renders = (2 * n + new["raycast_checked_jit"]
                   + new["render_ranges_forward"])
        for k in ("segment_min", "window_replay", "window_rounds"):
            assert found[k] == renders, (k, found, renders)
        assert found["push"] == (2 * n + new["push_jit"]
                                 + new["push_tree_jit"]), found
    out["entry points"] = found
    for name, f in out.items():
        print(f"compiled device launches {name}: " + (
            "not measured (the profiler shows no device activity)"
            if f is None else json.dumps(f)) + f" from the trace [{label}]")
    return out



def gn_path(dev, label: str, push_check):
    """Mode GN at full width: configs/single-laser.yaml's settings with
    registration_mode 4 (GnParams(): 30 iterations).  Gauss-Newton aligns
    the scan to the field and renders no model scan, and the node extracts
    no segments for it: the push is the path's only kernel.  The robot
    drives straight (2 cm a scan): GN's basin is the truncation band (3
    cells, 7.5 cm), and on the other paths' turning trajectory (0.5 deg a
    scan) GN loses track from scan 13 on in both packages
    (tools/gn_trajectory.py)."""
    from ohm_tsd_slam_tpu_torch.config import from_flat_params

    half = from_flat_params(SINGLE_LASER).grid.size_meters * 0.5
    gts = [trajectory((half, half, 0.0), SCANS_GN, turn_deg=0.0)]
    scans = [[scan_ranges(p, 30.0) for p in gts[0]]]
    node, run = run_node(dev, label, push_check,
                         {**SINGLE_LASER, "registration_mode": 4}, gts, scans)
    assert node.localizers[0].params.gn.iterations == 30
    assert node._segments is None
    la = run["launches"]
    for name in ("segment_layers", "pack_rows", "segment_min",
                 "window_replay", "window_rounds", "compact_channels"):
        assert la[name] == 0, la
    return node, run


AMCL = {**SINGLE_LASER, "registration_mode": 5, "amcl_particles": 512,
        "amcl_iterations": 8,
        # tests/test_slam_e2e.py::test_slam_amcl_recovers_kidnap's
        # proposal and gates: a 0.49 m correction must pass the gate
        "amcl_sigma_trans": 0.3, "amcl_sigma_rot": 0.1,
        "reg_trs_max": 1.0, "reg_sin_rot_max": 0.9}
KIDNAP = (0.35, 0.35)


@on_eager_step
def amcl_path(dev, label: str, push_check):
    """Mode AMCL at full width (512 particles, 8 iterations, 140 control
    points), SCANS_AMCL scans, then a scan taken KIDNAP away from the last
    pose while the estimate stays (tests/test_slam_e2e.py:260-290): the
    node must relocalize within 3 cells.  Twice from one seed: the traces
    must be equal bit for bit."""
    from ohm_tsd_slam_tpu_torch.config import from_flat_params

    cfg = from_flat_params(AMCL)
    half = cfg.grid.size_meters * 0.5
    gts = [trajectory((half, half, 0.0), SCANS_AMCL)]
    scans = [[scan_ranges(p, 30.0) for p in gts[0]]]
    x, y, th = gts[0][-1]
    kid = (x + KIDNAP[0], y + KIDNAP[1], th)
    kid_scan = scan_msg(scan_ranges(kid, 30.0), 30.0, float(SCANS_AMCL))
    traces = []
    for _ in range(2):
        node, run = run_node(dev, label, push_check, AMCL, gts, scans, seed=7)
        p = node.localizers[0].params.amcl
        assert (p.particles, p.iterations, p.size_control_set) == (512, 8,
                                                                   140), p
        assert_rendering_launches(run)
        reset_counts()
        out = node.process_scan(0, kid_scan)
        counts = read_counts()
        pose = node.localizers[0].pose.cpu()
        err = math.hypot(float(pose[0, 2]) - kid[0],
                         float(pose[1, 2]) - kid[1])
        print(f"AMCL kidnap of {KIDNAP} m: |pose - truth| = {err:.6f} m "
              f"(limit {3 * cfg.grid.cellsize} m), kernel launches "
              f"{json.dumps(counts)} [{label}]")
        assert out is not None and not out.is_nan
        assert err < 3 * cfg.grid.cellsize, err
        assert counts["segment_min"] == counts["window_replay"] == 1, counts
        traces.append(torch.cat([run["trace"], pose[None]]))
    assert torch.equal(traces[0], traces[1]), \
        "AMCL mode: the same seed gave another pose trace"
    print(f"AMCL path: the same seed gives the same {len(traces[0])}-pose "
          "trace bit for bit, kidnap included")
    return node, run


JUMP_SCAN = 12          # the scan of the odometry path taken off the path


@on_eager_step
def odom_path(dev, label: str, push_check):
    """The ICP path with use_odom_rescue on (configs/single-laser.yaml's
    settings, registration_mode 0), odometry fed through
    SlamNode.on_odometry before every scan (the truth in the start's
    frame, scans 0.1 s apart).  Scan JUMP_SCAN is taken 0.35 m off the
    path (3.5 m/s): the rescue must replace that match, and only that one,
    with the odometry delta, and the node must keep tracking."""
    from ohm_tsd_slam_tpu_torch.config import from_flat_params
    from ohm_tsd_slam_tpu_torch.ops.push_cuda import push_cuda
    from ohm_tsd_slam_tpu_torch.slam import SlamNode, odometry

    flat = {**SINGLE_LASER, "registration_mode": 0, "use_odom_rescue": True}
    cfg = from_flat_params(flat)
    node = SlamNode(cfg, dtype=torch.float32, device=dev)
    half = cfg.grid.size_meters * 0.5
    gt = trajectory((half, half, 0.0), SCANS_ODOM)
    flags = []
    check = odometry.check

    def counted(*args):
        T, rescued = check(*args)
        flags.append(rescued)
        return T, rescued

    odometry.check = counted
    node.mapper._push_fn = push_check
    reset_counts()
    errs = []
    try:
        for k, (x, y, th) in enumerate(gt):
            # odometry: the truth in the frame of the start pose
            dx, dy = x - half, y - half
            node.on_odometry(0, dx, dy, th, stamp=0.1 * k)
            seen = (x + 0.35, y, th) if k == JUMP_SCAN else (x, y, th)
            out = node.process_scan(0, scan_msg(scan_ranges(seen, 30.0),
                                                30.0, 0.1 * k))
            if k:
                assert out is not None and not out.is_nan, k
                pose = node.localizers[0].pose
                errs.append(math.hypot(float(pose[0, 2]) - x,
                                       float(pose[1, 2]) - y))
                if k == JUMP_SCAN:
                    jump_pose = (float(pose[0, 2]), float(pose[1, 2]))
    finally:
        odometry.check = check
        node.mapper._push_fn = push_cuda
    torch.cuda.synchronize()
    launches = read_counts()
    rescued = [k + 1 for k, f in enumerate(flags) if bool(f)]
    limit = 2.5 * cfg.grid.cellsize
    x, y, _ = gt[JUMP_SCAN]
    print(f"odometry rescue path (ICP mode): {len(flags)} scans checked, "
          f"rescued scans {rescued} (the jump at scan {JUMP_SCAN}); pose "
          f"after the jump ({jump_pose[0]:.6f}, {jump_pose[1]:.6f}) m, "
          f"truth ({x:.6f}, {y:.6f}) m; max |pose - truth| = {max(errs):.6f}"
          f" m (limit {limit} m); kernel launches {json.dumps(launches)} "
          f"[{label}]")
    assert node.localizers[0].params.odom is not None
    assert len(flags) == SCANS_ODOM - 1 and rescued == [JUMP_SCAN], rescued
    assert max(errs) < limit, errs
    assert launches["segment_min"] == SCANS_ODOM - 1, launches
    return node


def render_check(node, label: str) -> dict:
    """render_ranges on the ICP path's grid from robot0's pose: forward
    with and without a segment cache (its launches counted), the
    unrefined forward equal to raycast_checked's ranges, and the pose and
    cell gradients of a weighted sum on the card against the CPU port's
    on a copy of the grid (float32 on both; the card adds the cell
    cotangent's four taps a beam in no fixed order and rounds cos and sin
    its own way: RENDER_TOL of the largest magnitude).  A grazing beam can
    hit on one device and miss on the other (the ray directions differ in
    the last bit): at most HIT_FLIPS of the beams may, and the weighted sum
    weighs those beams 0."""
    import dataclasses

    from ohm_tsd_slam_tpu_torch.core import se2
    from ohm_tsd_slam_tpu_torch.grid import raycast_fast as rf
    from ohm_tsd_slam_tpu_torch.grid.render import render_ranges
    from ohm_tsd_slam_tpu_torch.grid.state import from_arrays, to_arrays

    loc = node.localizers[0]
    grid, geom = node.grid, loc.geom
    p = loc.pose.cpu()
    xyt = (float(p[0, 2]), float(p[1, 2]),
           math.atan2(float(p[1, 0]), float(p[0, 0])))
    pose = se2.make(*xyt, device=grid.tsd.device)
    seg = node._segments_for(grid)
    out = {}
    for name, kwargs in (("cached", dict(segments=seg)), ("inline", {})):
        reset_counts()
        ranges, hit, res = render_ranges(grid, geom, pose, **kwargs)
        torch.cuda.synchronize()
        out[f"launches_{name}"] = read_counts()
        la = out[f"launches_{name}"]
        assert la["segment_min"] == la["window_replay"] == 1, la
        assert la["window_rounds"] == 1, la
        assert la["segment_layers"] == la["pack_rows"] == (
            0 if name == "cached" else 1), la
        assert int(res.n_dropped) == 0 and int(hit.sum()) > 500, out
    raw = render_ranges(grid, geom, pose, refine=False, segments=seg)[0]
    assert torch.equal(raw, rf.raycast_checked(grid, geom, pose,
                                               segments=seg).ranges)
    out["hits"] = int(hit.sum())
    out["refine_max_shift_m"] = float((ranges - raw).abs().max())

    w_np = np.random.default_rng(5).normal(size=geom.size).astype(np.float32)
    cpu_grid = from_arrays(to_arrays(grid), device="cpu")
    cpu_hit = render_ranges(cpu_grid, geom, pose.cpu())[1]
    flips = (cpu_hit != hit.cpu()).numpy()
    out["hit_flips"] = int(flips.sum())
    assert out["hit_flips"] <= HIT_FLIPS * geom.size, out
    w_np[flips] = 0.0

    def grads(g, dev_):
        x = torch.tensor(xyt, dtype=torch.float32, device=dev_,
                         requires_grad=True)
        tsd = g.tsd.clone().requires_grad_(True)
        r, _, _ = render_ranges(dataclasses.replace(g, tsd=tsd), geom,
                                se2.make(x[0], x[1], x[2], device=dev_))
        (torch.from_numpy(w_np).to(dev_) * r).sum().backward()
        return x.grad.cpu(), tsd.grad.cpu()

    gp, gc = grads(grid, grid.tsd.device)
    cp, cc = grads(cpu_grid, "cpu")
    out["pose_grad"] = [float(v) for v in gp]
    out["pose_grad_cpu"] = [float(v) for v in cp]
    out["pose_grad_max_abs_err"] = float((gp - cp).abs().max())
    out["cell_grad_max_abs_err"] = float((gc - cc).abs().max())
    out["cell_grad_max_abs"] = float(cc.abs().max())
    out["cells_nonzero"] = int((gc != 0).sum())
    out["cells_nonzero_cpu"] = int((cc != 0).sum())
    out["tolerance"] = RENDER_TOL
    print(f"render check (main grid, 1081 beams): {json.dumps(out)} [{label}]")
    assert out["pose_grad_max_abs_err"] <= RENDER_TOL * float(
        cp.abs().max()), out
    assert out["cell_grad_max_abs_err"] <= RENDER_TOL * out[
        "cell_grad_max_abs"], out
    assert out["cells_nonzero"] > 1000, out
    return out


def twin_multi_check(node, label: str) -> dict:
    """match_twinpoint and icp_multi_init once each on the card, on the
    TSD path's model and scene, with draws given (TwinInject from numpy,
    seed 4), against the CPU port on the same inputs (float32 on both:
    TWIN_TOL on the transforms, the same winner).  The comparison runs
    TWIN_TRIALS of the yaml's trials (the CPU's share of the work); the
    timed call on the card all of them."""
    import dataclasses

    from ohm_tsd_slam_tpu_torch.core import se2
    from ohm_tsd_slam_tpu_torch.grid import raycast_fast as rf
    from ohm_tsd_slam_tpu_torch.registration.multi_init import icp_multi_init
    from ohm_tsd_slam_tpu_torch.registration.twinpoint import (
        TwinInject,
        match_twinpoint,
    )
    from ohm_tsd_slam_tpu_torch.sensor.polar2d import data_to_cartesian

    loc = node.localizers[0]
    grid, geom, pose = node.grid, loc.geom, loc.pose
    p = pose.cpu()
    xyt = (float(p[0, 2]) + 0.03, float(p[1, 2]) - 0.02,
           math.atan2(float(p[1, 0]), float(p[0, 0])) + 0.01)
    data, mask = node._preprocess(loc, scan_ranges(xyt, geom.max_range))
    model = rf.raycast_fast(grid, geom, pose,
                            segments=node._segments_for(grid))
    scene, smask = data_to_cartesian(geom, data, mask)
    rp = loc.params.ransac
    rng = np.random.default_rng(4)
    res_deg = math.degrees(rp.resolution)
    min_d, max_d = max(1, int(3.0 / res_deg)), max(2, int(10.0 / res_deg))
    n_valid = int(model.mask.sum())
    rank1 = rng.integers(0, n_valid - 1 - min_d, rp.trials)
    rank2 = rank1 + min_d + rng.integers(
        0, 1 << 30, rp.trials) % np.maximum(
            np.minimum(n_valid - rank1 - 1, max_d) - min_d, 1)
    ctrl = rng.choice(np.nonzero(smask.cpu().numpy())[0],
                      rp.size_control_set, replace=False)
    arrays = [ctrl, np.ones(len(ctrl), bool), rank1, rank2,
              rank2 < n_valid]
    clouds = (model.coords, model.mask, scene, smask)
    rp_check = dataclasses.replace(rp, trials=TWIN_TRIALS)
    seeds = torch.stack([torch.eye(3, device=pose.device),
                         se2.make(0.05, -0.03, 0.02, device=pose.device),
                         se2.make(1.5, -1.0, 0.8, device=pose.device)])
    out = {}
    results = {}
    for where, dev_ in (("card", pose.device), ("cpu", "cpu")):
        inject = TwinInject(*(torch.from_numpy(np.asarray(a)).to(dev_)
                              for a in arrays[:2]),
                            *(torch.from_numpy(np.asarray(a[:TWIN_TRIALS]))
                              .to(dev_) for a in arrays[2:]))
        c = tuple(t.to(dev_) for t in clouds)
        T = match_twinpoint(None, *c, rp_check, inject=inject)
        mi = icp_multi_init(*c, seeds.to(dev_), loc.params.icp,
                            sensor_pose=pose.to(dev_))
        results[where] = (T.cpu(), mi)
    out["twin_T_max_abs_err"] = float(
        (results["card"][0] - results["cpu"][0]).abs().max())
    out["twin_T"] = results["card"][0].flatten().tolist()
    out["multi_best_seed"] = [int(results[w][1].best_seed)
                              for w in ("card", "cpu")]
    out["multi_pairs"] = [int(results[w][1].pairs) for w in ("card", "cpu")]
    out["multi_T_max_abs_err"] = float(
        (results["card"][1].T.cpu() - results["cpu"][1].T).abs().max())
    out["tolerance"] = TWIN_TOL
    print(f"TwinPoint and multi-init on the card against the CPU port: "
          f"{json.dumps(out)} [{label}]")
    assert out["twin_T_max_abs_err"] <= TWIN_TOL, out
    assert not torch.equal(results["card"][0], torch.eye(3)), out
    assert out["multi_best_seed"][0] == out["multi_best_seed"][1], out
    assert out["multi_T_max_abs_err"] <= TWIN_TOL, out
    inject = TwinInject(*(torch.from_numpy(np.asarray(a)).to(pose.device)
                          for a in arrays))
    return {f"match_twinpoint ({rp.trials} trials, {rp.size_control_set} "
            "control points, draws given)": lambda: match_twinpoint(
                None, *clouds, rp, inject=inject),
            "icp_multi_init (3 seeds)": lambda: icp_multi_init(
                *clouds, seeds, loc.params.icp, sensor_pose=pose)}


def peak_mib(fn) -> tuple:
    """Device memory fn() allocates above what is held, and what is held."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - held) / 2**20, held / 2**20


MARKER = "spin_kernel"       # torch.cuda._sleep's kernel: splits a trace


def device_kernels(*fns) -> list:
    """For each fn, (device kernels and copies launched, their summed
    device time in ms) of one fn(), from one torch.profiler session (its
    set-up costs seconds) after a warm-up call of each: the calls run one
    after another with the card synchronised and a marker kernel
    (torch.cuda._sleep, not counted) between two, so the device events
    split in time order.  None for each where the profiler shows no
    device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i, fn in enumerate(fns):
            if i:
                torch.cuda._sleep(1000)
                torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
    on_device = sorted((e for e in prof.events()
                        if e.device_type == DeviceType.CUDA),
                       key=lambda e: e.time_range.start)
    if not on_device:
        return [None] * len(fns)
    parts = [[]]
    for e in on_device:
        if MARKER in e.name:
            parts.append([])
        else:
            parts[-1].append(e)
    assert len(parts) == len(fns), (len(parts), len(fns))
    return [(len(p), sum(e.device_time for e in p) * 1e-3) for p in parts]


def device_kernel_counts(node, label: str, more: dict) -> None:
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
                segments=seg)), *more.items()):
        (found,) = device_kernels(fn)
        print(f"device kernels {name}: " + (
            "not measured (the profiler shows no device activity)"
            if found is None else
            f"{found[0]} launched, {found[1]:.4f} ms of device time")
            + f" [{label}]")


def icp_kernel_counts(fns: dict, label: str) -> None:
    """Device kernels of icp with the history flags off and on, from one
    profiler session (after device_kernel_counts: the profiler's hooks
    slow every later launch)."""
    found = device_kernels(*fns.values())
    for name, got in zip(fns, found):
        print(f"device kernels {name}: " + (
            "not measured (the profiler shows no device activity)"
            if got is None else
            f"{got[0]} launched, {got[1]:.4f} ms of device time")
            + f" [{label}]")
    if None not in found:
        print(f"icp histories: the flags add {found[1][0] - found[0][0]} "
              f"device kernels and {found[1][1] - found[0][1]:.4f} ms of "
              f"device time a call [{label}]")


@on_eager_step
def stage_times(node, label: str) -> dict:
    """Median times of the main path's stages on the card, the node's
    step eager (compiled_times times the compiled one)."""
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

    # extraction and the push wrapper queue their work without reading
    # anything back: any host sync raises here; the eager localize_step
    # (fast caster + ICP + gates) reads back one value, the guard's drop
    # count (its graph reads nothing: compiled_times)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rf.extract_segments(grid)
        push_cuda(grid, geom, pose, data, mask)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = host_syncs(localize)
    assert syncs == 1, syncs
    print("sync check: extract_segments and push_cuda ran with no host "
          "sync; localize_step (fast caster) with one, the overflow "
          "guard's read of the drop count")

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
    # A's wrapper holds nothing but its two results: its device work is the
    # wrapper replayed from a CUDA graph
    t["A segment_layers device time (replayed from a CUDA graph)"] = \
        time_device(lambda: ks["segment_layers"](grid))
    t["B pack_rows kernel"] = time_cuda(
        lambda: ks["pack_rows"](grid, lmask, rows, S))
    from ohm_tsd_slam_tpu_torch.ops import pack_rows_cuda

    b_buf = pack_rows_cuda.empty_pack(grid.tsd.device, rows.numel(), S)
    b_total = rows.new_empty(1)

    def b_launch():
        pack_rows_cuda.launch(grid, lmask, rows, b_buf, b_total)

    t["B pack_rows launch alone (pack_rows_f32 on held buffers)"] = \
        time_cuda(b_launch)
    t["B pack_rows device time (replayed from a CUDA graph)"] = \
        time_device(b_launch)
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
    from ohm_tsd_slam_tpu_torch.ops import segment_min_cuda

    def c_times(tag, args, levels):
        """Kernel C's wrapper, twin, launch alone and device work at one
        set of arguments."""
        out = torch.empty((ray.shape[0], levels), dtype=torch.float32,
                          device=ray.device)

        def c_launch():
            segment_min_cuda.launch(*args[:7], out, rf.COVER)

        t[f"C segment_min kernel ({tag})"] = time_cuda(
            lambda: ks["segment_min"](*args[:7], levels, rf.COVER))
        t[f"C segment_min plain ({tag})"] = time_cuda(
            lambda: rf.segment_min_plain(*args[:7], levels, rf.COVER))
        t[f"C segment_min launch alone ({tag}: segment_min_f32 on a held "
          "result)"] = time_cuda(c_launch)
        t[f"C segment_min device time ({tag}: replayed from a CUDA "
          "graph)"] = time_device(c_launch)

    # the one sweep a scan of the main path, then the two sweeps it
    # replaced (K=1 for every beam, K=ROUNDS-1 for the unresolved ones)
    c_times(f"K={rf.ROUNDS}, one sweep a scan", cargs, rf.ROUNDS)
    c_times("K=1", cargs, 1)
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

    # the rounds on the candidates of the beams round 1 left unresolved
    # (C at K=ROUNDS-1 from t_after gives the same levels as the later
    # columns of the main path's one sweep), D's rounds entry point once
    S0 = ks["window_replay"](*dargs)
    resolved = (S0[:, 1] > 0.0) | ~has
    S0[:, 1] = resolved.to(S0.dtype)
    t_after = torch.where(resolved, math.inf,
                          torch.maximum(lo, k_1 + rf.COVER))
    c3args = (seg.pack, seg.count, ray, lo, hi, t_after, tr_pack)
    c_times(f"K={rf.ROUNDS - 1} from t_after, the unresolved beams", c3args,
            rf.ROUNDS - 1)
    lev = ks["segment_min"](*c3args, rf.ROUNDS - 1, rf.COVER)
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
    facts.update(rounds_needing=sum(needing), rounds=rf.ROUNDS - 1,
                 sweep_levels=rf.ROUNDS)

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


@on_eager_step
def ransac_times(node, narrow, label: str) -> tuple:
    """Sync checks and times of this slice's stages: the matchers and the
    TSD-mode step on `node` (the TSD path's; process_scan on the eager
    step), the general extraction and kernel E at its main-path shape on
    `narrow` (the map_size 6 node)."""
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
    rp_check = dataclasses.replace(rp, trials=TWIN_TRIALS)
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

    # no ported mode reads the device inside localize_step but for the
    # guard's drop count; the general extraction queues its work like the
    # fused one
    for m in modes:
        syncs = host_syncs(lambda m=m: localize(m))
        assert syncs == 1, (m, syncs)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rf.extract_segments(narrow.grid)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print("sync check: localize_step in the modes TSD, EXP and PDF ran "
          "with one host sync each (the guard's drop count), the general "
          "extract_segments with none")

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


def slice_times(gn, amcl, main, twin_fns: dict, label: str) -> tuple:
    """Sync checks and times of the modes GN and AMCL (on the nodes of
    their paths, from each node's last pose), the render on the ICP
    path's grid and the TwinPoint and multi-init calls.  Returns the
    medians and the two modes' steps (for device_kernel_counts)."""
    import dataclasses

    from ohm_tsd_slam_tpu_torch.core import se2
    from ohm_tsd_slam_tpu_torch.grid.render import render_ranges
    from ohm_tsd_slam_tpu_torch.registration.amcl import match_amcl
    from ohm_tsd_slam_tpu_torch.registration.gauss_newton import (
        match_gauss_newton,
    )
    from ohm_tsd_slam_tpu_torch.sensor.polar2d import data_to_cartesian
    from ohm_tsd_slam_tpu_torch.slam.localize import localize_step

    def step_inputs(node):
        loc = node.localizers[0]
        p = loc.pose.cpu()
        xyt = (float(p[0, 2]) + 0.02, float(p[1, 2]) - 0.01,
               math.atan2(float(p[1, 0]), float(p[0, 0])) + 0.005)
        data, mask = node._preprocess(loc, scan_ranges(xyt, 30.0))
        scene, smask = data_to_cartesian(loc.geom, data, mask)
        return loc, node.grid, loc.pose.contiguous(), data, mask, scene, smask

    gloc, ggrid, gpose, gdata, gmask, gscene, gsmask = step_inputs(gn)
    aloc, agrid, apose, adata, amask, ascene, asmask = step_inputs(amcl)
    aseg = amcl._segments_for(agrid)

    def gn_step():
        return localize_step(ggrid, gpose, gloc.last_pose, gdata, gmask,
                             gloc.params)

    def amcl_step():
        return localize_step(agrid, apose, aloc.last_pose, adata, amask,
                             aloc.params, generator=amcl._draws(0, 1000),
                             segments=aseg)

    # GN renders nothing and reads nothing back; AMCL reads the guard's
    # drop count
    gn_syncs, amcl_syncs = host_syncs(gn_step), host_syncs(amcl_step)
    assert (gn_syncs, amcl_syncs) == (0, 1), (gn_syncs, amcl_syncs)
    print("sync check: localize_step in mode GN ran with no host sync, in "
          "mode AMCL with one (the guard's drop count)")
    for name, fn in (("localize_step (GN)", gn_step),
                     ("localize_step (AMCL)", amcl_step)):
        peak, held = peak_mib(fn)
        print(f"peak device memory {name}: {peak:.1f} MiB above the "
              f"{held:.1f} MiB held [{label}]")

    t = {}
    t["match_gauss_newton (30 iterations, 1081 beams)"] = time_cuda(
        lambda: match_gauss_newton(ggrid, gpose, gscene, gsmask,
                                   gloc.params.gn))
    t["localize_step (GN mode)"] = time_cuda(gn_step)
    t["match_amcl (512 particles, 8 iterations, 140 control points)"] = \
        time_cuda(lambda: match_amcl(amcl._draws(0, 1000), agrid, apose,
                                     ascene, asmask, aloc.params.amcl))
    t["localize_step (AMCL mode, fast caster)"] = time_cuda(amcl_step)
    t["localize_step (ICP mode, the AMCL path's scan)"] = time_cuda(
        lambda: localize_step(
            agrid, apose, aloc.last_pose, adata, amask,
            dataclasses.replace(aloc.params, mode=0), segments=aseg))

    mloc = main.localizers[0]
    mgrid, mgeom = main.grid, mloc.geom
    mpose = mloc.pose.contiguous()
    mseg = main._segments_for(mgrid)
    t["render_ranges forward (cached segments, Newton polish)"] = time_cuda(
        lambda: render_ranges(mgrid, mgeom, mpose, segments=mseg))
    t["render_ranges forward (inline extraction)"] = time_cuda(
        lambda: render_ranges(mgrid, mgeom, mpose))
    w = torch.ones(mgeom.size, device=mpose.device)

    def forward_with_grad():
        x = mpose.clone().requires_grad_(True)
        tsd = mgrid.tsd.clone().requires_grad_(True)
        r, _, _ = render_ranges(dataclasses.replace(mgrid, tsd=tsd), mgeom,
                                x)
        return (w * r).sum()

    # every timed backward gets a forward made before the clock starts
    fresh = iter([forward_with_grad() for _ in range(N_TIMED + 3)])
    t["render_ranges backward (pose and cell gradients)"] = time_cuda(
        lambda: next(fresh).backward())
    for name, fn in twin_fns.items():
        t[name] = time_cuda(fn)
    return report_times(t, label), {"localize_step (GN mode)": gn_step,
                                    "localize_step (AMCL mode)": amcl_step}


# the pose batch of the batch phase: bench.py's spread of 128 poses
N_POSES = 128
POSE_SPREAD = 0.05           # m and rad: d in linspace(-0.05, 0.05)
BATCH_CAP = 16               # the rounds' capacity in the drop-order check
STEPS_MULTI = 20             # multi-robot steps (ICP) on the double laser
MULTI_TOL = 1e-4             # m: one step's poses, card against CPU
# the CLI loop: 240 scans of `simulate` move the robot 8 cm and 1.5 deg a
# scan around a 3.1 m circle; 60 scans move it 32 cm a scan, beyond the
# 0.25 m registration gate of configs/single-laser.yaml (both packages
# lose the loop there: 56 of 60 scans fail)
CLI_STEPS = 240


def pose_batch(pose, n=N_POSES):
    """bench.py's batch (:337-345): `pose` composed with (d, -d, 2d) for
    d in linspace(-POSE_SPREAD, POSE_SPREAD, n)."""
    from ohm_tsd_slam_tpu_torch.core import se2

    return torch.stack([
        pose @ se2.make(d, -d, 2.0 * d, device=pose.device)
        for d in np.linspace(-POSE_SPREAD, POSE_SPREAD, n).tolist()])


def batch_check(node, label: str, total: dict) -> dict:
    """raycast_fast_batch at P = 128 on the ICP path's grid (robot0's last
    pose, cached segments): kernels C, D and D's rounds launched once each
    (the rounds as a cooperative launch: 138,368 beams), each equal to its
    twin, and every pose's rows equal bit for bit to its own raycast_fast;
    then the rounds kernel and its twin with BATCH_CAP replays a round on
    the batch's state, more beams needing a round than that: the same
    drops, and the same beams replayed (every row compared)."""
    from ohm_tsd_slam_tpu_torch.grid import raycast_fast as rf
    from ohm_tsd_slam_tpu_torch.ops.kernel_check import KernelCheck
    from ohm_tsd_slam_tpu_torch.ops.window_replay_cuda import (
        window_rounds_blocks,
    )

    loc = node.localizers[0]
    grid, geom = node.grid, loc.geom
    poses = pose_batch(loc.pose.contiguous())
    seg = node._segments_for(grid)
    check = KernelCheck()
    rounds_args: list = []

    def grab(grid_, S, *rest):
        rounds_args[:] = [grid_, S.clone(), *rest]
        return check.kernels.window_rounds(grid_, S, *rest)

    kernels = check.kernels._replace(window_rounds=grab)
    reset_counts()
    batch = rf.raycast_fast_batch(grid, geom, poses, segments=seg,
                                  kernels=kernels)
    torch.cuda.synchronize()
    launches = read_counts()
    N = poses.shape[0] * geom.size
    out = {"poses": poses.shape[0], "beams": N,
           "rounds_blocks": window_rounds_blocks(N),
           "n_dropped": int(batch.n_dropped),
           "hits": int(batch.mask.sum()), "launches": launches,
           "kernels": {n: check.stats[n] for n in
                       ("segment_min", "window_replay", "window_rounds")}}
    print(f"batch: raycast_fast_batch at P = {out['poses']} ({N} beams): "
          f"{json.dumps(out)} [{label}]")
    assert out["n_dropped"] == 0, out
    assert out["rounds_blocks"] > 1, out          # the cooperative launch
    assert {n: launches[n] for n in ("segment_min", "window_replay",
                                     "window_rounds")} == {
        "segment_min": 1, "window_replay": 1, "window_rounds": 1}, launches
    assert launches["segment_layers"] == launches["pack_rows"] == 0
    for name, st in out["kernels"].items():
        assert st == {"calls": 1, "max_abs_err": 0.0}, (name, st)
    merge_stats(total, check)

    singles_equal = 0
    for p in range(poses.shape[0]):
        single = rf.raycast_fast(grid, geom, poses[p], segments=seg)
        for name in ("coords", "normals", "mask", "ranges"):
            assert torch.equal(getattr(batch, name)[p],
                               getattr(single, name)), (p, name)
        singles_equal += 1
    print(f"batch: each of the {singles_equal} poses' rows equal to its own "
          f"raycast_fast in every bit (coords, normals, mask, ranges)")

    # the drop order: the first BATCH_CAP needing beams in beam order
    check = KernelCheck()
    g_, S, lev, *beams, cap = rounds_args
    check.kernels.window_rounds(g_, S.clone(), lev, *beams, BATCH_CAP)
    torch.cuda.synchronize()
    ((_, _, forced),) = check.log
    out["rounds_forced_overflow"] = dict(forced, cap=BATCH_CAP)
    print(f"batch: rounds kernel with {BATCH_CAP} replays a round on the "
          f"batch's state: {json.dumps(out['rounds_forced_overflow'])}")
    assert forced["dropped"] > 0 and forced["finite"][0] > BATCH_CAP, forced
    assert check.stats["window_rounds"] == {"calls": 1, "max_abs_err": 0.0}
    merge_stats(total, check)
    out["rounds_args"] = rounds_args
    out["cap"] = cap
    return out


def multi_robot_inputs(gts, k, dev):
    """The robots' scans at step k of their trajectories, masked, as
    [R, B] tensors on the card (one geometry: robot0's 30 m laser)."""
    from ohm_tsd_slam_tpu_torch.sensor.polar2d import standard_mask

    geom = geom_1081(30.0)
    pairs = [standard_mask(geom, torch.as_tensor(
        scan_ranges(gt[k], 30.0), dtype=torch.float32, device=dev))
        for gt in gts]
    return (torch.stack([d for d, _ in pairs]),
            torch.stack([m for _, m in pairs]))


def multi_robot_setup(dev, push_check):
    """configs/double-laser.yaml's two robots for the multi-robot step:
    (cfg, geom, params, gts, grid, poses): robot0's 30 m laser for both
    (the step takes one scan geometry, as the JAX package's), ICP with 25
    iterations, STEPS_MULTI + 1 poses of each robot's trajectory, and the
    grid that starts from each robot's first scan pushed at its start
    pose, as the node starts."""
    import dataclasses

    from ohm_tsd_slam_tpu_torch.config import from_flat_params
    from ohm_tsd_slam_tpu_torch.core import se2
    from ohm_tsd_slam_tpu_torch.grid.state import create
    from ohm_tsd_slam_tpu_torch.slam.localize import LocalizeParams

    cfg = from_flat_params(DOUBLE_LASER)
    geom = geom_1081(30.0)
    rc = cfg.robots[0]
    params = dataclasses.replace(
        LocalizeParams.from_config(rc.registration, geom,
                                   cell_size=cfg.grid.cellsize),
        geom=geom)
    assert params.mode == 0 and params.icp.iterations == 25
    half = cfg.grid.size_meters * 0.5
    starts = [(half + r.local_offset_x, half + r.local_offset_y,
               r.local_offset_yaw) for r in cfg.robots]
    gts = [trajectory(s, STEPS_MULTI + 1) for s in starts]
    grid = create(cfg.grid, dtype=torch.float32, device=dev)
    poses = torch.stack([se2.make(*gt[0], device=dev) for gt in gts])
    data, mask = multi_robot_inputs(gts, 0, dev)
    for r in range(len(gts)):
        grid = push_check(grid, geom, poses[r], data[r], mask[r])
    return cfg, geom, params, gts, grid, poses


def multi_robot_path(dev, label: str, push_check):
    """multi_robot_slam_step on configs/double-laser.yaml's settings: two
    robots sharing the 1024^2 grid, ICP (25 iterations), robot0's 30 m
    laser for both (the step takes one scan geometry, as the JAX
    package's), STEPS_MULTI steps along the ICP path's trajectories, the
    launch counts set to 0 before and read after (one C, one D and one
    rounds launch a step for both robots, A and B once, the push once a
    robot); then one step each in the modes TSD and GN, and one ICP step
    on the card against the CPU port in float32.  The grid starts from
    each robot's first scan pushed at its start pose, as the node starts."""
    import dataclasses

    from ohm_tsd_slam_tpu_torch.config import from_flat_params
    from ohm_tsd_slam_tpu_torch.parallel import (
        multi_robot_slam_step,
        pose_gradient,
    )
    from ohm_tsd_slam_tpu_torch.registration.ransac import RansacParams

    cfg, geom, params, gts, grid, poses = multi_robot_setup(dev, push_check)
    grid0, poses0 = grid, poses

    reset_counts()
    t0 = time.perf_counter()
    errs = [[] for _ in gts]
    for k in range(1, STEPS_MULTI + 1):
        data, mask = multi_robot_inputs(gts, k, dev)
        res = multi_robot_slam_step(grid, poses, data, mask, params, seed=k)
        grid, poses = res.grid, res.poses
        assert int(res.rays_dropped) == 0, k
        assert not bool(res.reg_error.any()), (k, res.reg_error)
        p = poses.cpu()
        for r, gt in enumerate(gts):
            errs[r].append(math.hypot(float(p[r, 0, 2]) - gt[k][0],
                                      float(p[r, 1, 2]) - gt[k][1]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    limit = 2.5 * cfg.grid.cellsize
    print(f"multi-robot step (ICP, 2 robots): {STEPS_MULTI} steps, max "
          f"|pose - truth| {max(errs[0]):.6f} / {max(errs[1]):.6f} m (limit "
          f"{limit} m), rays_dropped 0 on each; kernel launches "
          f"{json.dumps(launches)}; {wall:.3f} s [{label}]")
    for r in range(len(gts)):
        assert max(errs[r]) < limit, (r, max(errs[r]))
    assert launches["segment_min"] == launches["window_replay"] == \
        launches["window_rounds"] == STEPS_MULTI, launches
    assert launches["segment_layers"] == launches["pack_rows"] == \
        STEPS_MULTI, launches
    assert launches["push"] == 2 * STEPS_MULTI, launches
    assert launches["compact_channels"] == 0, launches
    out = {"errs": [max(e) for e in errs], "launches": launches,
           "grid": grid, "poses": poses, "params": params, "gts": gts}

    # one step each in the modes TSD and GN from the path's last state
    data, mask = multi_robot_inputs(gts, STEPS_MULTI, dev)
    for mode, name in ((3, "TSD"), (4, "GN")):
        p = dataclasses.replace(
            params, mode=mode,
            ransac=RansacParams.from_config(
                from_flat_params(SINGLE_LASER).robots[0].registration.ransac,
                geom.angular_res))
        reset_counts()
        res = multi_robot_slam_step(grid, poses, data, mask, p, seed=7)
        torch.cuda.synchronize()
        la = read_counts()
        moved = float((res.poses - poses)[:, :2, 2].abs().max())
        print(f"multi-robot step ({name}, 2 robots): reg_error "
              f"{res.reg_error.tolist()}, largest move {moved:.6f} m, pose "
              f"gradients finite: {bool(torch.isfinite(res.pose_grad).all())}"
              f"; kernel launches {json.dumps(la)} [{label}]")
        assert not bool(res.reg_error.any()), (name, res.reg_error)
        assert bool(torch.isfinite(res.poses).all()), name
        assert moved < limit, (name, moved)
        assert la["push"] == 2, la
        rendered = 0 if mode == 4 else 1
        assert la["segment_min"] == la["window_replay"] == \
            la["window_rounds"] == rendered, la

    # one ICP step on the card against the same step of the CPU port
    data, mask = multi_robot_inputs(gts, 1, dev)
    card = multi_robot_slam_step(grid0, poses0, data, mask, params)
    cpu_grid = dataclasses.replace(grid0, **{
        f: getattr(grid0, f).cpu()
        for f in ("tsd", "weight", "tile_init", "tile_initw")})
    cpu = multi_robot_slam_step(cpu_grid, poses0.cpu(), data.cpu(),
                                mask.cpu(), params)
    # the gradients of the step are taken at poses 4e-5 m apart; the
    # gradient itself is held at one pose (the card's), as a share of its
    # largest magnitude, with the render's tolerance
    grad_card = torch.stack([
        pose_gradient(grid0, geom, card.poses[r], data[r], mask[r])
        for r in range(2)]).cpu()
    grad_cpu = torch.stack([
        pose_gradient(cpu_grid, geom, card.poses[r].cpu(), data[r].cpu(),
                      mask[r].cpu()) for r in range(2)])
    gap = {"poses": float((card.poses.cpu() - cpu.poses).abs().max()),
           "step_pose_grad": float(
               ((card.pose_grad.cpu() - cpu.pose_grad).abs()
                / cpu.pose_grad.abs().max()).max()),
           "pose_grad_same_pose": float(
               ((grad_card - grad_cpu).abs() / grad_cpu.abs().max()).max()),
           "tsd_nan_mismatch": int((card.grid.tsd.isnan().cpu()
                                    != cpu.grid.tsd.isnan()).sum())}
    print(f"multi-robot step card against CPU (float32, one ICP step): "
          f"{json.dumps(gap)} (poses within {MULTI_TOL} m, the gradient at "
          f"one pose within {RENDER_TOL} of its largest magnitude) [{label}]")
    assert torch.equal(card.reg_error.cpu(), cpu.reg_error)
    assert gap["poses"] < MULTI_TOL, gap
    assert gap["pose_grad_same_pose"] < RENDER_TOL, gap
    out["card_cpu_gap"] = gap
    return out


# worlds of the mesh path: (backend, ranks, mesh shape; "auto" = make_mesh)
MESH_WORLDS = (("nccl", 1, "auto"), ("gloo", 2, (2, 1)),
               ("gloo", 4, "auto"))
MESH_TIMED = 10              # timed sharded renders and steps a rank
MESH_COMPILED = 5            # NCCL: replays of the step against the eager
MESH_RANK_TIMEOUT = 300      # s: a world's ranks, start to finish
SHARD_COORD_TOL = 1e-4       # m: sharded render against the one-card caster
SHARD_MASK_FLIPS = 0.005     # share of beams whose hit may differ


def start_mesh_worlds(tmp: str) -> list:
    """Start every rank process of MESH_WORLDS at once (this file with
    --mesh-rank, torchrun's environment), each writing into its world's
    folder under `tmp`: they import and set up the card while the paths
    before mesh_path run, and each world joins only when mesh_path lets
    it in (its go file).  A rank whose parent is gone exits.  Returns
    [(name, ranks, folder, processes)] in MESH_WORLDS' order."""
    import socket

    from ohm_tsd_slam_tpu_torch.ops import _build

    # every library exists before the ranks start: they load, never build
    _build.build_all(["push"] + [n for n, _, _ in CASTER if n not in SOURCE])
    started = []
    for backend, n, shape in MESH_WORLDS:
        name = f"{backend}_{n}"
        shape_arg = shape if shape == "auto" else f"{shape[0]}x{shape[1]}"
        out_dir = os.path.join(tmp, name)
        os.makedirs(out_dir)
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        env = dict(os.environ, MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), WORLD_SIZE=str(n),
                   OMP_NUM_THREADS="1")
        procs = []
        for r in range(n):
            with open(os.path.join(out_dir, f"rank{r}.log"), "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--mesh-rank", backend, shape_arg, out_dir],
                    env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                    stdout=log, stderr=subprocess.STDOUT))
        started.append((name, n, out_dir, procs))
    return started


def stop_mesh_worlds(started: list) -> None:
    for _, _, _, procs in started:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _rank_failed(name: str, out_dir: str, r: int, proc) -> None:
    with open(os.path.join(out_dir, f"rank{r}.log")) as f:
        print(f"mesh {name} rank {r} output:\n{f.read()[-6000:]}")
    raise AssertionError((name, r, proc.returncode))


def mesh_path(started: list, label: str, push_check,
              caster_stats: dict) -> dict:
    """The row-sharded step (parallel/) in the worlds start_mesh_worlds
    started, all on this card: world 1 on NCCL, worlds 2 ((2, 1)) and 4
    (make_mesh: (2, 2)) on gloo, which lets ranks share a card.  One world
    at a time is let in (its go file) and runs `mesh_rank` in each rank, so
    no two worlds share the card; a rank that fails fails the run.  The
    ranks' kernel checks (every launch on a row block against its twin)
    and push checks are merged into this run's; returns each world's rank
    results."""
    worlds = {}
    try:
        for name, n, out_dir, procs in started:
            # the world has ended when every rank has written its results;
            # its processes leave the card while the next world runs
            t0 = time.perf_counter()
            open(os.path.join(out_dir, "go"), "w").close()
            paths = [os.path.join(out_dir, f"rank{r}.json") for r in range(n)]
            while not all(map(os.path.exists, paths)):
                for r, proc in enumerate(procs):
                    if proc.poll() not in (None, 0):
                        _rank_failed(name, out_dir, r, proc)
                assert time.perf_counter() - t0 < MESH_RANK_TIMEOUT, name
                time.sleep(0.02)
            wall = time.perf_counter() - t0
            ranks = []
            for path in paths:
                with open(path) as f:
                    ranks.append(json.load(f))
            for res in ranks:
                merge_stats(caster_stats, res["kernel_check"])
                for key, v in res["push_check"].items():
                    if key == "part_weight_max_abs_err":
                        push_check.stats[key] = max(push_check.stats[key], v)
                    else:
                        push_check.stats[key] += v
            print(f"mesh {name} (sp, dp) = {tuple(ranks[0]['shape'])}: "
                  f"{n} rank processes, {wall:.1f} s from the go to the "
                  f"last rank's results [{label}]")
            for res in ranks:
                report_mesh_rank(name, res, label)
            worlds[name] = ranks
        for name, _, out_dir, procs in started:
            for r, proc in enumerate(procs):
                if proc.wait(timeout=MESH_RANK_TIMEOUT) != 0:
                    _rank_failed(name, out_dir, r, proc)
    finally:
        stop_mesh_worlds(started)
    return worlds


def block_check(grid, total: dict) -> dict:
    """Kernels A and B on row blocks of `grid` of the heights a row block
    with its halo row has at 1024 rows (257 at sp = 4, 513 at sp = 2), at
    three offsets, against their twins (ops/kernel_check.py): heights
    that are no multiple of any tile."""
    import dataclasses

    from ohm_tsd_slam_tpu_torch.grid import raycast_fast as rf
    from ohm_tsd_slam_tpu_torch.ops.kernel_check import KernelCheck

    out = {}
    for y0, rows in ((0, 257), (384, 257), (511, 513)):
        check = KernelCheck()
        block = dataclasses.replace(
            grid, tsd=grid.tsd[y0:y0 + rows].contiguous())
        _, _, valid, dropped = rf.extract_endpoints(block, 8192,
                                                    check.kernels)
        torch.cuda.synchronize()
        merge_stats(total, check)
        out[f"rows {y0}-{y0 + rows}"] = {
            "segments": int(valid.sum()), "dropped": int(dropped),
            **{k: check.stats[k] for k in ("segment_layers", "pack_rows")}}
        assert check.stats["pack_rows"]["calls"] == 1, check.stats
    return out


def report_mesh_rank(name: str, res: dict, label: str) -> None:
    """Print one rank's checks and times (mesh_rank's results)."""
    tag = f"mesh {name} rank {res['rank']}"
    print(f"{tag}: seconds since the rank's start at the end of each "
          f"phase {json.dumps(res['phase_s'])}")
    print(f"{tag}: push into rows {res['push_rows_bits']['rows']} against "
          f"the whole grid's: {json.dumps(res['push_rows_bits'])}; against "
          f"the plain push into the block (tsd within {PUSH_TOL}): "
          f"{json.dumps(res['push_rows_plain'])}")
    for r, rr in enumerate(res["render"]):
        print(f"{tag}: sharded render robot{r} against the one-card caster: "
              f"{json.dumps(rr)} (coordinates within {SHARD_COORD_TOL} m, "
              f"at most {SHARD_MASK_FLIPS:.1%} of the beams' hits flipped)")
    print(f"{tag}: kernel check on the row block: "
          f"{json.dumps(res['kernel_check'])}")
    print(f"{tag}: {STEPS_MULTI} ICP steps, max |pose - truth| "
          f"{json.dumps(res['errs'])} m, first step against the one-card "
          f"step {res['first_step_gap']:.3e} m (within {MULTI_TOL}); kernel "
          f"launches {json.dumps(res['launches'])}; TSD and GN steps "
          f"{json.dumps(res['modes'])}")
    def device(found):
        return ("not measured (the profiler shows no device activity)"
                if found is None else
                f"{found[0]} device kernels and copies for "
                f"{found[1]:.4f} ms")

    def spread(ms):
        return (f"median {statistics.median(ms):.4f} ms (quartiles "
                f"{np.percentile(ms, 25):.4f} / {np.percentile(ms, 75):.4f})")

    print(f"{tag}: sharded render wrapper {spread(res['render_ms'])}, "
          f"device {device(res['render_device'])}; raycast_fast on the "
          f"whole grid in this world, extraction inline "
          f"{spread(res['one_card_ms'])}, device "
          f"{device(res['one_card_device'])}; with cached segments "
          f"{spread(res['one_card_cached_ms'])}, device "
          f"{device(res['one_card_cached_device'])} [{label}]")
    if res["compiled"]:
        print(f"{tag}: make_sharded_step's step compiled (NCCL): "
              f"{len(res['compiled_equal'])} replays equal to the eager "
              f"step in every bit {res['compiled_equal']}, captures "
              f"{res['compiled_captures']} in "
              f"{[round(t, 3) for t in res['compiled_capture_s']]} s, device "
              f"launches of one replay "
              f"{json.dumps(res['compiled_replay_launches'])}; step "
              f"compiled {spread(res['step_ms'])} against eager "
              f"{spread(res['step_eager_ms'])} by CUDA events, host clock "
              f"{spread(res['step_host_ms'])} against "
              f"{spread(res['step_eager_host_ms'])} [{label}]")
    else:
        print(f"{tag}: make_sharded_step's step runs eagerly on gloo (its "
              f"collectives run on the host and cannot be captured; the "
              f"tensors stay on the card): step {spread(res['step_ms'])} by "
              f"CUDA events [{label}]")
    print(f"{tag}: collectives a render {res['render'][0]['collectives']} "
          f"({res['render'][0]['collective_bytes']} B), "
          f"{res['render_collective_ms']:.4f} ms with the card synchronised "
          f"around each; step (CUDA events, the push unchecked, as the "
          f"one-card step's) {spread(res['step_ms'])}, collectives a step "
          f"{res['step_collectives']:.1f} ({res['step_collective_bytes']:.0f}"
          f" B), {res['step_collective_ms']:.4f} ms synchronised [{label}]")


def mesh_rank(backend: str, shape_arg: str, out_dir: str) -> int:
    """One rank of a mesh_path world: joins it
    (parallel/distributed.py::initialize), builds the mesh, and on
    configs/double-laser.yaml's two robots at the real size checks:
    the push into its row block equal in every bit to the same rows of
    the whole grid's push, and within phase 3's limits of the plain push
    into the block; the sharded render of each robot's pose
    against the one-card caster (coordinates within SHARD_COORD_TOL m
    where both hit, at most SHARD_MASK_FLIPS of the beams' hits
    different), kernels A, B and C on the row block and D on the halo'd
    block held against their twins at every launch (ops/kernel_check.py,
    max_abs_err 0); STEPS_MULTI ICP steps of make_sharded_step within 2.5
    cells, the first step's poses within MULTI_TOL of one-card
    multi_robot_slam_step, and the launches of the steps (A and B once
    and C and D ROUNDS times a render, the push once a robot a step on
    every rank); one TSD and one GN step without a registration error.
    Then times: the sharded render's wrapper (host clock), its
    collectives, the step's time between CUDA events with the push
    unchecked (as multi_robot_path's step is timed) and its collectives,
    raycast_fast on the whole grid (gathered) at the same pose, with the
    extraction inline and cached; then the device kernels of the render
    and of both raycast_fast calls (torch.profiler, one session).  Writes
    rank<r>.json."""
    import dataclasses

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from ohm_tsd_slam_tpu_torch.config import from_flat_params
    from ohm_tsd_slam_tpu_torch.core import se2
    from ohm_tsd_slam_tpu_torch.grid import raycast_fast as rf
    from ohm_tsd_slam_tpu_torch.grid.push import push
    from ohm_tsd_slam_tpu_torch.ops.kernel_check import (
        KernelCheck,
        PushCheck,
        bit_mismatch,
    )
    from ohm_tsd_slam_tpu_torch.parallel import (
        distributed,
        grid_sharding,
        make_mesh,
        make_sharded_step,
        multi_robot_slam_step,
        robot_sharding,
        sharded,
    )
    from ohm_tsd_slam_tpu_torch.parallel.mesh import (
        CollectiveCount,
        all_gather,
        axis_size,
        shard_rows,
    )
    from ohm_tsd_slam_tpu_torch.parallel.shard_raycast import (
        sharded_raycast,
    )
    from ohm_tsd_slam_tpu_torch.registration.ransac import RansacParams

    torch.set_num_threads(1)
    dev = distributed.local_device()
    torch.cuda.init()
    go = os.path.join(out_dir, "go")
    parent = os.getppid()
    while not os.path.exists(go):       # the paths before this world run
        assert os.getppid() == parent, "the run that started this rank ended"
        time.sleep(0.02)
    t_rank = time.perf_counter()
    phases = {}

    def phase(name):
        phases[name] = round(time.perf_counter() - t_rank, 3)

    assert distributed.initialize(backend=backend), "no world to join"
    rank, world = dist.get_rank(), dist.get_world_size()
    if shape_arg == "auto":
        mesh = make_mesh(dev.type)
    else:
        sp, dp = (int(x) for x in shape_arg.split("x"))
        mesh = DeviceMesh(dev.type, torch.arange(world).reshape(sp, dp),
                          mesh_dim_names=("sp", "dp"))
    shape = (axis_size(mesh, "sp"), axis_size(mesh, "dp"))
    out = {"rank": rank, "world": world, "backend": backend,
           "shape": shape, "device": str(dev)}
    phase("joined")
    push_check = PushCheck()
    cfg, geom, params, gts, grid0, poses0 = multi_robot_setup(dev,
                                                              push_check)
    R = poses0.shape[0]
    limit = 2.5 * cfg.grid.cellsize

    # the push into the row block against the whole grid's push
    shard0 = grid_sharding(mesh, grid0)
    y0, h, H = shard_rows(mesh, shard0)
    ty0 = y0 // shard0.tile_dim
    data1, mask1 = multi_robot_inputs(gts, 1, dev)
    pose1 = se2.make(*gts[0][1], device=dev)
    whole = push_check(grid0, geom, pose1, data1[0], mask1[0])
    mine = push_check(shard0, geom, pose1, data1[0], mask1[0], ty0=ty0)
    torch.cuda.synchronize()
    tiles = slice(ty0, ty0 + shard0.tiles_y)
    out["push_rows_bits"] = {
        "tsd": bit_mismatch(mine.tsd, whole.tsd[y0:y0 + h]),
        "weight": bit_mismatch(mine.weight, whole.weight[y0:y0 + h]),
        "tile_initw": bit_mismatch(mine.tile_initw, whole.tile_initw[tiles]),
        "tile_init_equal": bool(torch.equal(mine.tile_init,
                                            whole.tile_init[tiles])),
        "rows": [y0, y0 + h], "touched": int(mine.tile_init.sum())}
    assert not any(out["push_rows_bits"][k] for k in
                   ("tsd", "weight", "tile_initw")), out["push_rows_bits"]
    assert out["push_rows_bits"]["tile_init_equal"], out["push_rows_bits"]
    # and against the plain push into the same block (phase 3's limits)
    out["push_rows_plain"] = compare_push(
        push(shard0, geom, pose1, data1[0], mask1[0], ty0=ty0), mine)
    assert out["push_rows_plain"]["max_abs_err"] <= PUSH_TOL, out

    # the sharded render of each robot against the one-card caster
    check = KernelCheck()
    renders = []
    for r in range(R):
        pose = se2.make(*gts[r][1], device=dev)
        with CollectiveCount() as clock:
            got = sharded_raycast(mesh, shard0, geom, pose,
                                  kernels=check.kernels)
        ref = rf.raycast_fast(grid0, geom, pose)
        both = got.mask & ref.mask
        gap = (got.coords - ref.coords).abs()[both]
        renders.append({
            "hits": int(got.mask.sum()), "one_card_hits": int(ref.mask.sum()),
            "mask_flips": int((got.mask != ref.mask).sum()),
            "max_coord_gap": float(gap.max()) if gap.numel() else 0.0,
            "bit_equal_one_card": all(
                bit_mismatch(getattr(got, f), getattr(ref, f)) == 0.0
                for f in ("coords", "normals", "ranges"))
            and bool(torch.equal(got.mask, ref.mask)),
            "n_dropped": int(got.n_dropped), "collectives": clock.calls,
            "collective_bytes": clock.bytes})
    out["render"] = renders
    phase("push and render checks")
    out["kernel_check"] = check.stats
    for r in renders:
        assert r["n_dropped"] == 0 and r["hits"] > BEAMS // 2, r
        assert r["mask_flips"] <= SHARD_MASK_FLIPS * BEAMS, r
        assert r["max_coord_gap"] <= SHARD_COORD_TOL, r
    for name in ("segment_layers", "pack_rows", "segment_min",
                 "window_replay"):
        assert check.stats[name]["calls"] > 0, check.stats
        assert check.stats[name]["max_abs_err"] == 0.0, check.stats

    # STEPS_MULTI ICP steps, the launches counted; the first against the
    # one-card step
    ref1 = multi_robot_slam_step(grid0, poses0, data1, mask1, params)
    best_push = sharded.best_push
    sharded.best_push = lambda grid: push_check
    step, place = make_sharded_step(mesh, params)
    # the checked steps run eagerly (their launches pass the wrappers that
    # count them and the checks that hold them); the step as
    # make_sharded_step returns it, a graph on NCCL, is held against them
    # after
    eager = functools.partial(multi_robot_slam_step, params=params,
                              mesh=mesh)
    g, p, _, _ = place(grid0, poses0, data1, mask1)
    errs = [[] for _ in range(R)]
    reset_counts()
    with CollectiveCount() as clock:
        for k in range(1, STEPS_MULTI + 1):
            data, mask = multi_robot_inputs(gts, k, dev)
            res = eager(g, p, robot_sharding(mesh, data),
                        robot_sharding(mesh, mask), seed=k)
            assert int(res.rays_dropped) == 0, k
            assert not bool(res.reg_error.any()), (k, res.reg_error)
            if k == 1:
                out["first_step_gap"] = float(
                    (res.poses - ref1.poses)[:, :2, 2].abs().max())
            g, p = res.grid, robot_sharding(mesh, res.poses)
            poses = res.poses.cpu()
            for r, gt in enumerate(gts):
                errs[r].append(math.hypot(float(poses[r, 0, 2]) - gt[k][0],
                                          float(poses[r, 1, 2]) - gt[k][1]))
    out["launches"] = read_counts()
    out["errs"] = [max(e) for e in errs]
    out["step_collectives"] = clock.calls / STEPS_MULTI
    out["step_collective_bytes"] = clock.bytes / STEPS_MULTI
    assert max(out["errs"]) < limit, out["errs"]
    assert out["first_step_gap"] < MULTI_TOL, out["first_step_gap"]
    renders_per_rank = STEPS_MULTI * R // shape[1]
    la = out["launches"]
    assert la["segment_layers"] == la["pack_rows"] == renders_per_rank, la
    assert la["segment_min"] == rf.ROUNDS * renders_per_rank, la
    assert la["window_replay"] == rf.ROUNDS * renders_per_rank, la
    assert la["push"] == R * STEPS_MULTI, la
    assert la["window_rounds"] == 0, la
    assert la["compact_channels"] == 0, la

    phase("ICP steps")
    # one step each in the modes TSD and GN from the last state
    data, mask = multi_robot_inputs(gts, STEPS_MULTI, dev)
    d, m = robot_sharding(mesh, data), robot_sharding(mesh, mask)
    out["modes"] = {}
    for mode, name in ((3, "TSD"), (4, "GN")):
        mparams = dataclasses.replace(
            params, mode=mode,
            ransac=RansacParams.from_config(
                from_flat_params(SINGLE_LASER).robots[0].registration.ransac,
                geom.angular_res))
        mstep, _ = make_sharded_step(mesh, mparams)
        with CollectiveCount() as clock:
            res = multi_robot_slam_step(g, p, d, m, mparams, seed=7,
                                        mesh=mesh)
        moved = float((robot_sharding(mesh, res.poses) - p)[:, :2, 2]
                      .abs().max())
        out["modes"][name] = {"reg_error": res.reg_error.tolist(),
                              "moved": moved, "collectives": clock.calls}
        if mstep.compiled is not None:
            # the step's graph on NCCL (the push kernel unchecked inside
            # it: the check reads the card), against the eager step
            sharded.best_push = best_push
            try:
                got = mstep(g, p, d, m, seed=7)
            finally:
                sharded.best_push = lambda grid: push_check
            out["modes"][name]["compiled_equal"] = step_results_equal(
                got, res)
            assert out["modes"][name]["compiled_equal"], name
        assert not bool(res.reg_error.any()), (name, res.reg_error)
        assert bool(torch.isfinite(res.poses).all()), name
        assert moved < limit, (name, moved)

    phase("TSD and GN steps")
    sharded.best_push = best_push       # the timed steps run unchecked
    # the step as make_sharded_step returns it: a graph on NCCL, each
    # replay against the eager step in every bit; eager on gloo
    out["compiled"] = step.compiled is not None
    if step.compiled is not None:
        gc_, pc, _, _ = place(grid0, poses0, data1, mask1)
        equal = []
        for k in range(1, MESH_COMPILED + 1):
            data, mask = multi_robot_inputs(gts, k, dev)
            dk, mk = robot_sharding(mesh, data), robot_sharding(mesh, mask)
            got = step(gc_, pc, dk, mk, seed=k)
            equal.append(step_results_equal(got, eager(gc_, pc, dk, mk,
                                                       seed=k)))
            gc_, pc = got.grid, robot_sharding(mesh, got.poses)
        out["compiled_equal"] = equal
        out["compiled_captures"] = step.compiled.captures
        out["compiled_capture_s"] = step.compiled.capture_s
        assert all(equal) and step.compiled.captures == 1, out
    phase("compiled steps")
    # times: the render (host clock between synchronisations), its
    # collectives and the step's, then the render's device kernels
    pose = se2.make(*gts[0][STEPS_MULTI], device=dev)
    shard = g

    def render():
        return sharded_raycast(mesh, shard, geom, pose)

    render()
    wrapper = []
    for _ in range(MESH_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render()
        torch.cuda.synchronize()
        wrapper.append((time.perf_counter() - t0) * 1e3)
    with CollectiveCount(timed=True) as clock:
        render()
    out["render_ms"] = wrapper
    out["render_collective_ms"] = clock.ms
    # the step as multi_robot_path's is timed: CUDA events around it, the
    # push unchecked, from one state
    out["step_ms"] = time_cuda(
        lambda: step(g, p, d, m, seed=STEPS_MULTI + 1), n=MESH_TIMED,
        warmup=1)
    if step.compiled is not None:
        # the compiled step against the eager one, by both clocks
        out["step_eager_ms"] = time_cuda(
            lambda: eager(g, p, d, m, seed=STEPS_MULTI + 1), n=MESH_TIMED,
            warmup=1)
        for key, fn in (("step_host_ms", step), ("step_eager_host_ms",
                                                 eager)):
            out[key] = time_host(
                lambda fn=fn: fn(g, p, d, m, seed=STEPS_MULTI + 1),
                n=MESH_TIMED, warmup=1)
    with CollectiveCount(timed=True) as clock:
        eager(g, p, d, m, seed=STEPS_MULTI + 1)
    out["step_collective_ms"] = clock.ms
    # the one-card caster on the same (whole) grid state and pose in this
    # world: extraction inline (the sharded render's work) and cached
    W = shard.tsd.shape[1]
    whole = dataclasses.replace(grid0, tsd=all_gather(
        shard.tsd, mesh, "sp").reshape(-1, W))
    seg = rf.extract_segments(whole)

    def one_card():
        return rf.raycast_fast(whole, geom, pose)

    def one_card_cached():
        return rf.raycast_fast(whole, geom, pose, segments=seg)

    for key, fn in (("one_card_ms", one_card),
                    ("one_card_cached_ms", one_card_cached)):
        fn()
        wall = []
        for _ in range(MESH_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        out[key] = wall
    phase("timed")
    found = device_kernels(render, one_card, one_card_cached)
    if step.compiled is not None:
        # a replay's device launches by kernel name (after the times: the
        # profiler's hooks stay)
        out["compiled_replay_launches"] = traced_launches(
            lambda: step(gc_, pc, dk, mk, seed=0))[0]
    phase("profiled")
    out["render_device"], out["one_card_device"], \
        out["one_card_cached_device"] = (
            None if f is None else list(f) for f in found)
    out["push_check"] = push_check.stats
    out["phase_s"] = phases
    dist.barrier()
    # written whole, then renamed: mesh_path reads it once it exists
    path = os.path.join(out_dir, f"rank{rank}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(out, f)
    os.replace(path + ".tmp", path)
    dist.destroy_process_group()
    return 0


def cli_path(label: str) -> dict:
    """The command line as its users start it: `python -m
    ohm_tsd_slam_tpu_torch simulate` of configs/single-laser.yaml at 1081
    beams, then `run` on the card, each a subprocess in a temporary
    folder.  Every output file exists, the printed trajectory error is
    within 2.5 cells, and grid.npz holds the grid the run ended with: it
    equals, value for value, the reference-format text checkpoint written
    from the same grid (--store-text)."""
    import re
    import tempfile

    from ohm_tsd_slam_tpu_torch.grid.checkpoint import load_npz, load_text

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = os.path.join(root, "configs", "single-laser.yaml")
    with tempfile.TemporaryDirectory() as tmp:
        scans = os.path.join(tmp, "scans.npz")
        out_dir = os.path.join(tmp, "out")
        cmds = [["simulate", "--config", cfg, "--beams", str(BEAMS),
                 "--steps", str(CLI_STEPS), "--out", scans],
                ["run", scans, "--config", cfg, "--out", out_dir,
                 "--store-text"]]
        printed = []
        t0 = time.perf_counter()
        for args in cmds:
            proc = subprocess.run(
                [sys.executable, "-m", "ohm_tsd_slam_tpu_torch", *args],
                cwd=root, capture_output=True, text=True, timeout=600)
            print(f"cli {args[0]}: rc {proc.returncode}\n{proc.stdout}"
                  + (proc.stderr[-2000:] if proc.returncode else ""))
            assert proc.returncode == 0, (args[0], proc.stderr[-2000:])
            printed.append(proc.stdout)
        wall = time.perf_counter() - t0
        names = ("trajectory.csv", "map.pgm", "map_color.ppm", "grid.npz",
                 "grid_store.txt")
        for name in names:
            assert os.path.exists(os.path.join(out_dir, name)), name
        err = re.search(r"trajectory error vs ground truth: mean (\S+) m, "
                        r"max (\S+) m", printed[1])
        median = re.search(r"process_scan on (\S+): median (\S+) ms",
                           printed[1])
        g = load_npz(os.path.join(out_dir, "grid.npz"), device="cpu")
        t = load_text(os.path.join(out_dir, "grid_store.txt"),
                      device="cpu")
        rows = open(os.path.join(out_dir, "trajectory.csv")).read()
    limit = 2.5 * 0.025
    out = {"scans": CLI_STEPS, "mean_err": float(err.group(1)),
           "max_err": float(err.group(2)), "device": median.group(1),
           "per_scan_median_ms": float(median.group(2)),
           "trajectory_rows": rows.count("\n") - 1, "seconds": wall}
    print(f"cli: {json.dumps(out)} (limit {limit} m) [{label}]")
    assert out["device"].startswith("cuda"), out
    assert out["max_err"] < limit, out
    assert out["trajectory_rows"] == CLI_STEPS - 1, out
    for f in ("tsd", "weight", "tile_init"):
        a, b = getattr(g, f), getattr(t, f)
        assert torch.equal(a.isnan(), b.isnan()) if a.is_floating_point() \
            else True, f
        assert torch.equal(a.nan_to_num(), b.nan_to_num()), f
    # the text stores a tile's emptiness weight only while it has no cells,
    # and its reader clamps it at the maximum weight (TsdGrid.cpp:84-85)
    empty = ~g.tile_init
    assert torch.equal(g.tile_initw[empty].clamp(max=t.max_weight),
                       t.tile_initw[empty])
    assert int(g.tile_init.sum()) > 100
    return out


PROJ_W, PROJ_H = 640, 480    # the projective phase's depth image
PROJ_F = 525.0               # its pinhole's focal length, pixels
TRIM_PERCENT = 80.0


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal in every bit (NaN payloads and signed zeros included)."""
    a, b = a.contiguous().cpu(), b.contiguous().cpu()
    return a.shape == b.shape and a.dtype == b.dtype and \
        a.numpy().tobytes() == b.numpy().tobytes()


def step_results_equal(a, b) -> bool:
    """Two SlamStepResults equal in every bit."""
    return all(bits_equal(getattr(a.grid, f), getattr(b.grid, f))
               for f in ("tsd", "weight", "tile_init", "tile_initw")) and all(
        bits_equal(getattr(a, f), getattr(b, f))
        for f in ("poses", "reg_error", "pose_grad", "rms", "rays_dropped"))


def depth_cloud(seed: int):
    """A synthetic PROJ_W x PROJ_H depth image (a slanted wall with a
    bump, noise and pixels without a return) back-projected through the
    pinhole [[f, 0, w/2, 0], [0, f, h/2, 0], [0, 0, 1, 0]]: [h·w, 3]
    float32 points (z = 0 where there is no return) and that P."""
    width, height, f = PROJ_W, PROJ_H, PROJ_F
    rng = np.random.default_rng(seed)
    v, u = np.mgrid[0:height, 0:width].astype(np.float64)
    z = 2.0 + 0.002 * u + 0.3 * np.exp(-((u - width / 3) ** 2
                                         + (v - height / 2) ** 2) / 3000.0)
    z = z + rng.normal(0.0, 0.002, z.shape)
    z[rng.random(z.shape) < 0.05] = 0.0
    pts = np.stack([(u - width / 2) * z / f, (v - height / 2) * z / f, z],
                   -1).reshape(-1, 3)
    P = np.array([[f, 0.0, width / 2, 0.0], [0.0, f, height / 2, 0.0],
                  [0.0, 0.0, 1.0, 0.0]])
    return pts.astype(np.float32), P.astype(np.float32)


def inventory_path(node, label: str, push_check) -> dict:
    """The functions ported last, on the card at full size.

    push_tree: the ICP path's pose sequence (both robots, the double
    laser's settings, 1024^2 cells, 1081 beams) through push_tree into a
    new grid, its launches counted, every gated launch checked by
    `push_check` (the kernel's cull against tile_cull & gate); then each
    pushed grid against push_cuda without a gate from the grid before it
    (every bit) and against the plain push with the gate (compare_push).
    The short-range case of tests/test_inventory.py (map_size 9, 0.5 m,
    the pose at the centre) must prune tiles and still equal the ungated
    push.  A seeded random gate (60% open) closes tiles that the scan
    touches, on a new grid, on the ICP path's grid and on a row block of
    it (ty0): closed tiles must be copied through and open ones equal the
    ungated launch in every bit, the tsd within PUSH_TOL of the gated
    plain push.  The gated and the ungated launch are timed on the ICP
    path's grid and in the pruning case.  projective_pairs_3d and occlusion_filter on a 640 x 480 depth
    image, trimmed_filter on the ICP path's last scan's pairs and
    surface_points on its grid: each equal to the CPU port's on the same
    inputs in every element."""
    from ohm_tsd_slam_tpu_torch.config import GridConfig, from_flat_params
    from ohm_tsd_slam_tpu_torch.core import se2
    from ohm_tsd_slam_tpu_torch.grid import dispatch, push_tree
    from ohm_tsd_slam_tpu_torch.grid import raycast_fast as rf
    from ohm_tsd_slam_tpu_torch.grid.axis_aligned import surface_points
    from ohm_tsd_slam_tpu_torch.grid.push import branch_gate, push
    from ohm_tsd_slam_tpu_torch.grid.state import (
        create,
        from_arrays,
        to_arrays,
    )
    from ohm_tsd_slam_tpu_torch.ops.push_cuda import (
        empty_like,
        launch,
        push_cuda,
    )
    from ohm_tsd_slam_tpu_torch.registration.filters import (
        occlusion_filter,
        trimmed_filter,
    )
    from ohm_tsd_slam_tpu_torch.registration.icp import icp
    from ohm_tsd_slam_tpu_torch.registration.nn import (
        assign_pairs_fused,
        projective_pairs_3d,
    )
    from ohm_tsd_slam_tpu_torch.sensor.polar2d import (
        SensorPolar2D,
        data_to_cartesian,
        standard_mask,
    )

    dev = node.grid.tsd.device
    fields = ("tsd", "weight", "tile_init", "tile_initw")
    out = {}

    def tree_run(grid, scans):
        """push_tree over `scans` from `grid` with every gated launch
        checked; the grids and the launch counts of that run alone."""
        saved = dispatch.best_push
        dispatch.best_push = lambda g: push_check
        reset_counts()
        grids = []
        try:
            for geom, pose, data, mask in scans:
                grid = push_tree(grid, geom, pose, data, mask)
                grids.append(grid)
            torch.cuda.synchronize()
        finally:
            dispatch.best_push = saved
        return grids, read_counts()

    # ---- push_tree along the ICP path's poses, full size ----
    cfg = from_flat_params(DOUBLE_LASER)
    half = cfg.grid.size_meters * 0.5
    gts = [trajectory((half + rc.local_offset_x, half + rc.local_offset_y,
                       rc.local_offset_yaw), SCANS_PER_ROBOT)
           for rc in cfg.robots]
    scans = []
    for k in range(SCANS_PER_ROBOT):
        for r, rc in enumerate(cfg.robots):
            geom = geom_1081(rc.sensor.max_range)
            data, mask = standard_mask(geom, torch.as_tensor(
                scan_ranges(gts[r][k], geom.max_range), dtype=torch.float32,
                device=dev))
            scans.append((geom, se2.make(*gts[r][k], device=dev), data,
                          mask))
    grid0 = create(cfg.grid, dtype=torch.float32, device=dev)
    st0 = dict(push_check.stats)
    grids, counts = tree_run(grid0, scans)
    pruned = push_check.stats["pruned"] - st0["pruned"]
    gated = push_check.stats["gated_calls"] - st0["gated_calls"]
    assert counts["push"] == gated == len(scans), (counts, gated)
    assert not any(v for k, v in counts.items() if k != "push"), counts
    worst = {"max_abs_err": 0.0, "nan_mismatch_rate": 0.0,
             "rate_over_1e-3": 0.0}
    prev = grid0
    for (geom, pose, data, mask), got in zip(scans, grids):
        flat = push_cuda(prev, geom, pose, data, mask)
        for f in fields:
            assert bits_equal(getattr(got, f), getattr(flat, f)), f
        twin = push(prev, geom, pose, data, mask,
                    tile_gate=branch_gate(prev, geom, pose))
        stats = compare_push(twin, got)
        for key in worst:
            worst[key] = max(worst[key], stats[key])
        prev = got
    assert worst["max_abs_err"] <= PUSH_TOL, worst
    out["tree_path"] = {"pushes": len(scans), "launches": counts["push"],
                        "pruned_tiles": pruned, **worst,
                        "finite_cells": int(torch.isfinite(
                            grids[-1].tsd).sum())}
    print(f"inventory push_tree, ICP path's {len(scans)} poses: "
          f"{json.dumps(out['tree_path'])}; every grid equal in every bit "
          f"to push_cuda's without a gate [{label}]")

    # ---- the pruning case: a 0.5 m sensor at the centre of map_size 9 ----
    short = SensorPolar2D(size=BEAMS, angular_res=RES, phi_min=PHI_MIN,
                          max_range=0.5, min_range=0.01)
    g9 = create(GridConfig(map_size=9, cellsize=0.05, truncation_radius=3.0),
                dtype=torch.float32, device=dev)
    rng = np.random.default_rng(11)
    ranges = rng.uniform(0.2, 0.45, BEAMS)
    ranges[rng.random(BEAMS) < 0.1] = np.inf
    data9, mask9 = standard_mask(short, torch.as_tensor(
        ranges, dtype=torch.float32, device=dev))
    pose9 = se2.make(12.8, 12.8, 0.0, device=dev)
    (tree9,), counts9 = tree_run(g9, [(short, pose9, data9, mask9)])
    gate9 = branch_gate(g9, short, pose9)
    flat9 = push_cuda(g9, short, pose9, data9, mask9)
    for f in fields:
        assert bits_equal(getattr(tree9, f), getattr(flat9, f)), f
    out["pruning_case"] = {"launches": counts9["push"],
                           "pruned_tiles": int((~gate9).sum()),
                           "tiles": gate9.numel(),
                           "touched": int(tree9.tile_init.sum())}
    assert counts9["push"] == 1 and out["pruning_case"]["pruned_tiles"] >= 1
    assert not bool(gate9[0, 0]) and out["pruning_case"]["touched"] > 0
    print(f"inventory push_tree pruning case: "
          f"{json.dumps(out['pruning_case'])}, equal to the ungated push "
          f"in every bit [{label}]")

    # ---- a seeded random gate (60% open) into the kernel, full size ----
    # branch_gate closes no tile that tile_cull touches, so on the paths
    # above a kernel that ignored its gate would give the same grids.
    # This gate closes touched tiles: each closed tile must be copied
    # through, each open one fused as without a gate.
    loc = node.localizers[0]
    grid, geom, lpose = node.grid, loc.geom, loc.pose.contiguous()
    xyt = (float(lpose[0, 2]), float(lpose[1, 2]),
           math.atan2(float(lpose[1, 0]), float(lpose[0, 0])))
    data, mask = node._preprocess(loc, scan_ranges(xyt, geom.max_range))

    def random_gate(g, geom_, pose_, data_, mask_, seed, ty0=0):
        td = g.tile_dim
        gate_ = torch.as_tensor(np.random.default_rng(seed).random(
            (g.tiles_y, g.tiles_x)) < 0.6, device=dev)
        got = push_check(g, geom_, pose_, data_, mask_, tile_gate=gate_,
                         ty0=ty0)
        flat = push_cuda(g, geom_, pose_, data_, mask_, ty0=ty0)
        stats = compare_push(push(g, geom_, pose_, data_, mask_,
                                  tile_gate=gate_, ty0=ty0), got)
        assert stats["max_abs_err"] <= PUSH_TOL, stats
        cells = gate_.repeat_interleave(td, 0).repeat_interleave(td, 1)
        for f in ("tsd", "weight"):
            a, b, c = getattr(got, f), getattr(flat, f), getattr(g, f)
            assert bits_equal(a[cells], b[cells]), f
            assert bits_equal(a[~cells], c[~cells]), f
        moved = (flat.tsd.view(torch.int32) != g.tsd.view(torch.int32)
                 ).reshape(g.tiles_y, td, g.tiles_x, td).any(3).any(1)
        row = {"ty0": ty0, "tiles": gate_.numel(),
               "closed": int((~gate_).sum()),
               "closed_and_fused_without_the_gate": int((moved & ~gate_
                                                         ).sum()),
               "tile_init_differs": not torch.equal(got.tile_init,
                                                    flat.tile_init),
               "tsd_differs": not bits_equal(got.tsd, flat.tsd),
               "max_abs_err": stats["max_abs_err"],
               "rate_over_1e-3": stats["rate_over_1e-3"]}
        assert row["closed_and_fused_without_the_gate"] > 0, row
        assert row["tsd_differs"], row
        return row, gate_

    fresh, _ = random_gate(grid0, *scans[0], seed=31)
    assert fresh["tile_init_differs"], fresh
    icp_grid, rgate = random_gate(grid, geom, lpose, data, mask, seed=32)
    # a row block (the second quarter of the tile rows) with ty0: the
    # gate is indexed by the block's own tile rows
    td, q = grid.tile_dim, grid.tiles_y // 4
    block = dataclasses.replace(
        grid, tsd=grid.tsd[q * td:2 * q * td].clone(),
        weight=grid.weight[q * td:2 * q * td].clone(),
        tile_init=grid.tile_init[q:2 * q].clone(),
        tile_initw=grid.tile_initw[q:2 * q].clone())
    rows, _ = random_gate(block, geom, lpose, data, mask, seed=33, ty0=q)
    out["random_gate"] = {"fresh_grid": fresh, "icp_grid": icp_grid,
                          "row_block": rows}
    print(f"inventory push kernel with a seeded random gate: "
          f"{json.dumps(out['random_gate'])}; closed tiles copied through "
          f"and open ones equal to the ungated launch in every bit, tsd "
          f"within {PUSH_TOL} of the gated plain push [{label}]")

    # ---- the gated and the ungated launch, on the ICP path's grid and
    # on the pruning case's ----
    gate = branch_gate(grid, geom, lpose)
    gate_u8 = gate.to(torch.uint8).contiguous()
    rgate_u8 = rgate.to(torch.uint8).contiguous()
    gate9_u8 = gate9.to(torch.uint8).contiguous()
    held, held9 = empty_like(grid), empty_like(g9)
    t = {
        "push kernel device time, gated (tsd_push_f32 with branch_gate's "
        "gate, replayed from a CUDA graph)": time_device(
            lambda: launch(grid, geom, lpose, data, mask, held,
                           gate=gate_u8)),
        "push kernel device time, ungated (the same call)": time_device(
            lambda: launch(grid, geom, lpose, data, mask, held)),
        "push kernel device time, random gate 60% open (the same call)":
            time_device(lambda: launch(grid, geom, lpose, data, mask, held,
                                       gate=rgate_u8)),
        "push kernel device time, pruning case gated (map_size 9, 0.5 m)":
            time_device(lambda: launch(g9, short, pose9, data9, mask9, held9,
                                       gate=gate9_u8)),
        "push kernel device time, pruning case ungated (the same call)":
            time_device(lambda: launch(g9, short, pose9, data9, mask9,
                                       held9)),
        "push_tree wrapper (branch_gate in torch + push_cuda)": time_cuda(
            lambda: push_tree(grid, geom, lpose, data, mask)),
        "push_cuda wrapper, ungated (the same call)": time_cuda(
            lambda: push_cuda(grid, geom, lpose, data, mask))}
    out["times"] = report_times(t, label)
    print(f"inventory timed push: {int((~gate).sum())} of {gate.numel()} "
          f"tiles pruned by branch_gate on the ICP path's grid, "
          f"{int((~gate9).sum())} of {gate9.numel()} in the pruning case "
          f"[{label}]")

    # ---- projective pairs and the occlusion filter, 640 x 480 ----
    # the second cloud: the first turned 0.01 rad about z and about y,
    # then moved by (0.02, -0.01, 0.03) m
    cloud, P = depth_cloud(21)
    c, s1 = math.cos(0.01), math.sin(0.01)
    R = (np.array([[c, -s1, 0.0], [s1, c, 0.0], [0.0, 0.0, 1.0]])
         @ np.array([[c, 0.0, s1], [0.0, 1.0, 0.0], [-s1, 0.0, c]]))
    scene = (cloud.astype(np.float64) @ R.T
             + np.array([0.02, -0.01, 0.03])).astype(np.float32)
    scene_mask = scene[:, 2] > 0
    behind = cloud * ((cloud[:, 2:] + 0.5) / np.maximum(cloud[:, 2:], 1e-9))
    occl = np.concatenate([cloud, behind[::2]]).astype(np.float32)
    occl_mask = occl[:, 2] > 0
    res = {}
    for where in ("cuda", "cpu"):
        d = dev if where == "cuda" else torch.device("cpu")
        T = {name: torch.as_tensor(a, device=d) for name, a in (
            ("model", cloud), ("scene", scene), ("mask", scene_mask),
            ("P", P), ("occl", occl), ("occl_mask", occl_mask))}
        res[where] = (projective_pairs_3d(T["model"], T["scene"], T["mask"],
                                          T["P"], PROJ_W, PROJ_H),
                      occlusion_filter(T["occl"], T["occl_mask"], T["P"],
                                       PROJ_W, PROJ_H))
    (idx, d2, pair), kept = res["cuda"]
    (idx_c, d2_c, pair_c), kept_c = res["cpu"]
    assert bits_equal(idx, idx_c) and bits_equal(pair, pair_c)
    assert bits_equal(d2, d2_c) and bits_equal(kept, kept_c)
    out["projective"] = {"points": int(cloud.shape[0]),
                         "pairs": int(pair.sum()),
                         "occlusion_points": int(occl.shape[0]),
                         "occluded": int((occl_mask & ~kept.cpu().numpy()
                                          ).sum())}
    assert out["projective"]["pairs"] > 0.5 * cloud.shape[0]
    assert out["projective"]["occluded"] > 0.3 * behind[::2].shape[0]
    print(f"inventory projective_pairs_3d and occlusion_filter, "
          f"{PROJ_W} x {PROJ_H}: {json.dumps(out['projective'])}, indices, "
          f"d2 and masks equal to the CPU port's in every bit [{label}]")

    # ---- trimmed_filter on the ICP path's last scan's pairs ----
    seg = node._segments_for(grid)
    scene2, scene2_mask = data_to_cartesian(geom, data, mask)
    model = rf.raycast_fast(grid, geom, lpose, segments=seg)
    reg = icp(model.coords, model.mask, scene2, scene2_mask, loc.params.icp,
              sensor_pose=lpose, model_normals=model.normals)
    _, d2p, pmask, _ = assign_pairs_fused(
        model.coords, model.mask, se2.transform_points(reg.T, scene2),
        scene2_mask, model.normals)
    trimmed = trimmed_filter(d2p, pmask, TRIM_PERCENT)
    trimmed_c = trimmed_filter(d2p.cpu(), pmask.cpu(), TRIM_PERCENT)
    assert bits_equal(trimmed, trimmed_c)
    n = int(pmask.sum())
    out["trimmed"] = {"pairs": n, "kept": int(trimmed.sum()),
                      "percent": TRIM_PERCENT}
    assert out["trimmed"]["kept"] == math.floor(
        np.float32(n) * np.float32(TRIM_PERCENT) / np.float32(100.0)) > 0
    print(f"inventory trimmed_filter on the ICP path's last scan: "
          f"{json.dumps(out['trimmed'])}, equal to the CPU port's [{label}]")

    # ---- surface_points on the ICP path's grid ----
    pts, pmask2 = surface_points(grid)
    pts_c, pmask2_c = surface_points(from_arrays(to_arrays(grid),
                                                 device="cpu"))
    assert bits_equal(pmask2, pmask2_c)
    assert bits_equal(pts[pmask2], pts_c[pmask2_c])
    assert torch.equal(torch.isnan(pts).cpu(), torch.isnan(pts_c))
    H, W = grid.tsd.shape
    out["surface_points"] = {"slots": int(pts.shape[0]),
                             "crossings": int(pmask2.sum())}
    assert out["surface_points"]["slots"] == H * (W - 1) + (H - 1) * W
    assert out["surface_points"]["crossings"] > 1000
    print(f"inventory surface_points on the ICP path's grid: "
          f"{json.dumps(out['surface_points'])}, equal to the CPU port's in "
          f"every bit [{label}]")
    return out


CROSSOVER_POSES = (1, 2, 3, 4, 8)    # 1081 to 8648 beams


def rounds_crossover(rounds, rounds_args: list, beams_per_pose: int) -> dict:
    """The rounds kernel on the first P poses' beams of the batch's state
    (P in CROSSOVER_POSES, the caster's capacity for that many beams), in
    one block and in a cooperative launch of a block for each
    ROUNDS_THREADS beams: both give every row and the drop count alike,
    and their device times (each after a copy of the state, which both
    pay) say where ONE_BLOCK_BEAMS should lie."""
    from ohm_tsd_slam_tpu_torch.grid import raycast_fast as rf
    from ohm_tsd_slam_tpu_torch.ops.window_replay_cuda import ROUNDS_THREADS

    g_, S0, lev, ray, idx_min, idx_max, tr, _ = rounds_args
    t = {}
    for p in CROSSOVER_POSES:
        n = p * beams_per_pose
        cap = rf.unresolved_cap(n)
        args = (lev[:n], ray[:n], idx_min[:n], idx_max[:n], tr[:p], cap)
        S_n = S0[:n].clone()
        S_work = S_n.clone()
        rows = {}
        for blocks in (1, -(-n // ROUNDS_THREADS)):
            got, dropped = rounds(g_, S_n.clone(), *args, blocks=blocks)
            rows[blocks] = (got, int(dropped))
            t[f"rounds crossover: {n} beams, {blocks} block(s) (device "
              f"time after a copy of the state, replayed from a CUDA "
              f"graph)"] = time_device(
                lambda: (S_work.copy_(S_n),
                         rounds(g_, S_work, *args, blocks=blocks)), reps=4)
        (one, d_one), (coop, d_coop) = rows.values()
        # bit for bit (a row's normal is NaN where it has none)
        assert torch.equal(one.view(torch.int32), coop.view(torch.int32)) \
            and d_one == d_coop, (n, d_one, d_coop)
    return t


def batch_times(node, batch: dict, multi: dict, label: str) -> tuple:
    """Times at the batch shape (P = 128 on the ICP path's grid): the
    whole raycast_fast_batch (wrapper time and device time, and rays a
    second), kernels C, D and D's rounds alone against their twins, each
    wrapper's time and device time; the multi-robot step per step.
    Returns the medians and the facts the bounds need."""
    from ohm_tsd_slam_tpu_torch.grid import raycast_fast as rf
    from ohm_tsd_slam_tpu_torch.grid.raycast import beam_geometry_batch
    from ohm_tsd_slam_tpu_torch.parallel import multi_robot_slam_step

    loc = node.localizers[0]
    grid, geom = node.grid, loc.geom
    poses = pose_batch(loc.pose.contiguous())
    seg = node._segments_for(grid)
    ks = caster_wrappers()
    t = {}
    t["raycast_fast_batch (P=128, cached segments)"] = time_cuda(
        lambda: rf.raycast_fast_batch(grid, geom, poses, segments=seg))
    t["raycast_fast_batch device time (P=128, replayed from a CUDA "
      "graph)"] = time_device(
        lambda: rf.raycast_fast_batch(grid, geom, poses, segments=seg),
        reps=4)

    ray, tr, idx_min, idx_max, feasible = beam_geometry_batch(grid, geom,
                                                              poses)
    N = ray.shape[0] * ray.shape[1]
    ray, idx_min, idx_max, feasible = (ray.reshape(N, 2), idx_min.reshape(N),
                                       idx_max.reshape(N), feasible.reshape(N))
    lo = (torch.floor(idx_min) - 1.0).clamp(min=0.0)
    hi = torch.ceil(idx_max) + 1.0
    tr_pack = (tr - seg.origin).contiguous()
    cargs = (seg.pack, seg.count, ray, lo, hi, lo, tr_pack)
    t["C segment_min kernel (batch P=128, K=4)"] = time_cuda(
        lambda: ks["segment_min"](*cargs, rf.ROUNDS, rf.COVER))
    t["C segment_min plain (batch P=128, K=4)"] = time_cuda(
        lambda: rf.segment_min_plain(*cargs, rf.ROUNDS, rf.COVER), n=5,
        warmup=1)
    t["C segment_min device time (batch P=128, K=4, replayed from a CUDA "
      "graph)"] = time_device(
        lambda: ks["segment_min"](*cargs, rf.ROUNDS, rf.COVER), reps=4)
    lev = ks["segment_min"](*cargs, rf.ROUNDS, rf.COVER)
    has = torch.isfinite(lev[:, 0]) & feasible
    k_1 = torch.where(has, lev[:, 0], 0.0)
    dargs = (grid, k_1, ray, idx_min, idx_max, has, tr.contiguous())
    t["D window_replay kernel (batch P=128)"] = time_cuda(
        lambda: ks["window_replay"](*dargs))
    t["D window_replay plain (batch P=128)"] = time_cuda(
        lambda: rf.window_replay_plain(*dargs), n=5, warmup=1)
    t["D window_replay device time (batch P=128, replayed from a CUDA "
      "graph)"] = time_device(lambda: ks["window_replay"](*dargs), reps=4)

    g_, S0, lev_r, *beams, cap = batch["rounds_args"]
    fresh = iter([S0.clone() for _ in range(N_TIMED + 3)])
    t["D window_rounds kernel (batch P=128)"] = time_cuda(
        lambda: ks["window_rounds"](g_, next(fresh), lev_r, *beams, cap))
    t["D window_rounds plain (batch P=128)"] = time_cuda(
        lambda: rf.window_rounds_plain(g_, S0, lev_r, *beams, cap), n=5,
        warmup=1)
    S_work = S0.clone()
    t["D window_rounds device time (batch P=128, after a copy of the "
      "state, replayed from a CUDA graph)"] = time_device(
        lambda: (S_work.copy_(S0),
                 ks["window_rounds"](g_, S_work, lev_r, *beams, cap)),
        reps=4)
    t["D window_rounds state copy alone (batch P=128, replayed from a CUDA "
      "graph)"] = time_device(lambda: S_work.copy_(S0), reps=4)
    t.update(rounds_crossover(ks["window_rounds"], batch["rounds_args"],
                              geom.size))
    # a beam needs a later round while it is unresolved and has a candidate
    # there (at most these replay; a beam that resolves stops needing)
    unresolved = S0[:, 1] == 0
    needing = [int(n) for n in
               (torch.isfinite(lev_r) & unresolved[:, None]).sum(0)]
    print(f"batch rounds: unresolved beams with a candidate in rounds 2-4 "
          f"{needing}, unresolved after round 1 {int(unresolved.sum())} "
          f"(capacity {cap})")

    cfg_grid, poses_m = multi["grid"], multi["poses"]
    data, mask = multi_robot_inputs(multi["gts"], STEPS_MULTI,
                                    poses_m.device)
    t["multi_robot_slam_step (2 robots, ICP; CUDA events around the step, "
      "which reads the drop count once)"] = time_cuda(lambda: multi_robot_slam_step(
        cfg_grid, poses_m, data, mask, multi["params"], seed=1), n=10)
    medians = report_times(t, label)
    rays = N / (medians["raycast_fast_batch (P=128, cached segments)"]
                * 1e-3)
    rays_dev = N / (medians["raycast_fast_batch device time (P=128, "
                            "replayed from a CUDA graph)"] * 1e-3)
    print(f"raycast_fast_batch: {rays:,.0f} rays/s by the wrapper, "
          f"{rays_dev:,.0f} rays/s by the device time (P=128, {N} beams) "
          f"[{label}]")
    facts = {"batch_beams": N, "batch_poses": poses.shape[0],
             "batch_rounds_needing": sum(needing), "rays_per_s": rays,
             "rays_per_s_device": rays_dev}
    return medians, facts


# the batch's times of C, D and D's rounds in the kernels line: (tag, the
# shape's suffix in batch_times' keys)
BATCH_KEYS = {"segment_min": ("C", ", K=4"), "window_replay": ("D", ""),
              "window_rounds": ("D", "")}


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

    def taps(n_replays):
        # 8 samples + 4 normal taps of 4 cells a replay, but the field
        # once at most: the replays of nearby poses read the same cells
        return min(n_replays * 12 * 16, cells * 4)

    rows = 4 * cells // 128
    cap = 32768 + 128
    segs = facts["segments"]
    nb = facts["batch_beams"]
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
        # the main path's one sweep of K levels: the kept segments' 8 pack
        # rows, 7 values a beam, K values out; ~20 operations a
        # beam-segment pair, once (a pair's t does not depend on the level:
        # a later level only compares a beam's candidates, some tens of its
        # pairs, against the new bound, counted as one compare a beam)
        "segment_min": (segs * 32 + beams * 28
                        + beams * 4 * facts["sweep_levels"],
                        beams * segs * 20
                        + beams * (facts["sweep_levels"] - 1)),
        # round 1: the taps (above), 7 values in a beam, 8 out; ~25
        # operations a tap
        "window_replay": (taps(beams) + beams * (28 + 32), beams * 12 * 25),
        # the rounds: a beam's candidates and its resolved flag read, the
        # flag written; a replay (taps, 5 values in, a row out) for each
        # beam with a candidate in this run; ~6 operations a beam a round
        "window_rounds": (beams * (facts["rounds"] * 4 + 8)
                          + taps(facts["rounds_needing"])
                          + facts["rounds_needing"] * (20 + 32),
                          beams * facts["rounds"] * 6
                          + facts["rounds_needing"] * 12 * 25),
        # main-path shape: the bool mask read, 4 values a set lane, the
        # pack written; one compare a lane
        "compact_channels": (facts["narrow_lanes"]
                             + facts["narrow_segments"] * 16 + 5 * cap * 4,
                             facts["narrow_lanes"]),
        "compact_channels_large": (facts["lanes"] + segs * 16 + 5 * cap * 4,
                                   facts["lanes"]),
        # ICP's assignment, one iteration: the clouds, masks and payload
        # read once, idx, dist2, the mask and the paired rows written; ~10
        # operations a scene-model pair (two products, four sums, the
        # clamp, the mask, the compare)
        "assign_pairs": (facts["assign_M"] * (8 + 1 + 4 * facts["assign_K"])
                         + facts["assign_S"] * (8 + 1 + 4 + 4 + 1
                                                + 4 * facts["assign_K"]),
                         facts["assign_S"] * facts["assign_M"] * 10),
        # the same three at the batch's shape (P = 128 folded into the
        # beams; one translation row a pose instead of one a scan)
        "segment_min_batch": (segs * 32 + nb * 20 + nb * 4 * 4
                              + facts["batch_poses"] * 8,
                              nb * segs * 20 + nb * 3),
        "window_replay_batch": (taps(nb) + nb * (20 + 32), nb * 12 * 25),
        "window_rounds_batch": (nb * (facts["rounds"] * 4 + 8)
                                + taps(facts["batch_rounds_needing"])
                                + facts["batch_rounds_needing"] * (20 + 32),
                                nb * facts["rounds"] * 6
                                + facts["batch_rounds_needing"] * 12 * 25),
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
    if sys.argv[1:2] == ["--mesh-rank"]:
        return mesh_rank(*sys.argv[2:5])
    from ohm_tsd_slam_tpu_torch.ops import _build

    dev = torch.device("cuda")
    t_all = time.perf_counter()
    t_lap = [t_all]

    def lap(name):
        now = time.perf_counter()
        print(f"phase {name}: {now - t_lap[0]:.1f} s")
        t_lap[0] = now
    # 1. device
    label = card_label()
    print(f"nvidia-smi name, power.limit: {label}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # 2. build (from the sources in this checkout, never a cached library)
    # the kernels (ICP's pair assignment among them: no TPU kernel), and
    # the conditional nodes' setter of utils/compiled.py (glue: no TPU
    # kernel)
    names = (["push"] + [name for name, _, _ in CASTER if name not in SOURCE]
             + ["assign_pairs", "graph_cond"])
    for name in names:
        if os.path.exists(_build.lib_path(name)):
            os.remove(_build.lib_path(name))
    t0 = time.perf_counter()
    _build.build_all(names)
    for name in names:
        _build.load(name)
    print(f"build {len(names)} sources in csrc/ with nvcc, in parallel: "
          f"{time.perf_counter() - t0:.2f} s")
    for name in ("push", "window_replay", "segment_min", "pack_rows",
                 "compact_channels", "assign_pairs"):
        frames = []
        for line in _build.resource_usage(name):
            if ("Used" in line or "Function properties" in line
                    or "stack frame" in line):
                print(f"ptxas csrc/{name}.cu: {line}")
            if "stack frame" in line:
                frames.append(line)
        # no kernel of these indexes a local array at run time or spills
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
    for name, stats in sweep_pack_check(dev, caster_stats).items():
        print(f"kernel check sweep and pack {name}: {json.dumps(stats)}")
    for name, stats in compact_check(dev, caster_stats).items():
        print(f"kernel check compact_channels {name}: {json.dumps(stats)}")

    # 4a. the ICP-mode path, then the caster's kernels on the grid it
    # built, then its icp calls again with the histories on
    # (every ICP assignment of the path held against its twin)
    icp_calls = []
    restore_icp = keep_icp_calls(icp_calls)
    try:
        icp_assign = checked_assignments("ICP path", label, main_path, dev,
                                         label, push_check)
        node, launches, icp_run = icp_assign["out"]
    finally:
        restore_icp()
    icp_fns = icp_record_check(icp_calls, label)
    del icp_calls
    for name, stats in main_grid_check(node, caster_stats).items():
        print(f"kernel check caster main-path grid {name}: "
              f"{json.dumps(stats)}")
    print("kernel check compact_channels main-path grid: "
          f"{json.dumps(main_grid_compact_check(node, caster_stats))}")
    lap("1-3 build and kernel checks, 4a main path")

    # 4b. the general-extraction path; 4c. TSD, then EXP and PDF
    narrow, narrow_run = narrow_path(dev, label, caster_stats, push_check)
    narrow_launches = narrow_run["launches"]
    tsd_assign = checked_assignments("TSD, EXP and PDF paths", label,
                                     ransac_paths, dev, label, push_check)
    tsd_node, tsd_run = tsd_assign["out"]
    tsd_launches = tsd_run["launches"]
    lap("4b, 4c eager paths")
    # 4c'. the ICP, general-extraction and TSD paths again on the compiled
    # step, each scan's result held against the eager step's
    icp_run["launches"] = launches
    compiled_paths = (("ICP", DOUBLE_LASER, icp_run),
                      ("map_size 6", NARROW, narrow_run),
                      ("TSD", SINGLE_LASER, tsd_run))
    compiled_path(dev, label, push_check, compiled_paths)
    # ... and the threaded runtime on it, capturing while its threads run
    threaded_path(dev, label, icp_run)
    lap("4c' compiled paths")
    # ... and the ICP path on it with the fast caster's capacity forced
    # below the map's segments: the guard inside the graph
    overflow = overflow_path(dev, label, icp_run)
    lap("4c'' overflow path")
    # 4c'''. the site: the double laser at map_size 12, every kernel call
    # held against its twin; then the reach cull against the whole pack
    site_node, site_run = site_path(dev, label, push_check, caster_stats,
                                    icp_run)
    site_cull_times(site_node, label)
    del site_node
    lap("4c''' site path")
    # 4d. GN, AMCL with the kidnap, the odometry rescue; the render on the
    # ICP path's grid; TwinPoint and multi-init on the TSD path's scene
    gn_node, _ = gn_path(dev, label, push_check)
    amcl_node, _ = amcl_path(dev, label, push_check)
    odom_path(dev, label, push_check)
    render_check(node, label)
    twin_fns = twin_multi_check(tsd_node, label)
    lap("4d")
    # 4e. the pose batch (P = 128) on the ICP path's grid; the multi-robot
    # step on the double laser's settings; the command line
    batch = batch_check(node, label, caster_stats)
    # 4f's rank processes start here and set up while 4e runs
    mesh_tmp = tempfile.TemporaryDirectory()
    started = start_mesh_worlds(mesh_tmp.name)
    try:
        multi = multi_robot_path(dev, label, push_check)
        # 4f. the row-sharded step over meshes of 1, 2 and 4 ranks here
        mesh = mesh_path(started, label, push_check, caster_stats)
    finally:
        stop_mesh_worlds(started)
        mesh_tmp.cleanup()
    for name, stats in block_check(node.grid, caster_stats).items():
        print(f"kernel check A and B on a row block, {name}: "
              f"{json.dumps(stats)}")
    cli = cli_path(label)
    lap("4e, 4f")
    # 4g. push_tree through the gated push kernel, the 3D filters, the
    # trimmed filter and surface_points
    inventory = inventory_path(node, label, push_check)
    # 4h. the compiled entry points of this slice against their eager calls
    _, entry = entry_points_path(dev, label, node, icp_run["gts"])
    lap("4g, 4h")
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
    more, more_facts = assign_times(icp_assign["check"], label)
    times.update(more)
    facts.update(more_facts)
    more, more_facts = ransac_times(tsd_node, narrow, label)
    times.update(more)
    more, steps = slice_times(gn_node, amcl_node, node, twin_fns, label)
    times.update(more)
    facts.update(more_facts)
    more, more_facts = batch_times(node, batch, multi, label)
    times.update(more)
    facts.update(more_facts)
    more, compiled_fns = compiled_times(dev, label)
    times.update(more)
    steps.update(compiled_fns)
    lap("5 times")
    one_step = times["multi_robot_slam_step (2 robots, ICP; CUDA events "
                     "around the step, which reads the drop count once)"]
    for world, ranks in mesh.items():
        for r in ranks:
            render = statistics.median(r["render_ms"])
            inline = statistics.median(r["one_card_ms"])
            cached = statistics.median(r["one_card_cached_ms"])
            step = statistics.median(r["step_ms"])
            print(f"mesh {world} rank {r['rank']}: sharded render "
                  f"{render:.4f} ms, {render / cached:.2f}x raycast_fast's "
                  f"with cached segments ({cached:.4f} ms) and "
                  f"{render / inline:.2f}x its with the extraction inline "
                  f"({inline:.4f} ms) in the same world; step {step:.4f} ms "
                  f"against the one-card step's {one_step:.4f} ms in this "
                  f"run (gap {step - one_step:.4f} ms) [{label}]")
    print(f"cli run: process_scan median {cli['per_scan_median_ms']:.4f} ms "
          f"a scan over {cli['scans'] - 1} scans (host clock, printed by the "
          f"run), max |pose - truth| {cli['max_err']:.6f} m [{label}]")
    bounds = kernel_bounds(facts)
    device_kernel_counts(node, label, steps)
    icp_kernel_counts(icp_fns, label)
    compiled = compiled_device_launches(dev, label, compiled_paths)
    new_paths = new_path_launches(dev, label, icp_run, overflow, entry)
    lap("traced launches")

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

    def compiled_launches(name):
        # the compiled paths' device launches from their trace, replays'
        # included
        return {path: "not measured" if found is None else found[name]
                for path, found in compiled.items()}

    def new_launches(name):
        # the overflow path's and the entry points' device launches
        return {path: "not measured" if found is None else found[name]
                for path, found in new_paths.items()}

    def mesh_launches(name):
        # per world, each rank's launches in the mesh path's ICP steps
        return {world: [r["launches"][name] for r in ranks]
                for world, ranks in mesh.items()}

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
        launches_tsd_path=tsd_launches["push"],
        launches_site_path=site_run["launches"]["push"],
        launches_mesh_path=mesh_launches("push"),
        launches_compiled_path=compiled_launches("push"),
        launches_overflow_and_entry_points=new_launches("push"),
        launches_tree_path=inventory["tree_path"]["launches"],
        max_abs_err_gated=inventory["tree_path"]["max_abs_err"],
        device_ms_gated=inventory["times"][
            "push kernel device time, gated (tsd_push_f32 with "
            "branch_gate's gate, replayed from a CUDA graph)"],
        device_ms_ungated_same_call=inventory["times"][
            "push kernel device time, ungated (the same call)"],
        max_abs_err_random_gate=max(
            r["max_abs_err"] for r in inventory["random_gate"].values()),
        device_ms_pruning_case={
            "gated": inventory["times"][
                "push kernel device time, pruning case gated (map_size 9, "
                "0.5 m)"],
            "ungated": inventory["times"][
                "push kernel device time, pruning case ungated (the same "
                "call)"]})]
    for (name, fn, replaces), tag in zip(CASTER, "ABCDED"):
        key = next(k for k in times if k.startswith(f"{tag} {name} kernel"))
        extra = {"launches_tsd_path": tsd_launches[name],
                 "launches_site_path": site_run["launches"][name],
                 "launches_mesh_path": mesh_launches(name),
                 "launches_compiled_path": compiled_launches(name),
                 "launches_overflow_and_entry_points": new_launches(name)}
        library = None
        count = launches[name]
        # the first time of that name is the main path's call (for C the
        # one sweep of K=ROUNDS).  A's and D's wrappers hold no buffer:
        # their launch alone is the wrapper
        alone = [times[k] for k in times
                 if k.startswith(f"{tag} {name} launch alone")]
        extra.update(kernel_ms=alone[0] if alone else times[key],
                     device_ms=next(
                         times[k] for k in times
                         if k.startswith(f"{tag} {name} device time")))
        if name == "window_rounds":
            extra["state_copy_device_ms"] = times[
                "D window_rounds state copy alone (replayed from a CUDA "
                "graph)"]
        if name in BATCH_KEYS:
            # the same kernel at the pose batch's shape (P = 128)
            tag, shape = BATCH_KEYS[name]
            key_b = f"{tag} {name} kernel (batch P=128{shape})"
            extra.update(
                batch_launches=batch["launches"][name],
                launches_multi_robot_path=multi["launches"][name],
                batch_ms=times[key_b],
                batch_plain_ms=times[key_b.replace(" kernel", " plain")],
                batch_device_ms=next(
                    times[k] for k in times
                    if k.startswith(f"{tag} {name} device time (batch")),
                batch_bound_ms=bounds[f"{name}_batch"][0],
                batch_bound_by=bounds[f"{name}_batch"][1],
                batch_max_abs_err=batch["kernels"][name]["max_abs_err"])
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
                "launches_site_path": site_run["launches"][name],
                "launches_mesh_path": mesh_launches(name),
                "launches_compiled_path": compiled_launches(name),
                "launches_overflow_and_entry_points": new_launches(name),
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
    # ICP's pair assignment: no TPU kernel (the JAX package leaves it to
    # XLA); its wrapper holds nothing but its results, so its launch alone
    # is the wrapper
    key = next(k for k in times if k.startswith("assign_pairs kernel ("))
    kernels.append({
        "name": "assign_pairs_f32", "route": "cuda",
        "source": "ohm_tsd_slam_tpu_torch/csrc/assign_pairs.cu",
        "replaces": "none (the port's own kernel: the JAX package leaves "
                    "registration/nn.py::assign_pairs_fused to XLA)",
        "launches": icp_assign["launches"],
        "launches_tsd_exp_pdf_paths": tsd_assign["launches"],
        # every output equal to the twin's in every bit (AssignCheck)
        "max_abs_err": 0.0, "ms": times[key],
        "plain_ms": times[key.replace(" kernel", " plain")],
        "bound_ms": bounds["assign_pairs"][0],
        "bound_by": bounds["assign_pairs"][1], "library_ms": None,
        "kernel_ms": times[key],
        "device_ms": next(times[k] for k in times
                          if k.startswith("assign_pairs device time")),
        "plain_device_ms": next(times[k] for k in times if k.startswith(
            "assign_pairs plain device time"))})
    for k in kernels:
        assert k["launches"] > 0, k
        # the bound is held against the device's share where that was
        # measured, else against the wrapper's time
        own = k["device_ms"]
        apart = (f"launch alone {k['kernel_ms']:.4f} ms, device "
                 f"{k['device_ms']:.4f} ms")
        library = ("none" if k["library_ms"] is None
                   else f"{k['library_ms']:.4f} ms")
        print(f"kernel {k['name']}: wrapper {k['ms']:.4f} ms, {apart}, "
              f"bound {k['bound_ms']:.6f} ms by {k['bound_by']} "
              f"({k['bound_ms'] / own:.2%} of {own:.4f} ms), plain "
              f"{k['plain_ms']:.4f} ms, library {library} [{label}]")
    print(f"chip_smoke.py whole run: {time.perf_counter() - t_all:.1f} s, "
          f"the kernels' build included [{label}]")
    print(f"nvidia-smi name, power.limit: {label}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
