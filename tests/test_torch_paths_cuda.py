"""Whole paths of the port through SlamNode on the card, every kernel launch
held against its plain twin (`cuda`-marked: they skip without one; run
them on the card with the README's `-m cuda` command).

This file imports torch and numpy only: the card's machine has no JAX.
The room, the deployments and the scans are utils/testing.py's, at the
upstream configs' full size (1024^2 cells of 0.025 m, 1081 beams).

`test_path_holds_every_kernel_to_its_twin` drives each path with the
node's step and extraction eager (a replay calls no wrapper, so only the
eager step passes each launch through the checks): the mapper pushes
through ops/kernel_check.py::PushCheck (the kernel's cull against
tile_cull on every tile), ICP's assignment runs through AssignCheck (the
kernel against assign_pairs_plain in every bit), no plain twin may see a
CUDA tensor, and each kernel's launches are counted from the path alone
(one push launch a push; A and B, or E, once per grid version; C, D and
D's rounds once a scan).  The paths: ICP (the double laser, two robots),
the general extraction (map_size 6: kernel E), TSD (the single laser,
twice from one seed), EXP, PDF, GN, AMCL with a kidnap, ICP with the
odometry rescue, and the 100 m site (map_size 12: every kernel against
its twin in every bit, the push against the plain push in every cell).
The other tests reuse the paths' nodes: the compiled paths' device
launches from a profiler trace, the overflow guard's and the compiled
entry points' launches, ICP's histories, ICP's replay (its device
operations an iteration, its result against the eager call), the
caster, the pose batch, the render, the row blocks and the functions
ported last on the ICP path's grid, TwinPoint and multi-init against the
CPU port, the multi-robot step and the row-sharded step in worlds of 1,
2 and 4 ranks on one card.
"""

import contextlib
import dataclasses
import importlib
import math
import os
import re
import sys
import warnings

import numpy as np
import pytest
import torch

from ohm_tsd_slam_tpu_torch.config import (
    GridConfig,
    RegMode,
    from_flat_params,
)
from ohm_tsd_slam_tpu_torch.core import se2
from ohm_tsd_slam_tpu_torch.grid import raycast_fast as rf
from ohm_tsd_slam_tpu_torch.grid.push import push
from ohm_tsd_slam_tpu_torch.grid.raycast import raycast
from ohm_tsd_slam_tpu_torch.grid.state import create, from_arrays, to_arrays
from ohm_tsd_slam_tpu_torch.ops.kernel_check import (
    POS_TOL,
    KernelCheck,
    PushCheck,
    bit_mismatch,
)
from ohm_tsd_slam_tpu_torch.ops.push_cuda import push_cuda
from ohm_tsd_slam_tpu_torch.registration import nn
from ohm_tsd_slam_tpu_torch.sensor.polar2d import standard_mask
from ohm_tsd_slam_tpu_torch.slam import SlamNode, localize, odometry
from ohm_tsd_slam_tpu_torch.slam import node as node_mod
from ohm_tsd_slam_tpu_torch.utils.testing import (
    BEAMS,
    DOUBLE_LASER,
    NARROW,
    PHI_MIN,
    RES,
    SINGLE_LASER,
    limit_cpu_threads,
    narrow_world,
    scan_ranges,
    trajectory,
    world,
)

# the card's run passes --noconftest: the helpers' file by its folder
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_card as tc  # noqa: E402
from torch_card import bits_equal, scan_msg  # noqa: E402

limit_cpu_threads()

# the package's `icp` is the function: the module by its name
icp_mod = importlib.import_module("ohm_tsd_slam_tpu_torch.registration.icp")

CELLS = 1024
SCANS = {"icp": 30, "narrow": 15, "tsd": 60, "other": 10, "gn": 30,
         "amcl": 20, "odom": 20, "site": 10, "overflow": 20}
ICP_RECORD_SCANS = 20        # ICP-path icp calls rerun with the histories on
# device operations of an ICP iteration (closed form, bounds, gate and
# reciprocal rule, float32) in icp_jit's graph, read from a trace on an
# H100: 57, the assignment's memset and two kernels among them (125 before
# the iteration was written in wide ops; tests/test_torch_icp_iteration.py
# counts the torch ops that launch the rest)
ICP_KERNELS_PER_ITERATION = 57
AMCL = {**SINGLE_LASER, "registration_mode": 5, "amcl_particles": 512,
        "amcl_iterations": 8,
        # tests/test_slam_e2e.py::test_slam_amcl_recovers_kidnap's
        # proposal and gates: a 0.49 m correction must pass the gate
        "amcl_sigma_trans": 0.3, "amcl_sigma_rot": 0.1,
        "reg_trs_max": 1.0, "reg_sin_rot_max": 0.9}
KIDNAP = (0.35, 0.35)
JUMP_SCAN = 12               # the scan of the odometry path taken off it
SITE = {**DOUBLE_LASER, "map_size": 12}    # slambench's double-laser-site
SITE_CELLS = 4096            # 102.4 m a side
SITE_ROOMS = (5, 7)          # copies of world()'s room, east and north
SITE_PITCH = (16.0, 14.0)    # m between their centres (2.4 m between walls)
# render gradients, card against the CPU port (float32), as a share of the
# largest magnitude; TwinPoint and multi-init transforms, card against CPU
RENDER_TOL = 1e-3
HIT_FLIPS = 0.005            # share of beams whose hit may differ card/CPU
TWIN_TOL = 1e-4
TWIN_TRIALS = 10             # TwinPoint trials held against the CPU port
N_POSES = 128                # the pose batch: bench.py's spread
BATCH_CAP = 16               # the rounds' capacity in the drop-order check
ENTRY_CALLS = 5              # calls of each compiled entry point traced
TRACE_SCANS = 15             # scan indices a profiler session traces
PROJ_W, PROJ_H, PROJ_F = 640, 480, 525.0   # the depth image's pinhole
TRIM_PERCENT = 80.0
FIELDS = ("tsd", "weight", "tile_init", "tile_initw")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@contextlib.contextmanager
def patched(*targets):
    """(module or class, attribute, value) set inside, restored after."""
    saved = [(m, a, getattr(m, a)) for m, a, _ in targets]
    for m, a, v in targets:
        setattr(m, a, v)
    try:
        yield
    finally:
        for m, a, v in reversed(saved):
            setattr(m, a, v)


def eager_step():
    """SlamNode's step and extraction eager on the card, and no priming
    (there is no graph to capture)."""
    return patched(
        (node_mod, "localize_step_jit", localize.localize_step),
        (node_mod, "extract_segments_jit", rf.extract_segments),
        (SlamNode, "_prime_step", lambda *args: None))


def watch_plain(on_cuda: list) -> list:
    """Every plain twin a wrapper runs for a CPU tensor, wrapped so that a
    call with a CUDA tensor is recorded in `on_cuda`: patched() targets."""
    out = []
    for mod, plain, _ in tc.WRAPPERS.values():
        m = importlib.import_module(f"ohm_tsd_slam_tpu_torch.ops.{mod}")

        def watched(*args, _orig=getattr(m, plain), _name=plain, **kwargs):
            if any(getattr(getattr(a, "tsd", a), "is_cuda", False)
                   for a in args):
                on_cuda.append(_name)
            return _orig(*args, **kwargs)

        out.append((m, plain, watched))
    return out


class AssignCheck:
    """Stands in for registration/icp.py's assign_pairs_fused: the kernel,
    then its twin assign_pairs_plain on the same inputs, the four outputs
    (idx, dist2, pair_mask, paired) equal in every bit."""

    def __init__(self):
        self.calls = self.pairs = 0

    def __call__(self, *args, **kwargs):
        got = nn.assign_pairs_fused(*args, **kwargs)
        want = nn.assign_pairs_plain(*args, **kwargs)
        for name, a, b in zip(("idx", "dist2", "pair_mask", "paired"), got,
                              want):
            assert bits_equal(a, b), (self.calls, name)
        self.calls += 1
        self.pairs += int(got[2].sum())
        return got


def kept_icp(calls: list):
    """A patched() target keeping each icp call of localize_step: its
    arguments and result (references: no copy, no launch)."""
    orig = localize.icp

    def kept(*args, **kwargs):
        res = orig(*args, **kwargs)
        calls.append((args, kwargs, res))
        return res

    return (localize, "icp", kept)


def drive(node, cfg, gts, scans, ks=None, dropped=None,
          around=None) -> dict:
    """Every robot's scans through node.process_scan in turns (those of
    the scan indices `ks`, all by default; index 0 starts each localizer),
    `around(call)` wrapped about each after the first where given.  Every
    scan's rays_dropped is 0, or, where the list `dropped` is given,
    appended to it.  Returns the tracking errors per robot, the localized
    scans, the grid versions made and the pose trace."""
    errs = [[] for _ in gts]
    trace = []
    n_scans = updates = 0
    for k in (range(len(gts[0])) if ks is None else ks):
        for r in range(len(gts)):
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
    for k in (k for k in (range(len(gts[0])) if ks is None else ks) if k):
        for r, gt in enumerate(gts):
            errs[r].append(math.hypot(float(poses[i, 0, 2]) - gt[k][0],
                                      float(poses[i, 1, 2]) - gt[k][1]))
            i += 1
    return {"errs": errs, "n_scans": n_scans, "updates": updates,
            "trace": poses}


def room_scans(flat, n, turn_deg=0.5, scene=world):
    """Each robot's trajectory of n scans from its start and its scans."""
    cfg = from_flat_params(flat)
    half = cfg.grid.size_meters * 0.5
    gts = [trajectory((half + rc.local_offset_x, half + rc.local_offset_y,
                       rc.local_offset_yaw), n, turn_deg)
           for rc in cfg.robots]
    return gts, [[scan_ranges(p, rc.sensor.max_range, scene) for p in gt]
                 for gt, rc in zip(gts, cfg.robots)]


def checked_run(dev, flat, gts, scans, seed=0):
    """The robots' scans through a new SlamNode of settings `flat`, the
    step eager, every push through PushCheck and every ICP assignment
    through AssignCheck, the launch counts
    set to 0 just before and read just after.  Asserted: no plain twin saw
    a CUDA tensor, one push launch a push, one assignment launch an ICP
    iteration, every robot within 2.5 cells of the truth.  Returns the
    node (pushing through push_cuda again) and the run."""
    from ohm_tsd_slam_tpu_torch.ops.assign_pairs_cuda import assign_pairs

    cfg = from_flat_params(flat)
    push_check, assign, calls, on_cuda = PushCheck(), AssignCheck(), [], []
    with eager_step():
        node = SlamNode(cfg, dtype=torch.float32, device=dev, seed=seed)
        assert node.mapper._push_fn is push_cuda, node.mapper._push_fn
        node.mapper._push_fn = push_check
        try:
            with patched(*watch_plain(on_cuda), kept_icp(calls),
                         (icp_mod, "assign_pairs_fused", assign)):
                tc.reset_counts()
                assign_pairs.launches = 0
                run = drive(node, cfg, gts, scans)
                torch.cuda.synchronize()
                run["launches"] = tc.read_counts()
                run["assign_launches"] = assign_pairs.launches
        finally:
            node.mapper._push_fn = push_cuda
    run.update(gts=gts, scans=scans, icp_calls=calls, pushes=push_check.stats,
               assign=assign)
    la = run["launches"]
    assert not on_cuda, on_cuda
    assert la["push"] == push_check.stats["calls"] > 2, la
    if len(gts) == 1:
        # a second robot's start frees its footprint: a version, no push
        assert la["push"] >= run["updates"], la
    iterations = sum(a[4].iterations for a, _, _ in calls)
    assert run["assign_launches"] == assign.calls == iterations, (
        run["assign_launches"], assign.calls, iterations)
    for r, e in enumerate(run["errs"]):
        assert max(e) < 2.5 * cfg.grid.cellsize, (r, max(e))
    assert all(loc.scan_count == run["n_scans"] // len(gts)
               for loc in node.localizers)
    return node, run


def assert_rendering_launches(la, run, extraction=("segment_layers",
                                                   "pack_rows")):
    """The extraction's kernels once per grid version at least (and the
    other route's never), C, D and the rounds once a scan."""
    other = {"segment_layers", "pack_rows", "compact_channels"}
    other -= set(extraction)
    assert len({la[k] for k in extraction}) == 1, la
    assert la[extraction[0]] >= run["updates"], la
    assert not any(la[k] for k in other), la
    for k in ("segment_min", "window_replay", "window_rounds"):
        assert la[k] == run["n_scans"], (k, la)


def assert_map(node, cells=CELLS):
    occ, _ = node.publish_map()
    assert occ.data.shape == (cells, cells)
    assert int((occ.data == 100).sum()) > 1000
    assert int((occ.data == 0).sum()) > 10000


def path_icp(dev):
    gts, scans = room_scans(DOUBLE_LASER, SCANS["icp"])
    node, run = checked_run(dev, DOUBLE_LASER, gts, scans)
    assert all(loc.params.fast_raycast for loc in node.localizers)
    assert_rendering_launches(run["launches"], run)
    assert run["assign"].pairs > 0
    for f in FIELDS:
        assert getattr(node.grid, f).device.type == dev.type, f
    assert_map(node)
    return node, run


def path_narrow(dev):
    gts, scans = room_scans(NARROW, SCANS["narrow"], scene=narrow_world)
    node, run = checked_run(dev, NARROW, gts, scans)
    assert not rf.fused_extraction(node.grid)
    assert run["launches"]["compact_channels"] == run["updates"]
    assert_rendering_launches(run["launches"], run, ("compact_channels",))
    # the render on that grid, every kernel against its twin
    check, res, exact = checked_render(node.grid, node.localizers[0])
    assert check.stats["compact_channels"]["calls"] == 1, check.stats
    assert check.stats["segment_layers"]["calls"] == 0, check.stats
    assert_agrees(res, exact)
    return node, run


def ransac_run(dev, mode, n, seed=0):
    flat = {**SINGLE_LASER, "registration_mode": int(mode)}
    gts, scans = room_scans(flat, SCANS["tsd"])
    node, run = checked_run(dev, flat, [gts[0][:n]], [scans[0][:n]], seed)
    p = node.localizers[0].params
    assert p.mode == int(mode) and p.fast_raycast
    assert p.ransac.trials == SINGLE_LASER["trials"]
    assert p.ransac.size_control_set == SINGLE_LASER["sizeControlSet"]
    assert_rendering_launches(run["launches"], run)
    return node, run


def path_tsd(dev):
    node, run = ransac_run(dev, RegMode.TSD, SCANS["tsd"])
    assert_map(node)
    _, again = ransac_run(dev, RegMode.TSD, SCANS["tsd"])
    assert bits_equal(run["trace"], again["trace"]), \
        "TSD mode: the same seed gave another pose trace"
    ransac_run(dev, RegMode.TSD, SCANS["other"], seed=1)
    return node, run


def path_exp(dev):
    """Mode EXP: its nearest-model-point search one kernel launch a scan
    (no other path launches it)."""
    node, run = ransac_run(dev, RegMode.EXP, SCANS["other"] + 1)
    assert run["launches"]["nearest_model"] == run["n_scans"], \
        run["launches"]
    return node, run


def path_pdf(dev):
    return ransac_run(dev, RegMode.PDF, SCANS["other"] + 1)


def path_gn(dev):
    """Mode GN: Gauss-Newton renders nothing and the node extracts no
    segments for it, so the push is the path's only kernel.  The robot
    drives straight: GN's basin is the truncation band, and on the other
    paths' turning trajectory GN loses track in both packages
    (tools/gn_trajectory.py)."""
    flat = {**SINGLE_LASER, "registration_mode": 4}
    gts, scans = room_scans(flat, SCANS["gn"], turn_deg=0.0)
    node, run = checked_run(dev, flat, gts, scans)
    assert node.localizers[0].params.gn.iterations == 30
    assert node._segments is None
    assert not any(v for k, v in run["launches"].items() if k != "push")
    return node, run


def path_amcl(dev):
    """Mode AMCL (512 particles, 8 iterations), then a scan taken KIDNAP
    away from the last pose while the estimate stays: the node must
    relocalize within 3 cells.  Twice from one seed: the same traces."""
    gts, scans = room_scans(AMCL, SCANS["amcl"])
    x, y, th = gts[0][-1]
    kid = (x + KIDNAP[0], y + KIDNAP[1], th)
    kid_scan = scan_msg(scan_ranges(kid, 30.0), 30.0, float(SCANS["amcl"]))
    traces = []
    for _ in range(2):
        node, run = checked_run(dev, AMCL, gts, scans, seed=7)
        p = node.localizers[0].params.amcl
        assert (p.particles, p.iterations, p.size_control_set) == (512, 8,
                                                                   140), p
        assert_rendering_launches(run["launches"], run)
        tc.reset_counts()
        with eager_step():
            out = node.process_scan(0, kid_scan)
        counts = tc.read_counts()
        pose = node.localizers[0].pose.cpu()
        assert out is not None and not out.is_nan
        assert math.hypot(float(pose[0, 2]) - kid[0],
                          float(pose[1, 2]) - kid[1]) < 3 * 0.025
        assert counts["segment_min"] == counts["window_replay"] == 1, counts
        traces.append(torch.cat([run["trace"], pose[None]]))
    assert bits_equal(traces[0], traces[1]), \
        "AMCL mode: the same seed gave another pose trace"
    return node, run


def path_odom(dev):
    """ICP mode with the odometry rescue, odometry fed through
    SlamNode.on_odometry before every scan (the truth in the start's
    frame).  Scan JUMP_SCAN is taken 0.35 m off the path: the rescue must
    replace that match, and only that one, and the node keep tracking."""
    flat = {**SINGLE_LASER, "registration_mode": 0, "use_odom_rescue": True}
    cfg = from_flat_params(flat)
    half = cfg.grid.size_meters * 0.5
    gt = trajectory((half, half, 0.0), SCANS["odom"])
    flags, errs = [], []
    check = odometry.check

    def counted(*args):
        T, rescued = check(*args)
        flags.append(rescued)
        return T, rescued

    with eager_step(), patched((odometry, "check", counted)):
        node = SlamNode(cfg, dtype=torch.float32, device=dev)
        node.mapper._push_fn = PushCheck()
        tc.reset_counts()
        for k, (x, y, th) in enumerate(gt):
            node.on_odometry(0, x - half, y - half, th, stamp=0.1 * k)
            seen = (x + 0.35, y, th) if k == JUMP_SCAN else (x, y, th)
            out = node.process_scan(0, scan_msg(scan_ranges(seen, 30.0),
                                                30.0, 0.1 * k))
            if k:
                assert out is not None and not out.is_nan, k
                pose = node.localizers[0].pose
                errs.append(math.hypot(float(pose[0, 2]) - x,
                                       float(pose[1, 2]) - y))
        torch.cuda.synchronize()
        node.mapper._push_fn = push_cuda
    launches = tc.read_counts()
    assert node.localizers[0].params.odom is not None
    rescued = [k + 1 for k, f in enumerate(flags) if bool(f)]
    assert len(flags) == SCANS["odom"] - 1 and rescued == [JUMP_SCAN], rescued
    assert max(errs) < 2.5 * cfg.grid.cellsize, errs
    assert launches["segment_min"] == SCANS["odom"] - 1, launches
    return node, {"launches": launches, "errs": [errs]}


def site_rooms() -> list:
    """The offsets (m) that carry world()'s room onto its copies on the
    site's 4096^2 grid, nearest the grid's centre first: the middle copy,
    where the robots start, carries world()'s 25.6 m grid's centre onto
    the site's.  Each room is closed by its walls, so a scan taken inside
    a copy is world()'s scan from the pose less the offset."""
    c = (SITE_CELLS - CELLS) * 0.025 * 0.5
    nx, ny = SITE_ROOMS
    out = [(c + SITE_PITCH[0] * (i - nx // 2),
            c + SITE_PITCH[1] * (j - ny // 2))
           for j in range(ny) for i in range(nx)]
    return sorted(out, key=lambda o: math.hypot(o[0] - c, o[1] - c))


class SitePush:
    """PushCheck with the plain push on the same inputs: the two grids
    equal in every cell of tsd, weight and the tile flags (NaN where the
    other is NaN)."""

    def __init__(self):
        self.check, self.calls = PushCheck(), 0

    def __call__(self, grid, geom, pose, data, mask):
        out = self.check(grid, geom, pose, data, mask)
        ref = push(grid, geom, pose, data, mask)
        for f in FIELDS:
            a, b = getattr(out, f), getattr(ref, f)
            same = a == b
            if a.is_floating_point():
                same |= torch.isnan(a) & torch.isnan(b)
            assert bool(same.all()), (f, self.calls)
        self.calls += 1
        return out


def path_site(dev):
    """The double laser at map_size 12 (slambench's double-laser-site:
    segment capacity 16 x MAX_SEGMENTS, the reach cull before kernel C):
    world()'s room copied over the grid, every copy but the middle one
    mapped first by a push of the ICP path's first scan from its own
    start, then the ICP path's first scans a robot carried into the middle
    copy.  Every caster kernel call (A, B, C, D, the rounds and the cull's
    E) by KernelCheck standing in for cuda_kernels, every push by
    SitePush; the launch counts from this path alone."""
    cfg = from_flat_params(SITE)
    gts0, scans0 = room_scans(DOUBLE_LASER, SCANS["site"])
    rooms = site_rooms()
    cx, cy = rooms[0]
    gts = [[(x + cx, y + cy, t) for x, y, t in gt] for gt in gts0]
    geom = tc.geom_1081(cfg.robots[0].sensor.max_range)
    check, site_push, on_cuda = KernelCheck(), SitePush(), []
    with eager_step():
        node = SlamNode(cfg, dtype=torch.float32, device=dev)
        assert node.grid.tsd.shape == (SITE_CELLS, SITE_CELLS)
        assert rf.segment_capacity(node.grid) == 16 * rf.MAX_SEGMENTS
        assert all(rf.reach_cull_pays(node.grid,
                                      tc.geom_1081(rc.sensor.max_range))
                   for rc in cfg.robots)
        data, mask = standard_mask(geom, torch.as_tensor(
            scans0[0][0], dtype=torch.float32, device=dev))
        node.mapper._push_fn = site_push
        with patched(*watch_plain(on_cuda),
                     (rf, "cuda_kernels", lambda: check.kernels)):
            tc.reset_counts()
            x0, y0, t0 = gts0[0][0]
            for dx, dy in rooms[1:]:
                node.grid = site_push(node.grid, geom, se2.make(
                    x0 + dx, y0 + dy, t0, device=dev), data, mask)
            seeded = site_push.calls
            run = drive(node, cfg, gts, scans0)
            assert_map(node, SITE_CELLS)
            torch.cuda.synchronize()
            launches = tc.read_counts()
        node.mapper._push_fn = push_cuda
    seg = node._segments
    kept = [found["segments"] for name, _, found in check.log
            if name == "compact_channels"]
    assert max(max(e) for e in run["errs"]) < 2.5 * cfg.grid.cellsize
    assert int(seg.count) > rf.MAX_SEGMENTS and int(seg.n_dropped) == 0
    assert seg.pack.shape[1] == rf.segment_capacity(node.grid)
    assert 0 < min(kept) and max(kept) < int(seg.count), kept
    for name, st in check.stats.items():
        assert st["calls"] > 0 and st["max_abs_err"] == 0.0, (name, st)
    assert launches["push"] == site_push.calls > seeded, launches
    assert launches["segment_layers"] == launches["pack_rows"] \
        >= run["updates"], launches
    for name in ("compact_channels", "segment_min", "window_replay",
                 "window_rounds"):
        assert launches[name] == run["n_scans"], (name, launches)
    assert not on_cuda, on_cuda
    run["launches"] = launches
    return node, run


PATHS = {"icp": path_icp, "narrow": path_narrow, "tsd": path_tsd,
         "exp": path_exp, "pdf": path_pdf, "gn": path_gn, "amcl": path_amcl,
         "odom": path_odom, "site": path_site}
_RUNS: dict = {}


def run_path(name, dev):
    """The path's node and run, driven once a process."""
    if name not in _RUNS:
        _RUNS[name] = PATHS[name](dev)
    return _RUNS[name]


def host_syncs(fn) -> int:
    """The synchronising CUDA operations fn() makes."""
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
def no_host_sync():
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def xyt_of(pose) -> tuple:
    p = pose.cpu()
    return (float(p[0, 2]), float(p[1, 2]),
            math.atan2(float(p[1, 0]), float(p[0, 0])))


def step_call(node, fn, scene=world):
    """fn (localize_step or its compiled entry point) on robot 0's last
    state and a scan from its pose, as the node calls it."""
    loc = node.localizers[0]
    data, mask = node._preprocess(loc, scan_ranges(
        xyt_of(loc.pose), loc.geom.max_range, scene))
    gn = loc.params.mode == int(RegMode.GN)
    seg = None if gn else node._segments_for(node.grid)
    return lambda: fn(node.grid, loc.pose.contiguous(), loc.last_pose, data,
                      mask, loc.params, generator=node._draws(0, 1000),
                      segments=seg)


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(PATHS))
def test_path_holds_every_kernel_to_its_twin(cuda_device, path):
    node, _ = run_path(path, cuda_device)
    if path in ("odom", "site"):
        return
    # the eager step reads the card once (the overflow guard's drop count;
    # GN renders nothing and reads nothing), its graph never; the
    # extraction and the push queue their work without a read
    scene = narrow_world if path == "narrow" else world
    eager = step_call(node, localize.localize_step, scene)
    eager()                                    # the process's first
    assert host_syncs(eager) == (0 if path == "gn" else 1), path
    replay = step_call(node, localize.localize_step_jit, scene)
    replay()                                   # the capture
    loc = node.localizers[0]
    pose = loc.pose.contiguous()
    scan = node._preprocess(loc, scan_ranges(xyt_of(pose),
                                             loc.geom.max_range, scene))
    with no_host_sync():
        replay()
        rf.extract_segments(node.grid)
        push_cuda(node.grid, loc.geom, pose, *scan)


def traced_launches(fn) -> tuple:
    """fn() in a profiler session of the benchmark's
    (slambench/tracing.py::session): the device launches of each kernel by
    its name in csrc/*.cu, those inside graph replays included, or None
    where the trace shows no device activity; and fn's result."""
    from slambench.tracing import session

    out = []
    device = session(lambda mark: out.append(fn())).device
    patterns = {k: re.compile(rf"(?<!\w){sym}(?!\w)")
                for k, (_, _, sym) in tc.WRAPPERS.items()}
    counts = dict.fromkeys(patterns, 0)
    for name, _, _ in device:
        k = next((k for k, p in patterns.items() if p.search(name)), None)
        if k is not None:
            counts[k] += 1
    return (counts if device else None), out[0]


@pytest.mark.cuda
@pytest.mark.parametrize("path,flat", [("icp", DOUBLE_LASER),
                                       ("narrow", NARROW),
                                       ("tsd", SINGLE_LASER)])
def test_compiled_path_launches_from_a_trace(cuda_device, path, flat):
    """The path again through SlamNode on the compiled step, under
    torch.profiler, TRACE_SCANS scan indices a session: its pose trace
    equals the eager path's in every bit, and each kernel's device
    launches read from the trace by name equal the eager path's plus, for
    C, D and the rounds, each localizer's priming replay and each new
    capture's warm-up of the step, and for the extraction's kernels each
    new capture's warm-up of the extraction."""
    _, ref = run_path(path, cuda_device)
    cfg = from_flat_params(flat)
    node = SlamNode(cfg, dtype=torch.float32, device=cuda_device)
    graphs = {"localize_step_jit": localize.localize_step_jit.compiled,
              "extract_segments_jit": rf.extract_segments_jit.compiled}
    captures = {k: g.captures for k, g in graphs.items()}
    found, traces = {}, []
    n = len(ref["gts"][0])
    for k0 in range(0, n, TRACE_SCANS):
        part, run = traced_launches(lambda k0=k0: drive(
            node, cfg, ref["gts"], ref["scans"],
            range(k0, min(n, k0 + TRACE_SCANS))))
        traces.append(run["trace"])
        found = None if part is None or found is None else {
            k: found.get(k, 0) + v for k, v in part.items()}
    new = {k: g.captures - captures[k] for k, g in graphs.items()}
    assert bits_equal(torch.cat(traces), ref["trace"]), path
    if found is None:
        pytest.skip("the profiler shows no device activity on this card")
    want = dict(ref["launches"])
    for k in ("segment_min", "window_replay", "window_rounds"):
        want[k] += len(cfg.robots) + new["localize_step_jit"]
    for k in ("segment_layers", "pack_rows", "compact_channels"):
        if want[k]:
            want[k] += new["extract_segments_jit"]
    assert found == want, (path, found, want, new)


def overflow_capacity(dev, cfg, scans) -> int:
    """The least multiple of 128 above the segments of the grid the ICP
    path starts from: the first scans fit and, as the map grows, the
    later ones overflow."""
    with eager_step():
        node = SlamNode(cfg, dtype=torch.float32, device=dev)
        node.process_scan(0, scan_msg(scans[0][0],
                                      cfg.robots[0].sensor.max_range, 0.0))
    return 128 * (int(rf.extract_segments(node.grid).count) // 128 + 1)


@contextlib.contextmanager
def count_host_reads(reads: list):
    """Inside, every read of a CUDA tensor's values by the host appends
    its method's name to `reads`."""
    names = ("tolist", "cpu", "item", "__bool__", "__int__", "__float__")

    def counted(name, orig):
        def read(self, *args, **kwargs):
            if self.is_cuda:
                reads.append(name)
            return orig(self, *args, **kwargs)
        return read

    with patched(*((torch.Tensor, name, counted(name, getattr(
            torch.Tensor, name))) for name in names)):
        yield


def overflowing_entry_points(node, gt):
    """raycast_checked_jit and render_ranges_jit on the node's grid, its
    cache extracted at a capacity it overflows, from poses of robot 0's
    path: each call equal to the eager call in every bit (the render's
    ranges, hits and both gradients included), the caster's result to the
    exact march's but for the drop count."""
    from ohm_tsd_slam_tpu_torch.grid.render import (
        render_ranges,
        render_ranges_jit,
    )

    loc = node.localizers[0]
    grid, geom, dev = node.grid, loc.geom, node.grid.tsd.device
    seg = node._segments_for(grid)
    assert int(seg.n_dropped) > 0
    tsd = grid.tsd.clone().requires_grad_(True)
    leaf = dataclasses.replace(grid, tsd=tsd)
    with torch.no_grad():
        leaf_seg = rf.extract_segments(leaf)
    w = torch.linspace(0.5, 1.5, geom.size, device=dev)
    for xyt in gt[1::6]:
        pose = se2.make(*xyt, device=dev)
        got = rf.raycast_checked_jit(grid, geom, pose, segments=seg)
        want = rf.raycast_checked(grid, geom, pose, segments=seg)
        exact = raycast(grid, geom, pose)._replace(n_dropped=got.n_dropped)
        assert int(got.n_dropped) > 0
        for a, b, c in zip(got, want, exact):
            assert bits_equal(a, b) and bits_equal(a, c)
        grads = []
        for fn in (render_ranges_jit, render_ranges):
            x = torch.tensor(xyt, device=dev, requires_grad=True)
            tsd.grad = None
            r_, hit, res = fn(leaf, geom, se2.make(x[0], x[1], x[2],
                                                   device=dev),
                              segments=leaf_seg)
            (w * r_).sum().backward()
            grads.append((r_.detach(), hit, x.grad, tsd.grad, res.n_dropped))
        assert int(grads[0][4]) > 0
        for a, b in zip(*grads):
            assert bits_equal(a, b)


@pytest.mark.cuda
def test_overflow_and_entry_point_launches_from_a_trace(cuda_device):
    """The ICP path (SCANS["overflow"] scans a robot) on the node as it is
    with raycast_fast.MAX_SEGMENTS forced just above the first grid's
    segments: the first scans fit, the later ones overflow.  The node
    reads the card twice a scan (the gate flags with the drop count, then
    the pose), runs no eager step, and launches C, D and the rounds once
    a call of the step (the fast caster on every scan, the exact march in
    the IF node on those that overflow), its graphs captured before; its
    grid's entry points as overflowing_entry_points holds them.  Then
    ENTRY_CALLS calls each of raycast_checked_jit, push_jit,
    push_tree_jit and render_ranges_jit (forward and backward) on the ICP
    path's grid, their graphs dropped first: C, D and the rounds once a
    render and the push once a push, plus a warm-up a capture."""
    from ohm_tsd_slam_tpu_torch.grid.push import push_jit, push_tree_jit
    from ohm_tsd_slam_tpu_torch.grid.render import render_ranges_jit

    cfg = from_flat_params(DOUBLE_LASER)
    gts, scans = room_scans(DOUBLE_LASER, SCANS["overflow"])
    cap = overflow_capacity(cuda_device, cfg, scans)
    step = localize.localize_step_jit.compiled
    eager, reads, dropped = [], [], []
    eager_step_fn = localize.localize_step

    def counted(*args, **kwargs):
        eager.append(1)
        return eager_step_fn(*args, **kwargs)

    def around(call):
        got = []
        with count_host_reads(got):
            result = call()
        reads.append(got)
        return result

    with patched((rf, "MAX_SEGMENTS", cap)):
        # each robot's step captured at this capacity first: a capture's
        # warm-up runs the eager step
        primer = SlamNode(cfg, dtype=torch.float32, device=cuda_device)
        for r, rc in enumerate(cfg.robots):
            primer.process_scan(r, scan_msg(scans[r][0],
                                            rc.sensor.max_range, 0.0))
        node = SlamNode(cfg, dtype=torch.float32, device=cuda_device)
        captures = step.captures
        with patched((localize, "localize_step", counted)):
            found, run = traced_launches(lambda: drive(
                node, cfg, gts, scans, dropped=dropped, around=around))
            assert step.captures == captures
        overflowing_entry_points(node, gts[0])
    assert not eager
    assert all(r == ["tolist", "cpu"] for r in reads), reads
    assert any(d > 0 for d in dropped) and any(d == 0 for d in dropped)
    for r, e in enumerate(run["errs"]):
        assert max(e) < 2.5 * cfg.grid.cellsize, (r, max(e))
    calls = run["n_scans"] + len(cfg.robots)
    if found is not None:
        for k in ("segment_min", "window_replay", "window_rounds"):
            assert found[k] == calls, (k, found, calls)

    icp_node, _ = run_path("icp", cuda_device)
    loc = icp_node.localizers[0]
    grid, geom = icp_node.grid, loc.geom
    seg = icp_node._segments_for(grid)
    xyts = [gts[0][k] for k in range(1, 1 + 3 * ENTRY_CALLS, 3)]
    poses = [se2.make(*xyt, device=cuda_device) for xyt in xyts]
    pushes = [icp_node._preprocess(loc, scan_ranges(xyt, geom.max_range))
              for xyt in xyts]
    w = torch.linspace(0.5, 1.5, geom.size, device=cuda_device)
    tsd = grid.tsd.clone().requires_grad_(True)
    leaf = dataclasses.replace(grid, tsd=tsd)
    with torch.no_grad():
        leaf_seg = rf.extract_segments(leaf)

    def render(i):
        x = torch.tensor(xyts[i], device=cuda_device, requires_grad=True)
        r_, _, _ = render_ranges_jit(leaf, geom, se2.make(
            x[0], x[1], x[2], device=cuda_device), segments=leaf_seg)
        (w * r_).sum().backward()

    graphs = {"raycast_checked_jit": rf.raycast_checked_jit.compiled,
              "push_jit": push_jit.compiled,
              "push_tree_jit": push_tree_jit.compiled,
              "render_forward": render_ranges_jit.compiled[0]}
    for g in (*graphs.values(), render_ranges_jit.compiled[1]):
        g.clear_cache()
    captures = {k: g.captures for k, g in graphs.items()}

    def entries():
        for i, pose in enumerate(poses):
            rf.raycast_checked_jit(grid, geom, pose, segments=seg)
            push_jit(grid, geom, pose, *pushes[i])
            push_tree_jit(grid, geom, pose, *pushes[i])
            render(i)

    found, _ = traced_launches(entries)
    new = {k: g.captures - captures[k] for k, g in graphs.items()}
    assert new["raycast_checked_jit"] >= 1 and new["push_jit"] >= 1
    if found is None:
        pytest.skip("the profiler shows no device activity on this card")
    n = len(poses)
    renders = 2 * n + new["raycast_checked_jit"] + new["render_forward"]
    for k in ("segment_min", "window_replay", "window_rounds"):
        assert found[k] == renders, (k, found, renders)
    assert found["push"] == 2 * n + new["push_jit"] + new["push_tree_jit"]


@pytest.mark.cuda
def test_icp_histories_on_the_path_calls(cuda_device):
    """ICP_RECORD_SCANS of the ICP path's icp calls, spread over the path,
    run again on their own arguments with IcpParams.record_pairs and
    record_T off, then on (with no host sync): every output the two share
    equal in every bit, to each other and to the path's own call;
    T_history at the last iteration is T; each iteration's recorded mask
    sums to its pair count."""
    _, run = run_path("icp", cuda_device)
    calls = run["icp_calls"]
    assert len(calls) >= ICP_RECORD_SCANS, len(calls)
    for args, kwargs, path_res in calls[::len(calls) // ICP_RECORD_SCANS][
            :ICP_RECORD_SCANS]:
        scene, params = args[2], args[4]
        assert not (params.record_pairs or params.record_T), params
        assert params.iterations == 25 and scene.shape == (BEAMS, 2)
        assert scene.dtype == torch.float32
        off = icp_mod.icp(*args, **kwargs)
        with no_host_sync():
            on = icp_mod.icp(*args[:4], dataclasses.replace(
                params, record_pairs=True, record_T=True), **kwargs)
        assert off.T_history is off.pair_idx_history is None
        assert off.pair_mask_history is None
        for f in ("T", "rms", "pairs", "iterations", "state", "rms_history",
                  "pair_history"):
            assert bits_equal(getattr(off, f), getattr(on, f)), f
            assert bits_equal(getattr(off, f), getattr(path_res, f)), f
        n = int(on.iterations)
        assert 0 < n <= params.iterations
        assert tuple(on.pair_idx_history.shape) == (25, BEAMS)
        assert tuple(on.pair_mask_history.shape) == (25, BEAMS)
        assert tuple(on.T_history.shape) == (25, 3, 3)
        assert on.pair_idx_history.dtype == torch.int32
        assert bits_equal(on.T_history[n - 1], on.T)
        assert torch.equal(on.pair_mask_history.sum(1), on.pair_history)


@pytest.mark.cuda
def test_icp_replay_kernels_and_result(cuda_device):
    """One of the ICP path's icp calls as icp_jit replays of 1 and of 25
    iterations: the device operations of a replay, read from a profiler
    trace (the copy-in, the graph's nodes, the clones of the outputs),
    grow by at most ICP_KERNELS_PER_ITERATION an iteration, and the
    25-iteration replay's IcpResult equals the eager call's in every
    bit."""
    from slambench.tracing import session

    _, run = run_path("icp", cuda_device)
    args, kwargs, _ = run["icp_calls"][len(run["icp_calls"]) // 2]
    params = args[4]
    assert params.iterations == 25 and params.estimator == "closed_form"
    assert params.bounds is not None and params.use_reciprocal_filter
    ops, res = {}, None
    for n in (1, params.iterations):
        p = dataclasses.replace(params, iterations=n)
        call = lambda: icp_mod.icp_jit(*args[:4], p, **kwargs)  # noqa: E731
        call()                                 # the capture
        res = call()
        ops[n] = len(session(lambda mark: call()).device)
    if not ops[1]:
        pytest.skip("the profiler shows no device activity on this card")
    per_iteration = (ops[params.iterations] - ops[1]) / (params.iterations
                                                         - 1)
    assert per_iteration <= ICP_KERNELS_PER_ITERATION, (ops, per_iteration)
    eager = icp_mod.icp(*args, **kwargs)
    for f in ("T", "rms", "pairs", "iterations", "state", "rms_history",
              "pair_history"):
        assert bits_equal(getattr(res, f), getattr(eager, f)), f


def checked_render(grid, loc):
    """Extraction and one render from the localizer's pose on the kernel
    path, every kernel call held against its twin; returns (check,
    result, exact-march result)."""
    check = KernelCheck()
    seg = rf.extract_segments(grid, kernels=check.kernels)
    pose = se2.make(*xyt_of(loc.pose), device=grid.tsd.device)
    res = rf.raycast_fast(grid, loc.geom, pose, segments=seg,
                          kernels=check.kernels)
    exact = raycast(grid, loc.geom, pose)
    torch.cuda.synchronize()
    return check, res, exact


def assert_agrees(res, exact):
    """tests/test_raycast_fast.py's bound: 98% of beams agree."""
    both = res.mask & exact.mask
    gap = (res.coords[both] - exact.coords[both]).abs()
    assert int(res.n_dropped) == 0
    assert float((res.mask == exact.mask).float().mean()) > 0.98
    assert not gap.numel() or float(gap.max()) < 1e-3
    assert int(res.mask.sum()) > 500


@pytest.mark.cuda
def test_caster_on_the_path_grid(cuda_device):
    """The caster's kernels against their twins on the grid the ICP path
    built, from each robot's last pose, the result against the exact
    march; kernel E on that grid's layer stack (4 Mi lanes, the full
    capacity) against its twin and against the pack of kernels A + B."""
    node, _ = run_path("icp", cuda_device)
    for loc in node.localizers:
        check, res, exact = checked_render(node.grid, loc)
        assert_agrees(res, exact)
        for name in ("segment_layers", "pack_rows", "segment_min",
                     "window_replay", "window_rounds"):
            assert check.stats[name]["calls"] == 1, (name, check.stats)
    check = KernelCheck()
    S = rf.MAX_SEGMENTS
    general, n_g = rf._pack_general(node.grid, S, check.kernels)
    fused, n_f = rf._pack_fused(node.grid, S, rf.cuda_kernels())
    torch.cuda.synchronize()
    assert check.stats["compact_channels"]["calls"] == 1
    assert int(n_g) == int(n_f) > 1000
    assert bit_mismatch(general, fused) <= POS_TOL


@pytest.mark.cuda
def test_row_blocks_of_the_path_grid(cuda_device):
    """Kernels A and B on row blocks of the ICP path's grid of the heights
    a block with its halo row has at 1024 rows (257 at sp = 4, 513 at
    sp = 2), at three offsets, against their twins."""
    node, _ = run_path("icp", cuda_device)
    for y0, rows in ((0, 257), (384, 257), (511, 513)):
        check = KernelCheck()
        block = dataclasses.replace(
            node.grid, tsd=node.grid.tsd[y0:y0 + rows].contiguous())
        rf.extract_endpoints(block, 8192, check.kernels)
        torch.cuda.synchronize()
        assert check.stats["pack_rows"]["calls"] == 1, check.stats
        assert check.stats["segment_layers"]["calls"] == 1, check.stats


@pytest.mark.cuda
def test_pose_batch_on_the_path_grid(cuda_device):
    """raycast_fast_batch at P = 128 on the ICP path's grid from robot 0's
    last pose (the rounds a cooperative launch: 138,368 beams): C, D and
    the rounds once each, equal to their twins, every pose's rows equal to
    its own raycast_fast in every bit; then the rounds with BATCH_CAP
    replays a round on the batch's state: the same drops as the twin."""
    from ohm_tsd_slam_tpu_torch.ops.window_replay_cuda import (
        window_rounds_blocks,
    )

    node, _ = run_path("icp", cuda_device)
    loc = node.localizers[0]
    grid, geom, pose = node.grid, loc.geom, loc.pose.contiguous()
    poses = torch.stack([pose @ se2.make(d, -d, 2.0 * d, device=pose.device)
                         for d in np.linspace(-0.05, 0.05, N_POSES).tolist()])
    seg = node._segments_for(grid)
    check, grabbed = KernelCheck(), []

    def grab(grid_, S, *rest):
        grabbed[:] = [grid_, S.clone(), *rest]
        return check.kernels.window_rounds(grid_, S, *rest)

    tc.reset_counts()
    batch = rf.raycast_fast_batch(grid, geom, poses, segments=seg,
                                  kernels=check.kernels._replace(
                                      window_rounds=grab))
    torch.cuda.synchronize()
    la = tc.read_counts()
    assert window_rounds_blocks(N_POSES * geom.size) > 1
    assert int(batch.n_dropped) == 0
    for name in ("segment_min", "window_replay", "window_rounds"):
        assert la[name] == 1, la
        assert check.stats[name] == {"calls": 1, "max_abs_err": 0.0}, name
    assert la["segment_layers"] == la["pack_rows"] == 0, la
    for p in range(N_POSES):
        single = rf.raycast_fast(grid, geom, poses[p], segments=seg)
        for name in ("coords", "normals", "mask", "ranges"):
            assert torch.equal(getattr(batch, name)[p],
                               getattr(single, name)), (p, name)
    check = KernelCheck()
    g_, S, lev, *beams, _ = grabbed
    check.kernels.window_rounds(g_, S.clone(), lev, *beams, BATCH_CAP)
    torch.cuda.synchronize()
    ((_, _, forced),) = check.log
    assert forced["dropped"] > 0 and forced["finite"][0] > BATCH_CAP, forced
    assert check.stats["window_rounds"] == {"calls": 1, "max_abs_err": 0.0}


@pytest.mark.cuda
def test_render_on_the_path_grid(cuda_device):
    """render_ranges on the ICP path's grid from robot 0's pose: C, D and
    the rounds once a forward, A and B once without a segment cache and
    never with one; the unrefined forward is raycast_checked's ranges; the
    pose and cell gradients of a weighted sum against the CPU port's on a
    copy of the grid within RENDER_TOL of the largest magnitude (the card
    adds the cell cotangent's taps in no fixed order).  At most HIT_FLIPS
    of the beams may hit on one device only (the ray directions differ in
    the last bit); the sum weighs those 0."""
    from ohm_tsd_slam_tpu_torch.grid.render import render_ranges

    node, _ = run_path("icp", cuda_device)
    loc = node.localizers[0]
    grid, geom = node.grid, loc.geom
    xyt = xyt_of(loc.pose)
    pose = se2.make(*xyt, device=cuda_device)
    seg = node._segments_for(grid)
    for cached, kwargs in ((True, dict(segments=seg)), (False, {})):
        tc.reset_counts()
        _, hit, res = render_ranges(grid, geom, pose, **kwargs)
        torch.cuda.synchronize()
        la = tc.read_counts()
        assert la["segment_min"] == la["window_replay"] == 1, la
        assert la["window_rounds"] == 1, la
        assert la["segment_layers"] == la["pack_rows"] == int(not cached)
        assert int(res.n_dropped) == 0 and int(hit.sum()) > 500
    raw = render_ranges(grid, geom, pose, refine=False, segments=seg)[0]
    assert torch.equal(raw, rf.raycast_checked(grid, geom, pose,
                                               segments=seg).ranges)
    w = torch.from_numpy(np.random.default_rng(5).normal(
        size=geom.size).astype(np.float32))
    cpu_grid = from_arrays(to_arrays(grid), device="cpu")
    flips = render_ranges(cpu_grid, geom, pose.cpu())[1] != hit.cpu()
    assert int(flips.sum()) <= HIT_FLIPS * geom.size
    w[flips] = 0.0

    def grads(g):
        dev = g.tsd.device
        x = torch.tensor(xyt, dtype=torch.float32, device=dev,
                         requires_grad=True)
        tsd = g.tsd.clone().requires_grad_(True)
        r, _, _ = render_ranges(dataclasses.replace(g, tsd=tsd), geom,
                                se2.make(x[0], x[1], x[2], device=dev))
        (w.to(dev) * r).sum().backward()
        return x.grad.cpu(), tsd.grad.cpu()

    gp, gc = grads(grid)
    cp, cc = grads(cpu_grid)
    assert float((gp - cp).abs().max()) <= RENDER_TOL * float(
        cp.abs().max())
    assert float((gc - cc).abs().max()) <= RENDER_TOL * float(
        cc.abs().max())
    assert int((gc != 0).sum()) > 1000


@pytest.mark.cuda
def test_twinpoint_and_multi_init_match_the_cpu(cuda_device):
    """match_twinpoint and icp_multi_init on the TSD path's model and a
    scene from near its pose, with draws given (TwinInject from numpy,
    seed 4), against the CPU port on the same inputs in float32: the
    transforms within TWIN_TOL, the same winning seed.  TwinPoint runs
    TWIN_TRIALS of the yaml's trials."""
    from ohm_tsd_slam_tpu_torch.registration.multi_init import (
        icp_multi_init,
    )
    from ohm_tsd_slam_tpu_torch.registration.twinpoint import (
        TwinInject,
        match_twinpoint,
    )
    from ohm_tsd_slam_tpu_torch.sensor.polar2d import data_to_cartesian

    node, _ = run_path("tsd", cuda_device)
    loc = node.localizers[0]
    grid, geom, pose = node.grid, loc.geom, loc.pose
    x, y, th = xyt_of(pose)
    data, mask = node._preprocess(loc, scan_ranges(
        (x + 0.03, y - 0.02, th + 0.01), geom.max_range))
    model = rf.raycast_fast(grid, geom, pose,
                            segments=node._segments_for(grid))
    scene, smask = data_to_cartesian(geom, data, mask)
    rp = dataclasses.replace(loc.params.ransac, trials=TWIN_TRIALS)
    rng = np.random.default_rng(4)
    res_deg = math.degrees(rp.resolution)
    min_d, max_d = max(1, int(3.0 / res_deg)), max(2, int(10.0 / res_deg))
    n_valid = int(model.mask.sum())
    trials = loc.params.ransac.trials
    rank1 = rng.integers(0, n_valid - 1 - min_d, trials)
    rank2 = rank1 + min_d + rng.integers(0, 1 << 30, trials) % np.maximum(
        np.minimum(n_valid - rank1 - 1, max_d) - min_d, 1)
    ctrl = rng.choice(np.nonzero(smask.cpu().numpy())[0],
                      rp.size_control_set, replace=False)
    arrays = [ctrl, np.ones(len(ctrl), bool), rank1[:TWIN_TRIALS],
              rank2[:TWIN_TRIALS], (rank2 < n_valid)[:TWIN_TRIALS]]
    clouds = (model.coords, model.mask, scene, smask)
    seeds = torch.stack([torch.eye(3), se2.make(0.05, -0.03, 0.02),
                         se2.make(1.5, -1.0, 0.8)])
    out = {}
    for where, dev in (("card", cuda_device), ("cpu", "cpu")):
        inject = TwinInject(*(torch.from_numpy(np.asarray(a)).to(dev)
                              for a in arrays))
        c = tuple(t.to(dev) for t in clouds)
        out[where] = (match_twinpoint(None, *c, rp, inject=inject).cpu(),
                      icp_multi_init(*c, seeds.to(dev), loc.params.icp,
                                     sensor_pose=pose.to(dev)))
    (twin, multi), (twin_c, multi_c) = out["card"], out["cpu"]
    assert float((twin - twin_c).abs().max()) <= TWIN_TOL
    assert not torch.equal(twin, torch.eye(3))
    assert int(multi.best_seed) == int(multi_c.best_seed)
    assert float((multi.T.cpu() - multi_c.T).abs().max()) <= TWIN_TOL


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


@pytest.mark.cuda
def test_push_tree_along_the_path(cuda_device):
    """push_tree along the ICP path's poses into a new grid, through the
    push kernel with branch_gate's tile gate (PushCheck on every launch:
    its cull against tile_cull & gate), one launch a push; every grid
    equal in every bit to the ungated kernel's from the grid before it,
    and within compare_push of the plain push with the gate.  The pruning
    case (map_size 9, a 0.5 m sensor at the centre) prunes tiles and still
    equals the ungated push.  A seeded random gate (60% open) closes
    touched tiles on a new grid, on the path's grid and on a row block of
    it (ty0): closed tiles copied through, open ones equal to the ungated
    launch in every bit, the tsd within PUSH_TOL of the gated plain
    push."""
    from ohm_tsd_slam_tpu_torch.grid import dispatch, push_tree
    from ohm_tsd_slam_tpu_torch.grid.push import branch_gate
    from ohm_tsd_slam_tpu_torch.sensor.polar2d import SensorPolar2D

    dev = cuda_device
    node, run = run_path("icp", dev)
    cfg = from_flat_params(DOUBLE_LASER)
    scans = []
    for k in range(SCANS["icp"]):
        for r, rc in enumerate(cfg.robots):
            geom = tc.geom_1081(rc.sensor.max_range)
            scans.append((geom, se2.make(*run["gts"][r][k], device=dev),
                          *standard_mask(geom, torch.as_tensor(
                              run["scans"][r][k], dtype=torch.float32,
                              device=dev))))
    check = PushCheck()

    def tree_run(grid, scans):
        grids = []
        tc.reset_counts()
        with patched((dispatch, "best_push", lambda g: check)):
            for geom, pose, data, mask in scans:
                grid = push_tree(grid, geom, pose, data, mask)
                grids.append(grid)
        torch.cuda.synchronize()
        return grids, tc.read_counts()

    grid0 = create(cfg.grid, dtype=torch.float32, device=dev)
    grids, counts = tree_run(grid0, scans)
    assert counts["push"] == check.stats["gated_calls"] == len(scans), counts
    assert not any(v for k, v in counts.items() if k != "push"), counts
    prev = grid0
    for (geom, pose, data, mask), got in zip(scans, grids):
        flat = push_cuda(prev, geom, pose, data, mask)
        for f in FIELDS:
            assert bits_equal(getattr(got, f), getattr(flat, f)), f
        tc.compare_push(push(prev, geom, pose, data, mask,
                             tile_gate=branch_gate(prev, geom, pose)), got)
        prev = got

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
    for f in FIELDS:
        assert bits_equal(getattr(tree9, f), getattr(flat9, f)), f
    assert counts9["push"] == 1 and int((~gate9).sum()) >= 1
    assert not bool(gate9[0, 0]) and int(tree9.tile_init.sum()) > 0

    loc = node.localizers[0]
    grid, geom, lpose = node.grid, loc.geom, loc.pose.contiguous()
    data, mask = node._preprocess(loc, scan_ranges(xyt_of(lpose),
                                                   geom.max_range))

    def random_gate(g, geom_, pose_, data_, mask_, seed, ty0=0):
        td = g.tile_dim
        gate = torch.as_tensor(np.random.default_rng(seed).random(
            (g.tiles_y, g.tiles_x)) < 0.6, device=dev)
        got = check(g, geom_, pose_, data_, mask_, tile_gate=gate, ty0=ty0)
        flat = push_cuda(g, geom_, pose_, data_, mask_, ty0=ty0)
        tc.compare_push(push(g, geom_, pose_, data_, mask_, tile_gate=gate,
                             ty0=ty0), got)
        cells = gate.repeat_interleave(td, 0).repeat_interleave(td, 1)
        for f in ("tsd", "weight"):
            a, b, c = getattr(got, f), getattr(flat, f), getattr(g, f)
            assert bits_equal(a[cells], b[cells]), f
            assert bits_equal(a[~cells], c[~cells]), f
        moved = (flat.tsd.view(torch.int32) != g.tsd.view(torch.int32)
                 ).reshape(g.tiles_y, td, g.tiles_x, td).any(3).any(1)
        assert int((moved & ~gate).sum()) > 0
        assert not bits_equal(got.tsd, flat.tsd)
        return got, flat

    got, flat = random_gate(grid0, *scans[0], seed=31)
    assert not torch.equal(got.tile_init, flat.tile_init)
    random_gate(grid, geom, lpose, data, mask, seed=32)
    td, q = grid.tile_dim, grid.tiles_y // 4
    block = dataclasses.replace(
        grid, tsd=grid.tsd[q * td:2 * q * td].clone(),
        weight=grid.weight[q * td:2 * q * td].clone(),
        tile_init=grid.tile_init[q:2 * q].clone(),
        tile_initw=grid.tile_initw[q:2 * q].clone())
    random_gate(block, geom, lpose, data, mask, seed=33, ty0=q)


@pytest.mark.cuda
def test_3d_functions_and_filters_match_the_cpu(cuda_device):
    """projective_pairs_3d and occlusion_filter on a 640 x 480 depth
    image, trimmed_filter on the pairs of ICP on the ICP path's last scan
    and surface_points on its grid: each equal to the CPU port's on the
    same inputs in every element."""
    from ohm_tsd_slam_tpu_torch.grid.axis_aligned import surface_points
    from ohm_tsd_slam_tpu_torch.registration.filters import (
        occlusion_filter,
        trimmed_filter,
    )
    from ohm_tsd_slam_tpu_torch.sensor.polar2d import data_to_cartesian

    cloud, P = depth_cloud(21)
    c, s = math.cos(0.01), math.sin(0.01)
    R = (np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
         @ np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]))
    scene = (cloud.astype(np.float64) @ R.T
             + np.array([0.02, -0.01, 0.03])).astype(np.float32)
    behind = cloud * ((cloud[:, 2:] + 0.5) / np.maximum(cloud[:, 2:], 1e-9))
    occl = np.concatenate([cloud, behind[::2]]).astype(np.float32)
    res = {}
    for dev in (cuda_device, torch.device("cpu")):
        T = [torch.as_tensor(a, device=dev) for a in (
            cloud, scene, scene[:, 2] > 0, P, occl, occl[:, 2] > 0)]
        res[dev.type] = (nn.projective_pairs_3d(*T[:4], PROJ_W, PROJ_H),
                         occlusion_filter(T[4], T[5], T[3], PROJ_W, PROJ_H))
    (pairs, kept), (pairs_c, kept_c) = res["cuda"], res["cpu"]
    for a, b in zip(pairs, pairs_c):
        assert bits_equal(a, b)
    assert bits_equal(kept, kept_c)
    assert int(pairs[2].sum()) > 0.5 * cloud.shape[0]
    occluded = int(((occl[:, 2] > 0) & ~kept.cpu().numpy()).sum())
    assert occluded > 0.3 * behind[::2].shape[0]

    node, _ = run_path("icp", cuda_device)
    loc = node.localizers[0]
    grid, geom, pose = node.grid, loc.geom, loc.pose.contiguous()
    data, mask = node._preprocess(loc, scan_ranges(xyt_of(pose),
                                                   geom.max_range))
    scene2, scene2_mask = data_to_cartesian(geom, data, mask)
    model = rf.raycast_fast(grid, geom, pose,
                            segments=node._segments_for(grid))
    reg = icp_mod.icp(model.coords, model.mask, scene2, scene2_mask,
                      loc.params.icp, sensor_pose=pose,
                      model_normals=model.normals)
    _, d2, pmask, _ = nn.assign_pairs_fused(
        model.coords, model.mask, se2.transform_points(reg.T, scene2),
        scene2_mask, model.normals)
    trimmed = trimmed_filter(d2, pmask, TRIM_PERCENT)
    assert bits_equal(trimmed, trimmed_filter(d2.cpu(), pmask.cpu(),
                                              TRIM_PERCENT))
    n = int(pmask.sum())
    assert int(trimmed.sum()) == math.floor(
        np.float32(n) * np.float32(TRIM_PERCENT) / np.float32(100.0)) > 0
    pts, pmask2 = surface_points(grid)
    pts_c, pmask2_c = surface_points(from_arrays(to_arrays(grid),
                                                 device="cpu"))
    assert bits_equal(pmask2, pmask2_c)
    assert bits_equal(pts[pmask2], pts_c[pmask2_c])
    assert torch.equal(torch.isnan(pts).cpu(), torch.isnan(pts_c))
    H, W = grid.tsd.shape
    assert pts.shape[0] == H * (W - 1) + (H - 1) * W
    assert int(pmask2.sum()) > 1000


@pytest.mark.cuda
def test_multi_robot_step(cuda_device):
    """multi_robot_slam_step on configs/double-laser.yaml's two robots
    sharing the 1024^2 grid, ICP (25 iterations), robot0's 30 m laser for
    both, STEPS_MULTI steps within 2.5 cells, the launches counted (one C,
    D and rounds launch a step for both robots, A and B once, the push
    once a robot); one step each in the modes TSD and GN; one ICP step on
    the card against the CPU port in float32 (poses within MULTI_TOL, the
    pose gradient at one pose within RENDER_TOL of its largest
    magnitude); three steps over a segment capacity below the grid's,
    each robot rendered with the exact march."""
    from ohm_tsd_slam_tpu_torch.parallel import (
        multi_robot_slam_step,
        pose_gradient,
    )
    from ohm_tsd_slam_tpu_torch.registration.ransac import RansacParams

    dev = cuda_device
    cfg, geom, params, gts, grid, poses = tc.multi_robot_setup(
        dev, PushCheck())
    grid0, poses0 = grid, poses
    limit = 2.5 * cfg.grid.cellsize
    tc.reset_counts()
    for k in range(1, tc.STEPS_MULTI + 1):
        data, mask = tc.multi_robot_inputs(gts, k, dev)
        res = multi_robot_slam_step(grid, poses, data, mask, params, seed=k)
        grid, poses = res.grid, res.poses
        assert int(res.rays_dropped) == 0, k
        assert not bool(res.reg_error.any()), (k, res.reg_error)
        p = poses.cpu()
        for r, gt in enumerate(gts):
            assert math.hypot(float(p[r, 0, 2]) - gt[k][0],
                              float(p[r, 1, 2]) - gt[k][1]) < limit, (k, r)
    torch.cuda.synchronize()
    la = tc.read_counts()
    n = tc.STEPS_MULTI
    for k in ("segment_min", "window_replay", "window_rounds",
              "segment_layers", "pack_rows"):
        assert la[k] == n, (k, la)
    assert la["push"] == 2 * n and la["compact_channels"] == 0, la

    data, mask = tc.multi_robot_inputs(gts, n, dev)
    for mode in (3, 4):
        p = dataclasses.replace(
            params, mode=mode, ransac=RansacParams.from_config(
                from_flat_params(SINGLE_LASER).robots[0].registration.ransac,
                geom.angular_res))
        tc.reset_counts()
        res = multi_robot_slam_step(grid, poses, data, mask, p, seed=7)
        torch.cuda.synchronize()
        la = tc.read_counts()
        assert not bool(res.reg_error.any()), (mode, res.reg_error)
        assert bool(torch.isfinite(res.poses).all()), mode
        assert float((res.poses - poses)[:, :2, 2].abs().max()) < limit
        assert la["push"] == 2, la
        rendered = int(mode != 4)
        for k in ("segment_min", "window_replay", "window_rounds"):
            assert la[k] == rendered, (mode, la)

    data, mask = tc.multi_robot_inputs(gts, 1, dev)
    card = multi_robot_slam_step(grid0, poses0, data, mask, params)
    cpu_grid = dataclasses.replace(grid0, **{
        f: getattr(grid0, f).cpu() for f in FIELDS})
    cpu = multi_robot_slam_step(cpu_grid, poses0.cpu(), data.cpu(),
                                mask.cpu(), params)
    grad_card = torch.stack([
        pose_gradient(grid0, geom, card.poses[r], data[r], mask[r])
        for r in range(2)]).cpu()
    grad_cpu = torch.stack([
        pose_gradient(cpu_grid, geom, card.poses[r].cpu(), data[r].cpu(),
                      mask[r].cpu()) for r in range(2)])
    assert torch.equal(card.reg_error.cpu(), cpu.reg_error)
    assert float((card.poses.cpu() - cpu.poses).abs().max()) < tc.MULTI_TOL
    assert float(((grad_card - grad_cpu).abs()
                  / grad_cpu.abs().max()).max()) < RENDER_TOL

    # a capacity below the grid's segments (both robots' first scans):
    # every robot rendered with the exact march under the batch's one
    # guard, rays_dropped the fast caster's
    g, p = grid0, poses0
    cap = 128 * ((int(rf.extract_segments(g).count) - 1) // 128)
    with patched((rf, "MAX_SEGMENTS", cap)):
        for k in range(1, 4):
            data, mask = tc.multi_robot_inputs(gts, k, dev)
            res = multi_robot_slam_step(g, p, data, mask, params, seed=k)
            dropped = int(rf.extract_segments(g).n_dropped)
            assert int(res.rays_dropped) >= p.shape[0] * dropped > 0, k
            assert not bool(res.reg_error.any()), (k, res.reg_error)
            g, p = res.grid, res.poses
            for r, gt in enumerate(gts):
                assert math.hypot(float(p[r, 0, 2]) - gt[k][0],
                                  float(p[r, 1, 2]) - gt[k][1]) < limit


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1), (2, 1), "auto"],
                         ids=["nccl-1", "gloo-2", "gloo-4"])
def test_sharded_step_on_one_card(cuda_device, shape, tmp_path):
    """The row-sharded step (parallel/) in a world of rank processes on
    this card (tests/torch_mesh_worker.py's job "card"; NCCL refuses two
    ranks on one card, so the wider worlds take gloo).  Each rank holds
    its push into its row block to the whole grid's push in every bit and
    to the plain push; the sharded render of each robot to the one-card
    caster, kernels A, B and C on its block and D on its halo'd block to
    their twins at every launch; STEPS_MULTI ICP steps of
    make_sharded_step within 2.5 cells, the first within MULTI_TOL of the
    one-card step, with their launches; one TSD and one GN step; on NCCL
    the compiled step's replays equal the eager step in every bit."""
    from torch_mesh_worker import run_world

    ranks = run_world("card", {}, shape, str(tmp_path), timeout=600.0,
                      device_type="cuda")
    assert len(ranks) == (4 if shape == "auto" else shape[0] * shape[1])
    for res in ranks:
        assert int(res["icp_steps"]) == tc.STEPS_MULTI
        # the step is a graph on NCCL, eager on gloo
        assert bool(res["compiled"]) == (len(ranks) == 1)
