"""The benchmark's harness: finds a cell's pieces by name, sets the cell
up, runs its window, its traced sessions and its check.

Everything that belongs to one configuration, traffic mix, per-layer
metric or cell is a file of its own, found by the name BENCHMARK.json
gives it:

  * configs/<config>.json: the deployment's flat parameters (the
    reference's names, as in config/*.yaml), its `source`, `reduced` and
    `assumed` (the scanner, its range noise, the scene and circuits);
  * traffic/<mix>.json: the arrivals (open loop on the scanner's clock
    or closed loop), publication, warm-up and motion, read by the one
    generator traffic/scans.py;
  * metrics/<metric>.py: a per-layer metric's reader: `read(run)` gives
    the number or None, and an optional `probe(run)` measures, before the
    traced sessions, what `read` then reads from run.probes;
  * limits/<cell>.json: the limit of each number the check compares.

The program under test is ohm_tsd_slam_tpu_torch, driven through
SlamNode.process_scan and SlamNode.publish_map and nothing else in the
window.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# keys of a config file that are not the deployment's parameters
META_KEYS = ("source", "reduced", "assumed")
SAMPLED_SCANS = 16       # scans of a window the check compares
SAMPLED_PUBLISHES = 4    # publications of a window the check compares
SESSIONS = 3             # profiler sessions of a traced run
SESSION_SCANS = 15       # scans a session (longer sessions lost records)
LEAD_S = 0.05            # the window's first event is due this far ahead


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def list_cells(root: str = ROOT) -> List[str]:
    return [w["name"] for w in benchmark(root)["workloads"]]


def reader(name: str, root: str = ROOT):
    """The module of metrics/<name>.py."""
    path = os.path.join(root, "slambench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "slambench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _in_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict             # the config file as it stands
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: dict
    root: str

    @property
    def params(self) -> dict:
        return {k: v for k, v in self.config.items() if k not in META_KEYS}

    @property
    def assumed(self) -> dict:
        return self.config["assumed"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    bench = benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(cells: {sorted(work)})")
    w = work[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    sb = os.path.join(root, "slambench")
    return Cell(
        name=name, workload=w,
        config=load_json(os.path.join(root, cfg["file"])),
        traffic=load_json(os.path.join(sb, "traffic", w["traffic"] + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if _in_cell(m, name)],
        per_layer=[m for m in bench["per_layer"] if _in_cell(m, name)],
        limits=load_json(os.path.join(sb, "limits", name + ".json")),
        root=root)


# --------------------------------------------------------------------------
# a run
# --------------------------------------------------------------------------

@dataclass
class Window:
    """What the window recorded (host clock, seconds)."""

    latency: List[float] = field(default_factory=list)
    late: List[float] = field(default_factory=list)
    publish: List[float] = field(default_factory=list)
    failed: int = 0
    attempted: int = 0
    poses: list = field(default_factory=list)    # (robot, k, pose message)
    mapped: int = 0          # scans the program pushed into the map
    overflowed: int = 0      # scans whose fast render overflowed
    span: float = 0.0


class Snapshots:
    """Copies of the program's grids for the check, in host memory.

    Holding the program's own grids alive would grow the card's caching
    allocator in the window, and its new segments stall the program (a
    push wrapper took 18-52 ms where it takes 0.07, on the card).  So a
    grid is copied out on a stream of its own, after the work that made
    it, into page-locked buffers kept per slot: the program's stream
    never waits, and its memory is left as it would be."""

    FIELDS = ("tsd", "weight", "tile_init", "tile_initw")

    def __init__(self, device, grid, slots):
        """Buffers for each of `slots` shaped as `grid`'s, made now (in
        set-up: page-locking memory stalls the card)."""
        import torch

        self.stream = None
        if device.type == "cuda":
            self.stream = torch.cuda.Stream(device)
            self.buffers = {slot: HostGrid(*(
                torch.empty(getattr(grid, f).shape,
                            dtype=getattr(grid, f).dtype, pin_memory=True)
                for f in self.FIELDS)) for slot in slots}
        self.device = device

    def take(self, grid, slot) -> "HostGrid":
        import torch

        if self.stream is None:
            return HostGrid(*(getattr(grid, f).clone() for f in self.FIELDS))
        bufs = self.buffers[slot]
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            for f in self.FIELDS:
                src = getattr(grid, f)
                getattr(bufs, f).copy_(src, non_blocking=True)
                src.record_stream(self.stream)
        return bufs

    def wait(self) -> None:
        if self.stream is not None:
            self.stream.synchronize()


@dataclass
class HostGrid:
    """A grid's four arrays, copied out of the program."""

    tsd: object
    weight: object
    tile_init: object
    tile_initw: object


class Run:
    """One run of a cell: set-up, window, traced sessions, check."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", t_start: Optional[float] = None):
        import torch

        self.cell = cell
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = torch.device(device)
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.probes: Dict[str, object] = {}
        self.sessions: list = []
        self.window = Window()
        self.setup_s = None

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        import torch

        from ohm_tsd_slam_tpu_torch.config import from_flat_params
        from ohm_tsd_slam_tpu_torch.slam.messages import LaserScan
        from ohm_tsd_slam_tpu_torch.slam.node import SlamNode

        from slambench import check
        from slambench.traffic import scans

        phases = self.setup_phases = {}
        mark = self.t_start

        def phase(name):
            nonlocal mark
            now = time.perf_counter()
            phases[name] = now - mark
            mark = now

        if self.device.type == "cuda":
            torch.cuda.init()
        phase("import_and_cuda_init")
        cell, mix = self.cell, self.cell.traffic
        sc = cell.assumed["scanner"]
        self.config = cfg = from_flat_params(cell.params)
        n_robots = len(cfg.robots)
        self.period = sc["period_ms"] * 1e-3
        self.open_loop = mix["arrivals"] == "open"
        self.warmup = int(round(mix["warmup_s"] / self.period))
        if self.open_loop:
            window_scans = int(round(self.seconds / self.period))
            self.publish_every = (cfg.grid_pub.interval_s
                                  if mix["publish"] else None)
        else:
            window_scans = int(math.ceil(
                mix["max_scans_per_s"] * self.seconds / n_robots))
            self.publish_every = None
        trace_scans = (int(math.ceil(SESSIONS * SESSION_SCANS / n_robots))
                       if self.trace else 0)
        n = 1 + self.warmup + window_scans + trace_scans + 2

        gw = cfg.grid.size_meters
        starts = [(gw * 0.5 + cfg.runtime.x_offset + rc.local_offset_x,
                   gw * 0.5 + cfg.runtime.y_offset + rc.local_offset_y,
                   rc.local_offset_yaw) for rc in cfg.robots]
        self.stream = scans.make_stream(
            starts, [rc.sensor.max_range for rc in cfg.robots], sc,
            cell.assumed["scene"], cell.assumed["circuits"], mix, n,
            self.seed, self.device)
        self.angle_min = math.radians(sc["angle_min_deg"])
        self.increment = math.radians(sc["increment_deg"])
        self.msgs = [[LaserScan(ranges=rng[k], angle_min=self.angle_min,
                                angle_increment=self.increment,
                                range_max=rc.sensor.max_range,
                                stamp=k * self.period)
                      for k in range(n)]
                     for rng, rc in zip(self.stream.ranges, cfg.robots)]
        phase("scans")
        # stream order: scan k of robot r is due at (k + r / n) periods
        self.order = [(r, k) for k in range(n) for r in range(n_robots)]
        self.next = n_robots          # the first scans start the robots

        self.node = node = SlamNode(cfg, dtype=torch.float32,
                                    device=self.device, seed=self.seed)
        for r in range(n_robots):
            if node.process_scan(r, self.msgs[r][0]) is not None:
                raise RuntimeError("a robot's first scan must start it")
        phase("node_start")
        slots = [("start",)] + [("scan", j, i) for j in range(SAMPLED_SCANS)
                                for i in (0, 1)]
        if self.publish_every is not None:
            slots += [("publish", j) for j in range(SAMPLED_PUBLISHES)]
        self.snapshots = Snapshots(self.device, node.grid, slots)
        self.evidence = check.Evidence(
            params=cell.params, seed=self.seed, ranges=self.stream.ranges,
            angle_min=self.angle_min, increment=self.increment,
            start_grid=self.snapshots.take(node.grid, ("start",)))
        phase("snapshot_buffers")
        for r, k in self._take(self.warmup * n_robots):
            node.process_scan(r, self.msgs[r][k])
        if self.publish_every is not None:
            node.publish_map()
        self._sync()
        gc.collect()
        phase("warm_up")
        self.setup_s = time.perf_counter() - self.t_start

    def _sync(self) -> None:
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)

    def _take(self, count: int):
        if self.next + count > len(self.order):
            raise RuntimeError("the scan stream is exhausted: the traffic's "
                               "max_scans_per_s is below the rate reached")
        out = self.order[self.next:self.next + count]
        self.next += count
        return out

    # ------------------------------------------------------------ window
    def run_window(self) -> None:
        self._rng = np.random.default_rng([self.seed, 1])
        self._reservoir = ([], [])
        self._seen = [0, 0]
        if self.open_loop:
            self._open_loop()
        else:
            self._closed_loop()
        self.evidence.scans = self._reservoir[0]
        self.evidence.publishes = self._reservoir[1]
        self.snapshots.wait()

    def _keep(self, kind: int) -> Optional[int]:
        """Reservoir sampling of the window's scans (kind 0) and
        publications (kind 1): each is kept with the same chance, drawn
        from the seed, whatever the window's length.  Returns the slot
        that takes this one, or None."""
        cap = SAMPLED_SCANS if kind == 0 else SAMPLED_PUBLISHES
        i = self._seen[kind]
        self._seen[kind] += 1
        res = self._reservoir[kind]
        if i < cap:
            res.append(None)
            return len(res) - 1
        j = int(self._rng.integers(0, i + 1))
        return j if j < cap else None

    def _scan(self, r: int, k: int, sample: bool = True):
        from slambench.check import ScanSample

        node = self.node
        slot = self._keep(0) if sample else None
        before = node.grid
        if slot is not None:
            loc = node.localizers[r]
            s = ScanSample(r, k, loc.scan_count,
                           self.snapshots.take(before, ("scan", slot, 0)),
                           loc.pose, loc.last_pose)
        out = node.process_scan(r, self.msgs[r][k])
        if slot is not None:
            if node.grid is not before:
                s.grid_after = self.snapshots.take(node.grid,
                                                   ("scan", slot, 1))
            s.pose_after = node.localizers[r].pose
            s.nan_pose = out.is_nan
            self._reservoir[0][slot] = s
        if sample:
            self.window.poses.append((r, k, out))
            self.window.mapped += node.grid is not before
            self.window.overflowed += node.localizers[r].rays_dropped > 0
        return out

    def _publish(self, t: float) -> None:
        from slambench.check import PublishSample

        node = self.node
        slot = self._keep(1)
        grid = node.grid
        occ, img = node.publish_map(stamp=t)
        if slot is not None:
            self._reservoir[1][slot] = PublishSample(
                self.snapshots.take(grid, ("publish", slot)), occ.data,
                None if img is None else img.data)

    def _events(self, scans: list, publish: bool):
        """(due offset in s, robot or -1 for a publication, k) in time
        order: scan k of robot r due at (k + r / n) periods after the
        first of them, a publication every interval."""
        n_robots = len(self.config.robots)
        k0 = scans[0][1]
        ev = [((k - k0 + r / n_robots) * self.period, r, k) for r, k in scans]
        if publish and self.publish_every is not None:
            t = self.publish_every
            end = ev[-1][0]
            while t <= end:
                ev.append((t, -1, 0))
                t += self.publish_every
        ev.sort(key=lambda e: (e[0], e[1]))
        return ev

    def _paced(self, events, record: bool, mark=None) -> None:
        w = self.window
        t0 = time.perf_counter() + LEAD_S
        for due, r, k in events:
            t_due = t0 + due
            while True:
                left = t_due - time.perf_counter()
                if left <= 0:
                    break
                if left > 0.002:
                    time.sleep(left - 0.001)
            start = time.perf_counter()
            if mark:
                mark(r)
            if r < 0:
                self._publish(due)
                end = time.perf_counter()
                if record:
                    w.publish.append(end - start)
                continue
            out = self._scan(r, k, sample=record)
            end = time.perf_counter()
            if mark:
                mark(None)
            if record:
                w.latency.append(end - t_due)
                w.late.append(start - t_due)
                w.attempted += 1
                w.failed += int(out is None or out.is_nan)
        if record:
            w.span = time.perf_counter() - t0

    def _open_loop(self) -> None:
        n = int(round(self.seconds / self.period)) * len(self.config.robots)
        self._paced(self._events(self._take(n), publish=True), record=True)

    def _closed_loop(self) -> None:
        w = self.window
        t0 = time.perf_counter()
        t_end = t0 + self.seconds
        prev = t0
        while prev < t_end:
            (r, k), = self._take(1)
            out = self._scan(r, k)
            end = time.perf_counter()
            w.latency.append(end - prev)
            w.attempted += 1
            w.failed += int(out is None or out.is_nan)
            prev = end
        w.span = prev - t0

    # ------------------------------------------------------------ trace
    def run_traced(self, readers: dict) -> None:
        """Probes first (the node is alive and no profiler has run), then
        SESSIONS profiler sessions of SESSION_SCANS scans each, driven as
        the window drives them."""
        from slambench import tracing

        for name, mod in readers.items():
            if hasattr(mod, "probe"):
                self.probes[name] = mod.probe(self)
        for _ in range(SESSIONS):
            scans = self._take(SESSION_SCANS)
            if self.open_loop:
                ev = self._events(scans, publish=False)
                self.sessions.append(tracing.session(
                    lambda mark: self._paced(ev, record=False, mark=mark)))
            else:
                def drive(mark, scans=scans):
                    for r, k in scans:
                        mark(r)
                        self._scan(r, k, sample=False)
                        mark(None)
                self.sessions.append(tracing.session(drive))

    # ------------------------------------------------------------ results
    def tracking_error_m(self) -> float:
        """The largest distance of a pose the window returned from the
        pose its scan was taken at (both in the map frame)."""
        cfg = self.config
        gw = cfg.grid.size_meters
        err = 0.0
        for r, k, out in self.window.poses:
            if out is None or out.is_nan:
                continue
            tx, ty, _ = self.stream.truth[r][k]
            err = max(err, math.hypot(
                out.x - (tx - gw * 0.5 - cfg.runtime.x_offset),
                out.y - (ty - gw * 0.5 - cfg.runtime.y_offset)))
        return err

    def end_to_end(self) -> Dict[str, float]:
        w = self.window
        lat_ms = np.asarray(w.latency) * 1e3
        values = {
            "setup_s": self.setup_s,
            "scan_latency_p50_ms": float(np.percentile(lat_ms, 50)),
            "scan_latency_p95_ms": float(np.percentile(lat_ms, 95)),
            "scans_per_s": w.attempted / w.span,
        }
        return values

    def free_program(self) -> None:
        """Drop the program's graphs and node (the check's evidence keeps
        the grids and poses it holds)."""
        from ohm_tsd_slam_tpu_torch.grid.axis_aligned import (
            occupancy_grid_jit,
        )
        from ohm_tsd_slam_tpu_torch.grid.color import grid_to_color_image_jit
        from ohm_tsd_slam_tpu_torch.grid.raycast_fast import (
            extract_segments_jit,
            raycast_checked_jit,
        )
        from ohm_tsd_slam_tpu_torch.registration.icp import icp_jit
        from ohm_tsd_slam_tpu_torch.slam.localize import localize_step_jit

        for fn in (localize_step_jit, extract_segments_jit, icp_jit,
                   raycast_checked_jit, occupancy_grid_jit,
                   grid_to_color_image_jit):
            c = getattr(fn, "compiled", fn)
            c.clear_cache()
        self.node = None
        gc.collect()
        if self.device.type == "cuda":
            import torch
            torch.cuda.empty_cache()
