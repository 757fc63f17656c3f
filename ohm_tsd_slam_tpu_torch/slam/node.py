"""The SLAM node: grid ownership, per-robot localizers, runtime loops
(port of ohm_tsd_slam_tpu/slam/node.py: every registration mode and the
odometry rescue).

SlamNode + the ThreadSLAM architecture (src/SlamNode.cpp,
src/ThreadSLAM.cpp).  The grid is a value swapped under a lock (updates
never write into a grid a reader may hold), and the three roles are:

  * per-robot localization (ThreadLocalize) — `process_scan` / localizer
    threads with latest-wins scan slots (ThreadLocalize.cpp:271,321,331),
  * map updates (ThreadMapping) — `Mapper` queue drained newest-first,
    through the push that grid/dispatch.py::best_push picks (the CUDA
    kernel for a grid on the card),
  * occupancy publication (ThreadGrid) — `GridPublisher` on a timer.

`process_scan` reads the device twice per scan, as the JAX node does: the
two gate flags with the fast caster's drop count, then the accepted pose.
The step guards its render itself (slam/localize.py: raycast_checked, the
exact march where the fast caster overflowed), so a nonzero drop count is
only logged, and an overflowing scan costs no third read and no second
step.  The fast caster's segment extraction runs once per grid version,
after the mapper drain that made it, and every scan reuses it; its
capacity follows the grid's size (grid/raycast_fast.py::
segment_capacity), and on a grid wider than twice a laser's reach the
step cuts it to the segments in reach before each render.  A robot
in mode GN renders no model scan, so the node extracts nothing for it
(as the JAX node): on a node whose robots all run GN, kernels A, B and E
never launch.

With `use_odom_rescue`, `on_odometry` records the latest odometry pose and
each scan advances the rescue state with it (odomRescueUpdate,
ThreadLocalize.cpp:334-336) before `localize_step` checks the match
against it.

On the card the node runs the compiled step, as the JAX node runs its
jitted one: `localize_step_jit` and `extract_segments_jit`, each a CUDA
graph a key (utils/compiled.py), captured when a localizer starts (with
the real shapes, so the capture stays out of the first scan's latency)
and replayed every scan, the overflow guard inside the graph.  On the
CPU both run eagerly.

The stochastic matchers (modes EXP/PDF/TSD/AMCL) draw from a
`torch.Generator` that the node seeds anew for every robot and scan from
its one `seed`, as the JAX node folds robot and scan counter into its base
key: a run is a function of the seed.

    node = SlamNode(from_flat_params({...}), dtype=torch.float32)
    node.process_scan(robot, LaserScan(...))
    node.publish_map()
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from ohm_tsd_slam_tpu_torch import native
from ohm_tsd_slam_tpu_torch.config import RegMode, RobotConfig, SlamConfig
from ohm_tsd_slam_tpu_torch.core import se2
from ohm_tsd_slam_tpu_torch.grid import state as grid_state
from ohm_tsd_slam_tpu_torch.grid.dispatch import best_push
from ohm_tsd_slam_tpu_torch.grid.raycast_fast import (
    SegmentCache,
    extract_segments_jit,
    is_stale,
)
from ohm_tsd_slam_tpu_torch.sensor.polar2d import (
    SensorPolar2D,
    clamp_min_range,
    standard_mask,
)
from ohm_tsd_slam_tpu_torch.slam import odometry
from ohm_tsd_slam_tpu_torch.slam.grid_pub import GridPublisher
from ohm_tsd_slam_tpu_torch.slam.localize import (
    LocalizeParams,
    calc_angle_02pi,
    localize_step_jit,
)
from ohm_tsd_slam_tpu_torch.slam.mapping import Mapper
from ohm_tsd_slam_tpu_torch.slam.messages import (
    LaserScan,
    PoseStamped,
    Transform2D,
    pack_scan,
    unpack_scan,
)
from ohm_tsd_slam_tpu_torch.utils import spans
from ohm_tsd_slam_tpu_torch.utils.device import default_device


# odd multiplier that folds (seed, robot, scan counter) into one 63-bit
# generator seed; distinct for robots and scan counters below it
_SEED_MIX = 1_000_003


def _se2_np(x: float, y: float, yaw: float) -> np.ndarray:
    """float64 host-side SE(2) matrix for the tf chain."""
    c, s = math.cos(yaw), math.sin(yaw)
    return np.array([[c, -s, x], [s, c, y], [0.0, 0.0, 1.0]])


@dataclass
class Localizer:
    """Per-robot localization state (the mutable half of ThreadLocalize)."""

    config: RobotConfig
    grid_offset_x: float
    grid_offset_y: float
    geom: Optional[SensorPolar2D] = None
    params: Optional[LocalizeParams] = None
    pose: Optional[torch.Tensor] = None
    last_pose: Optional[torch.Tensor] = None
    reverse_scan: bool = False
    initialized: bool = False
    # latest-wins scan channel (threaded mode): the native mailbox
    # replicating the reference's keep-newest deque (ThreadLocalize.cpp:
    # 269-332)
    scan_channel: native.Channel = field(
        default_factory=lambda: native.Channel(native.MAILBOX))
    last_result: Optional[PoseStamped] = None
    # scans localized so far: the position of the per-scan draw stream
    # (the reference's matchers reseed rand() per call)
    scan_count: int = 0
    # the fast caster's drop count on the last scan (nonzero: that scan
    # was re-rendered with the exact march)
    rays_dropped: int = 0
    # odometry rescue (OdometryAnalyzer state; None until the first scan
    # that has an odometry pose) and the latest odometry pose and stamp
    odom_state: Optional[odometry.OdomState] = None
    latest_odom: Optional[tuple] = None
    # tf chain for the map->odom correction (sendTransform,
    # ThreadLocalize.cpp:604-689): static laser->footprint and the latest
    # footprint->odom transform, fed by set_static_tf / on_footprint_odom
    tf_laser_footprint: Optional[np.ndarray] = None    # 3x3
    tf_footprint_odom: Optional[np.ndarray] = None     # 3x3
    # last computed map->odom tf, re-published while the odom hop is
    # missing (the reference re-broadcasts its previous _tf)
    last_tf: Optional[Transform2D] = None


class SlamNode:
    def __init__(self, config: SlamConfig, dtype=torch.float32,
                 device=None, seed: int = 0):
        """`device` None is the card ("cuda"), and raises where there is
        none: the node runs on the CPU only for a caller who asks for it
        (device="cpu", as the parity tests do)."""
        self.config = config
        self.dtype = dtype
        self.device = default_device(device, "SlamNode")
        self.seed = seed     # base of the per-robot, per-scan draw streams
        self.grid = grid_state.create(config.grid, dtype=dtype,
                                      device=self.device)
        # _grid_lock guards only the grid reference swap; _write_lock
        # serializes grid writers (init + mapper drain) so no update is
        # lost, without blocking readers during the compute
        self._grid_lock = threading.Lock()
        self._write_lock = threading.Lock()
        self.mapper = Mapper(push_fn=best_push(self.grid))
        self.grid_pub = GridPublisher(config.grid_pub,
                                      config.runtime.x_offset,
                                      config.runtime.y_offset)
        gw = config.grid.size_meters
        gx = -(gw * 0.5 + config.runtime.x_offset)
        gy = -(gw * 0.5 + config.runtime.y_offset)
        self.localizers: List[Localizer] = [
            Localizer(config=rc, grid_offset_x=gx, grid_offset_y=gy)
            for rc in config.robots
        ]
        self._active = True      # start_stop_slam service state
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        self._mapper_wakeup = threading.Event()
        self.pose_callbacks: List[Callable[[int, PoseStamped], None]] = []
        # tf broadcast sink (map->odom correction, sendTransform
        # ThreadLocalize.cpp:604-689 / sendNanTransform :691-713)
        self.tf_callbacks: List[Callable[[int, Transform2D], None]] = []
        # the fast caster's per-grid-version isocontour cache, and whether
        # its segments are yet to be counted (utils/spans.py)
        self._seg_lock = threading.Lock()
        self._segments: Optional[SegmentCache] = None
        self._seg_new = False
        # the segment counts a robot without a cache reads (mode GN)
        self._zero = torch.zeros((), dtype=torch.int64, device=self.device)

    def _segments_for(self, grid) -> SegmentCache:
        """extract_segments_jit() of `grid`, memoized on the field it
        came from (grid/raycast_fast.py::is_stale: tensor identity and
        version), at the capacity segment_capacity gives the grid; with
        the span recorder on, a span `extract` and a device interval of
        the same name around the extraction."""
        with self._seg_lock:
            seg = self._segments
            if seg is None or is_stale(seg, grid):
                with spans.span("extract"), spans.device_interval(
                        "extract", self.device):
                    seg = extract_segments_jit(grid)
                self._segments = seg
                self._seg_new = True
            return seg

    @staticmethod
    def _needs_segments(loc: Localizer) -> bool:
        """Whether the robot's step renders with the fast caster: not with
        the exact march, and not in mode GN, which renders nothing."""
        return (loc.params.fast_raycast
                and loc.params.mode != int(RegMode.GN))

    def _draws(self, robot: int, scan_count: int) -> torch.Generator:
        """The draw stream of scan `scan_count` of `robot`: a generator
        on the node's device seeded from (seed, robot, scan counter).
        Calling it again gives the same stream from its start."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(((self.seed * _SEED_MIX + robot) * _SEED_MIX
                         + scan_count) % (1 << 63))
        return gen

    # ------------------------------------------------------------------
    # control (start_stop_slam service, SlamNode.cpp:159-189)
    # ------------------------------------------------------------------
    def set_active(self, active: bool) -> None:
        self._active = active

    @property
    def active(self) -> bool:
        return self._active

    # ------------------------------------------------------------------
    # initialization on first scan (ThreadLocalize::init, :411-511)
    # ------------------------------------------------------------------
    def _init_localizer(self, loc: Localizer, scan: LaserScan) -> None:
        rc = loc.config
        inc = scan.angle_increment
        angle_min = scan.angle_min
        ranges = np.asarray(scan.ranges, dtype=np.float64)
        if inc < 0.0 and angle_min > 0:
            # reversed (CW) scanner normalization (:491-497)
            loc.reverse_scan = True
            inc = -inc
            angle_min = -angle_min
        loc.geom = SensorPolar2D(
            size=len(ranges),
            angular_res=float(inc),
            phi_min=float(angle_min),
            max_range=rc.sensor.max_range,
            min_range=rc.sensor.min_range,
            low_reflectivity_range=rc.sensor.low_reflectivity_range,
        )
        gw = self.config.grid.size_meters
        start_x = gw * 0.5 + self.config.runtime.x_offset + rc.local_offset_x
        start_y = gw * 0.5 + self.config.runtime.y_offset + rc.local_offset_y
        loc.pose = se2.make(start_x, start_y, rc.local_offset_yaw,
                            dtype=self.dtype, device=self.device)
        loc.last_pose = loc.pose
        loc.params = LocalizeParams.from_config(
            rc.registration, loc.geom, bounds=(0.0, gw, 0.0, gw),
            odom_cfg=rc.odom, cell_size=self.config.grid.cellsize)

        # free footprint + initial map push (:503-507)
        fp = rc.footprint
        center = (start_x + fp.x_offset, start_y)
        with self._write_lock:
            with self._grid_lock:
                grid = self.grid
            grid = grid_state.free_footprint(grid, center, fp.width,
                                             fp.height)
            data, mask = self._preprocess(loc, ranges)
            if not self.mapper.initialized():
                grid = self.mapper.init_push(grid, loc.geom, loc.pose,
                                             data, mask)
            with self._grid_lock:
                self.grid = grid
        loc.initialized = True
        seg = self._segments_for(grid) if self._needs_segments(loc) else None
        if self.device.type == "cuda":
            self._prime_step(loc, grid, data, mask, seg)

    def _prime_step(self, loc: Localizer, grid, data, mask, seg) -> None:
        """Capture the step with the real shapes now, as the JAX node
        primes its jitted step (node.py:209-218), so the localizer never
        waits on a capture; with the rescue on, also the key of a scan
        that has an odometry state.  The results are dropped, and the
        draws come from a stream of their own."""
        gen = torch.Generator(device=self.device)
        states = [None]
        if loc.params.odom is not None:
            states.append(odometry.init(loc.params.odom, loc.pose, 0.0))
        for state in states:
            gen.manual_seed(0)
            localize_step_jit(grid, loc.pose, loc.last_pose, data, mask,
                              loc.params, generator=gen, odom_state=state,
                              segments=seg)

    def _preprocess(self, loc: Localizer, ranges: np.ndarray):
        """laserCallBack clamp + standard mask
        (ThreadLocalize.cpp:252-256,328-329)."""
        data = torch.as_tensor(ranges, dtype=self.dtype, device=self.device)
        data = clamp_min_range(data, loc.config.sensor.laser_min_range)
        return standard_mask(loc.geom, data)

    # ------------------------------------------------------------------
    # synchronous per-scan processing (deterministic pipeline)
    # ------------------------------------------------------------------
    def process_scan(self, robot: int, scan: LaserScan,
                     drain_mapper: bool = True) -> Optional[PoseStamped]:
        """Run one localization cycle for `robot`; returns the published
        pose (NaN sentinel on registration failure, ThreadLocalize
        :381-387), or None before initialization / while stopped.

        With the span recorder on (utils/spans.py) the cycle is a span
        `process_scan` of trace (robot, scan counter; -1 for the scan
        that starts the robot) with the children `preprocess`,
        `segments`, `localize_step_jit`, `read_gates`, `read_pose`,
        `map_update` and `callbacks`, and counts `icp_iterations_run`,
        `icp_iterations_useful`, `grid_versions`, `segment_capacity`,
        `segments`, `segments_dropped`, `segments_swept`,
        `scans_overflowed` and, in mode EXP, `ransac_candidates` and
        `ransac_pairs` from the values the gates' read brings back
        anyway."""
        if not self._active:
            return None
        loc = self.localizers[robot]
        if not spans.enabled():
            return self._process_scan(robot, loc, scan, drain_mapper)
        count = loc.scan_count if loc.initialized else -1
        with spans.span("process_scan", trace=(robot, count), robot=robot,
                        scan=count):
            return self._process_scan(robot, loc, scan, drain_mapper)

    def _process_scan(self, robot: int, loc: Localizer, scan: LaserScan,
                      drain_mapper: bool) -> Optional[PoseStamped]:
        ranges = np.asarray(scan.ranges, dtype=np.float64)
        if not loc.initialized:
            self._init_localizer(loc, scan)
            return None

        with spans.span("preprocess"):
            if loc.reverse_scan:
                ranges = ranges[::-1].copy()
            data, mask = self._preprocess(loc, ranges)
        with self._grid_lock:
            grid = self.grid
        params = loc.params
        with spans.span("segments"):
            seg = (self._segments_for(grid) if self._needs_segments(loc)
                   else None)
        count = loc.scan_count
        loc.scan_count += 1
        odom_state = self._odom_update(loc, scan.stamp)
        res = localize_step_jit(grid, loc.pose, loc.last_pose, data, mask,
                                params, generator=self._draws(robot, count),
                                odom_state=odom_state, segments=seg)

        with spans.span("read_gates"):
            (reg_error, significant, n_over, icp_iterations, n_segments,
             n_seg_dropped, n_swept, n_cands, n_pairs) = torch.stack(
                [res.reg_error.to(torch.int64),
                 res.significant.to(torch.int64),
                 res.rays_dropped.to(torch.int64),
                 res.icp_iterations.to(torch.int64),
                 self._zero if seg is None else seg.count.to(torch.int64),
                 self._zero if seg is None else seg.n_dropped,
                 res.segments_swept, res.ransac_candidates,
                 res.ransac_pairs]).tolist()
        if spans.enabled():
            self._count_scan(params, seg, n_over, icp_iterations,
                             n_segments, n_seg_dropped, n_swept,
                             (n_cands, n_pairs))
        if n_over > 0:
            # fast-raycast capacity overflow: the guarded exact march
            # re-rendered the scan inside the step (no beams lost) — log
            # the pressure (RayCastPolar2D's degradation warning analogue,
            # ThreadLocalize.cpp:354-358)
            native.log(native.LOG_WARN, "localize",
                       f"fast raycast overflowed by {n_over} "
                       "segments/beams; exact-march fallback used")
        loc.rays_dropped = n_over
        if reg_error:
            pose_msg = PoseStamped(math.nan, math.nan, math.nan,
                                   stamp=scan.stamp)
        else:
            loc.pose = res.pose
            with spans.span("read_pose"):
                T = res.pose.cpu()
                pose_msg = PoseStamped(
                    x=float(T[0, 2]) + loc.grid_offset_x,
                    y=float(T[1, 2]) + loc.grid_offset_y,
                    theta=float(calc_angle_02pi(T)),
                    stamp=scan.stamp)
            if significant:
                loc.last_pose = res.pose
                self.mapper.queue_push(loc.geom, res.pose, data, mask)
                if drain_mapper:
                    self._drain_mapper()
        loc.last_result = pose_msg
        with spans.span("callbacks"):
            for cb in self.pose_callbacks:
                cb(robot, pose_msg)
            self._broadcast_tf(robot, loc, pose_msg, scan.stamp)
        return pose_msg

    def _count_scan(self, params: LocalizeParams, seg, n_over: int,
                    icp_iterations: int, n_segments: int,
                    n_seg_dropped: int, n_swept: int,
                    ransac_work: tuple) -> None:
        """A scan's counters (utils/spans.py).  ICP runs all its
        iterations in every mode but GN, which runs none; a grid
        version's capacity (its pack's width, a host-side shape) and
        segments count once, on the first scan that renders with them;
        the segments kernel C swept count on every scan that rendered
        with a cache; in mode EXP, every scan, the matcher's valid
        candidates and the pairs its nearest-model-point search tests."""
        if params.mode == int(RegMode.EXP):
            spans.count("ransac_candidates", ransac_work[0])
            spans.count("ransac_pairs", ransac_work[1])
        if params.mode != int(RegMode.GN):
            spans.count("icp_iterations_run", params.icp.iterations)
            spans.count("icp_iterations_useful", icp_iterations)
        if seg is not None and self._seg_new:
            self._seg_new = False
            spans.count("grid_versions")
            spans.count("segment_capacity", seg.pack.shape[1])
            spans.count("segments", n_segments)
            spans.count("segments_dropped", n_seg_dropped)
        if seg is not None:
            spans.count("segments_swept", n_swept)
        if n_over > 0:
            spans.count("scans_overflowed")

    def _odom_update(self, loc: Localizer,
                     stamp: float) -> Optional[odometry.OdomState]:
        """Advance the robot's rescue state with the latest odometry pose
        (odomRescueUpdate call site, ThreadLocalize.cpp:334-336): the
        first scan with one initializes it.  None without the rescue or
        before any odometry."""
        if loc.params.odom is None or loc.latest_odom is None:
            return None
        odom_pose, _ = loc.latest_odom
        if loc.odom_state is None:
            loc.odom_state = odometry.init(loc.params.odom, odom_pose, stamp)
        else:
            loc.odom_state = odometry.update(loc.odom_state, odom_pose,
                                             stamp, odom_ok=True)
        return loc.odom_state

    def on_odometry(self, robot: int, x: float, y: float, yaw: float,
                    stamp: float = 0.0) -> None:
        """Feed an odometry sample for `robot` (the reference pulls it from
        the tf tree, OdometryAnalyzer.cpp:65-151); the rescue stage uses
        it when robot.odom.use_odom_rescue is set."""
        pose = se2.make(x, y, yaw, dtype=self.dtype, device=self.device)
        self.localizers[robot].latest_odom = (pose, stamp)

    def set_static_tf(self, robot: int, x: float, y: float,
                      yaw: float) -> None:
        """Static laser->footprint transform (the reference's
        `lookupTransform(laser, footprint)`)."""
        self.localizers[robot].tf_laser_footprint = _se2_np(x, y, yaw)

    def on_footprint_odom(self, robot: int, x: float, y: float,
                          yaw: float, stamp: float = 0.0) -> None:
        """Latest footprint->odom transform (the reference's
        `lookupTransform(footprint, odom)`)."""
        self.localizers[robot].tf_footprint_odom = _se2_np(x, y, yaw)

    def _broadcast_tf(self, robot: int, loc: Localizer,
                      pose_msg: PoseStamped, stamp: float) -> None:
        """The map->odom correction chain of ThreadLocalize::sendTransform
        (ThreadLocalize.cpp:604-689): tf = pose_map_laser ·
        T(laser->footprint) · T(footprint->odom), each hop applied only
        when available, the previous tf re-broadcast (with a fresh stamp)
        when the odom hop is missing; NaN pose => NaN tf."""
        if not self.tf_callbacks:
            return
        if pose_msg.is_nan:
            tf = Transform2D(math.nan, math.nan, math.nan, stamp=stamp)
        else:
            pose = _se2_np(pose_msg.x, pose_msg.y, pose_msg.theta)
            if loc.tf_laser_footprint is not None:
                pose = pose @ loc.tf_laser_footprint
            if loc.tf_footprint_odom is not None:
                t = pose @ loc.tf_footprint_odom
                tf = Transform2D(
                    x=float(t[0, 2]), y=float(t[1, 2]),
                    theta=float(math.atan2(t[1, 0], t[0, 0])),
                    stamp=stamp)
                loc.last_tf = tf
            else:
                tf = (dataclasses.replace(loc.last_tf, stamp=stamp)
                      if loc.last_tf is not None
                      else Transform2D(0.0, 0.0, 0.0, stamp=stamp))
        for cb in self.tf_callbacks:
            cb(robot, tf)

    def _drain_mapper(self) -> None:
        """The queued pushes and the new grid's extraction: with the span
        recorder on, a span `map_update` (a `push` a queued scan) and a
        device interval of the same name around it."""
        with spans.span("map_update"), spans.device_interval("map_update",
                                                             self.device):
            with self._write_lock:
                with self._grid_lock:
                    grid = self.grid
                grid = self.mapper.drain(grid)
                with self._grid_lock:
                    self.grid = grid
                if self._segments is not None:  # the fast caster is in use
                    self._segments_for(grid)

    def publish_map(self, stamp: float = 0.0):
        """ThreadGrid cycle on the current grid state (a span
        `publish_map` with the recorder on)."""
        with spans.span("publish_map"):
            with self._grid_lock:
                grid = self.grid
            return self.grid_pub.publish(grid, stamp)

    # ------------------------------------------------------------------
    # threaded runtime (replicates the reference's lossy behavior)
    # ------------------------------------------------------------------
    def on_scan(self, robot: int, scan: LaserScan) -> None:
        """Laser callback: latest-wins slot + wakeup
        (ThreadLocalize.cpp:269-275); the first scan initializes
        synchronously in the callback thread (:257-267)."""
        if not self._active:
            return
        loc = self.localizers[robot]
        if not loc.initialized:
            self._init_localizer(loc, scan)
            return
        loc.scan_channel.push(pack_scan(scan))

    def _localizer_loop(self, robot: int) -> None:
        loc = self.localizers[robot]
        while not self._stop.is_set():
            payload = loc.scan_channel.pop_wait(timeout_ms=100)
            if payload is None:
                continue
            if self._active:
                self.process_scan(robot, unpack_scan(payload),
                                  drain_mapper=False)
                self._mapper_wakeup.set()

    def _mapper_loop(self) -> None:
        while not self._stop.is_set():
            if not self._mapper_wakeup.wait(timeout=0.1):
                continue
            self._mapper_wakeup.clear()
            if self.mapper.pending():
                self._drain_mapper()

    def _grid_loop(self) -> None:
        interval = self.config.grid_pub.interval_s
        next_t = time.monotonic() + interval
        while not self._stop.wait(timeout=max(0.0,
                                              next_t - time.monotonic())):
            next_t = time.monotonic() + interval
            self.publish_map(stamp=time.time())

    def start(self) -> None:
        """Spawn the mapper and grid threads plus one localizer thread per
        robot (SlamNode.cpp:85-122)."""
        self._stop.clear()
        self._mapper_wakeup.clear()
        self._threads = [
            threading.Thread(target=self._mapper_loop, daemon=True),
            threading.Thread(target=self._grid_loop, daemon=True),
        ] + [
            threading.Thread(target=self._localizer_loop, args=(i,),
                             daemon=True)
            for i in range(len(self.localizers))
        ]
        for t in self._threads:
            t.start()

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = []
