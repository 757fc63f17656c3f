"""The SLAM node: grid ownership, per-robot localizers, runtime loops
(port of ohm_tsd_slam_tpu/slam/node.py for the registration modes ICP,
EXP, PDF and TSD).

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
A nonzero drop count re-runs the step with the exact march (the JAX
node's guarded raycast_checked), which costs a third read on that scan
only.  The fast caster's segment extraction runs once per grid version,
after the mapper drain that made it, and every scan reuses it.

The stochastic matchers (modes EXP/PDF/TSD) draw from a `torch.Generator`
that the node seeds anew for every robot and scan from its one `seed`, as
the JAX node folds robot and scan counter into its base key: a run is a
function of the seed, and the exact-march re-run of a scan draws the same
numbers as its first run.

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
from ohm_tsd_slam_tpu_torch.config import RobotConfig, SlamConfig
from ohm_tsd_slam_tpu_torch.core import se2
from ohm_tsd_slam_tpu_torch.grid import state as grid_state
from ohm_tsd_slam_tpu_torch.grid.dispatch import best_push
from ohm_tsd_slam_tpu_torch.grid.raycast_fast import (
    SegmentCache,
    extract_segments,
    is_stale,
)
from ohm_tsd_slam_tpu_torch.sensor.polar2d import (
    SensorPolar2D,
    clamp_min_range,
    standard_mask,
)
from ohm_tsd_slam_tpu_torch.slam.grid_pub import GridPublisher
from ohm_tsd_slam_tpu_torch.slam.localize import (
    LocalizeParams,
    calc_angle_02pi,
    localize_step,
)
from ohm_tsd_slam_tpu_torch.slam.mapping import Mapper
from ohm_tsd_slam_tpu_torch.slam.messages import (
    LaserScan,
    PoseStamped,
    Transform2D,
    pack_scan,
    unpack_scan,
)


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
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "SlamNode runs on the CUDA device by default and "
                    "torch.cuda.is_available() is False; pass device=\"cpu\" "
                    "to run on the CPU")
            device = "cuda"
        self.config = config
        self.dtype = dtype
        self.device = torch.device(device)
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
        # the fast caster's per-grid-version isocontour cache
        self._seg_lock = threading.Lock()
        self._segments: Optional[SegmentCache] = None

    def _segments_for(self, grid) -> SegmentCache:
        """extract_segments() of `grid`, memoized on the field it came
        from (grid/raycast_fast.py::is_stale: tensor identity and
        version)."""
        with self._seg_lock:
            seg = self._segments
            if seg is None or is_stale(seg, grid):
                seg = extract_segments(grid)
                self._segments = seg
            return seg

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
            odom_cfg=rc.odom)

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
        if loc.params.fast_raycast:
            self._segments_for(grid)

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
        :381-387), or None before initialization / while stopped."""
        if not self._active:
            return None
        loc = self.localizers[robot]
        ranges = np.asarray(scan.ranges, dtype=np.float64)
        if not loc.initialized:
            self._init_localizer(loc, scan)
            return None
        if loc.reverse_scan:
            ranges = ranges[::-1].copy()

        data, mask = self._preprocess(loc, ranges)
        with self._grid_lock:
            grid = self.grid
        params = loc.params
        seg = self._segments_for(grid) if params.fast_raycast else None
        count = loc.scan_count
        loc.scan_count += 1
        res = localize_step(grid, loc.pose, loc.last_pose, data, mask,
                            params, generator=self._draws(robot, count),
                            segments=seg)

        reg_error, significant, n_over = torch.stack(
            [res.reg_error.to(torch.int64), res.significant.to(torch.int64),
             res.rays_dropped.to(torch.int64)]).tolist()
        if n_over > 0:
            # the fast caster lost segments or beams to a fixed capacity
            # (or its cache was stale): re-render with the exact march, as
            # the JAX node's raycast_checked does, and log the pressure
            # (RayCastPolar2D's degradation warning analogue,
            # ThreadLocalize.cpp:354-358)
            native.log(native.LOG_WARN, "localize",
                       f"fast raycast overflowed by {n_over} "
                       "segments/beams; exact-march fallback used")
            res = localize_step(
                grid, loc.pose, loc.last_pose, data, mask,
                dataclasses.replace(params, fast_raycast=False),
                generator=self._draws(robot, count))
            reg_error, significant = torch.stack(
                [res.reg_error, res.significant]).tolist()
        loc.rays_dropped = n_over
        if reg_error:
            pose_msg = PoseStamped(math.nan, math.nan, math.nan,
                                   stamp=scan.stamp)
        else:
            loc.pose = res.pose
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
        for cb in self.pose_callbacks:
            cb(robot, pose_msg)
        self._broadcast_tf(robot, loc, pose_msg, scan.stamp)
        return pose_msg

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
        with self._write_lock:
            with self._grid_lock:
                grid = self.grid
            grid = self.mapper.drain(grid)
            with self._grid_lock:
                self.grid = grid
            if self._segments is not None:    # the fast caster is in use
                self._segments_for(grid)

    def publish_map(self, stamp: float = 0.0):
        """ThreadGrid cycle on the current grid state."""
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
