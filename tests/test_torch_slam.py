"""The port's SlamNode and localize_step on the CPU (float64): the helpers
of the golden replays (tests/test_torch_slam_golden*.py hold the 25-scan
golden loop against the compiled C++ reference, golden/data/slam.bin, and
against the JAX SlamNode; tests/test_torch_slam_tsd_golden.py the TSD-mode
loop), and on a small room the node's segment cache and overflow
fallback, its per-scan draw streams, tf chain, NaN sentinel, the options
`from_config` builds and the threaded runtime."""

import dataclasses
import math
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ohm_tsd_slam_tpu import config as jcfg
from ohm_tsd_slam_tpu.slam import LaserScan as JLaserScan
from ohm_tsd_slam_tpu.slam import SlamNode as JSlamNode
from ohm_tsd_slam_tpu.slam import localize as jlocalize
from ohm_tsd_slam_tpu_torch import config as tcfg
from ohm_tsd_slam_tpu_torch.grid import raycast_fast as rf
from ohm_tsd_slam_tpu_torch.core import se2
from ohm_tsd_slam_tpu_torch.registration.icp import IcpParams
from ohm_tsd_slam_tpu_torch.sensor.polar2d import SensorPolar2D
from ohm_tsd_slam_tpu_torch.slam import LocalizeParams, SlamNode
from ohm_tsd_slam_tpu_torch.slam import localize as tlocalize
from ohm_tsd_slam_tpu_torch.slam import node as tnode
from ohm_tsd_slam_tpu_torch.slam.messages import LaserScan, PoseStamped
from ohm_tsd_slam_tpu_torch.utils.testing import (
    limit_cpu_threads,
    rect_walls,
    simulate_scan,
)

from golden_io import GOLDEN_DIR, load_golden

limit_cpu_threads()

SLAM_BIN = os.path.join(GOLDEN_DIR, "data", "slam.bin")
SLAM_NPZ = os.path.join(GOLDEN_DIR, "data", "slam_inputs.npz")

# float64 replay; the port renders with the same exact march (or the same
# isocontour caster) as both references, so only last-bit rounding
# separates the pose traces
POSE_TOL = 1e-6


def _cpu_node(cfg, **kwargs):
    """The port's node in float64 on the CPU (its default is the card)."""
    return SlamNode(cfg, dtype=torch.float64, device="cpu", **kwargs)


def test_node_defaults_to_the_card():
    """Without a device the node goes to the card, and says so where
    there is none rather than falling back to the CPU."""
    if torch.cuda.is_available():
        assert SlamNode(ROOM_CFG).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            SlamNode(ROOM_CFG)


def _exact_march(params_cls, monkeypatch):
    """Make `params_cls.from_config` render with the exact march."""
    from_config = params_cls.from_config

    def exact_march(*args, **kwargs):
        return dataclasses.replace(from_config(*args, **kwargs),
                                   fast_raycast=False)

    monkeypatch.setattr(params_cls, "from_config", staticmethod(exact_march))


def _golden_config(cfg):
    """The configuration tests/test_reference_parity_slam.py builds, from
    the config module `cfg` of either package."""
    inp = np.load(SLAM_NPZ)
    (cellsize, layout_grid, max_trunc, size, ang_res, phi_min, max_range,
     min_range, low_refl, icp_iters, dist_max, dist_min, trns_max,
     rot_max, trns_min, rot_min) = inp["params"]
    fp_w, fp_h = inp["footprint"]
    return cfg.SlamConfig(
        grid=cfg.GridConfig(map_size=int(layout_grid),
                            cellsize=float(cellsize),
                            truncation_radius=float(max_trunc / cellsize)),
        robots=[cfg.RobotConfig(
            local_offset_yaw=0.2,
            sensor=cfg.SensorConfig(max_range=float(max_range),
                                    min_range=float(min_range),
                                    low_reflectivity_range=float(low_refl),
                                    laser_min_range=0.0),
            footprint=cfg.FootprintConfig(width=float(fp_w),
                                          height=float(fp_h), x_offset=0.0),
            registration=cfg.RegistrationConfig(
                trns_thresh=float(trns_max), rot_thresh=float(rot_max),
                trns_min=float(trns_min), rot_min=float(rot_min),
                icp=cfg.IcpConfig(iterations=int(icp_iters),
                                  dist_filter_max=float(dist_max),
                                  dist_filter_min=float(dist_min))),
        )],
    )


def _replay(node, scan_cls):
    """Replay the golden scans; returns poses [N,3,3], significance flags
    and registration-error flags as the golden harness records them."""
    inp = np.load(SLAM_NPZ)
    scans = inp["scans"]
    (_, _, _, _, ang_res, phi_min, max_range) = inp["params"][:7]
    poses, sig, err = [], [], []
    for k in range(len(scans)):
        ranges = np.where(scans[k] >= 1e29, np.inf, scans[k])
        msg = scan_cls(ranges=ranges, angle_min=float(phi_min),
                       angle_increment=float(ang_res),
                       range_max=float(max_range), stamp=float(k))
        out = node.process_scan(0, msg)
        loc = node.localizers[0]
        pose = np.array(loc.pose)
        poses.append(pose)
        if k == 0:
            assert out is None
            sig.append(1)                       # the init push
            err.append(0)
        else:
            err.append(int(math.isnan(out.x)))
            sig.append(int(np.array_equal(np.array(loc.last_pose), pose)))
    return np.asarray(poses), np.asarray(sig), np.asarray(err)


def _assert_traces_close(got, want):
    dpos = np.abs(got[:, :2, 2] - want[:, :2, 2]).max()
    drot = np.abs(got[:, 0, 0] - want[:, 0, 0]).max()
    assert dpos < POSE_TOL, dpos
    assert drot < POSE_TOL, drot


def _assert_matches_reference(replay):
    golden = load_golden(SLAM_BIN)
    poses, sig, err = replay
    flags = np.asarray(golden["flags"])
    np.testing.assert_array_equal(err, flags[:, 0], err_msg="error gates")
    assert err.sum() == 0
    np.testing.assert_array_equal(sig, flags[:, 1],
                                  err_msg="significance gates")
    _assert_traces_close(
        poses, np.asarray(golden["pose_trace"]).reshape(-1, 3, 3))


def _assert_matches_jax_node(replay, fast):
    jnode = JSlamNode(_golden_config(jcfg), dtype=jnp.float64)
    jposes, jsig, jerr = _replay(jnode, JLaserScan)
    assert jnode.localizers[0].params.fast_raycast == fast
    poses, sig, err = replay
    np.testing.assert_array_equal(err, jerr)
    np.testing.assert_array_equal(sig, jsig)
    _assert_traces_close(poses, jposes)


def test_node_extracts_once_per_grid_version(monkeypatch):
    """The segment cache is rebuilt after each mapper drain (and the
    initial push) and reused by every scan in between: the compiled
    extraction that the node calls, as the JAX node calls its jitted
    one."""
    calls = []
    extract = tnode.extract_segments_jit

    def counted(grid, *a, **k):
        calls.append(grid.tsd)
        return extract(grid, *a, **k)

    monkeypatch.setattr(tnode, "extract_segments_jit", counted)
    node = _cpu_node(ROOM_CFG)
    pushes = 0
    for k in range(6):
        before = node.grid.tsd
        node.process_scan(0, _room_scan(5.12 + 0.03 * k, float(k)))
        pushes += node.grid.tsd is not before
        assert node._segments.tsd is node.grid.tsd
    assert pushes >= 3
    assert len(calls) == pushes                 # init push included
    assert len({id(t) for t in calls}) == len(calls)


def test_node_overflow_reruns_exact_march(monkeypatch):
    """A segment overflow on every scan: the step's guard renders each
    scan with the exact march inside the step (raycast_checked), so the
    node's trace is the exact-march node's, bit for bit, and the drop
    count is kept on the localizer."""
    scans = [_room_scan(5.12 + 0.03 * k, float(k)) for k in range(5)]
    with pytest.MonkeyPatch.context() as mp:
        _exact_march(tlocalize.LocalizeParams, mp)
        exact = _cpu_node(ROOM_CFG)
        want = []
        for msg in scans:
            exact.process_scan(0, msg)
            want.append(exact.localizers[0].pose.clone())
    monkeypatch.setattr(rf, "MAX_SEGMENTS", 128)
    node = _cpu_node(ROOM_CFG)
    for msg, pose in zip(scans, want):
        node.process_scan(0, msg)
        assert torch.equal(node.localizers[0].pose, pose)
    loc = node.localizers[0]
    assert loc.params.fast_raycast and loc.rays_dropped > 0
    assert int(node._segments.n_dropped) > 0


# a small room run (tests/test_slam_e2e.py's settings)
BEAMS, RES, PHI0, RMAX = 361, math.radians(0.75), math.radians(-135), 9.0
ROOM_CFG = tcfg.SlamConfig(
    grid=tcfg.GridConfig(map_size=8, cellsize=0.04),
    robots=[tcfg.RobotConfig(
        local_offset_yaw=0.2,
        sensor=tcfg.SensorConfig(max_range=RMAX, min_range=0.01,
                                 low_reflectivity_range=1.0),
        registration=tcfg.RegistrationConfig(
            icp=tcfg.IcpConfig(iterations=30, dist_filter_max=0.5,
                               dist_filter_min=0.05)))],
    grid_pub=tcfg.GridPubConfig(interval_s=0.5))


def _room_scan(x, stamp, y=5.12, th=0.2):
    pose = se2.make(x, y, th, dtype=torch.float64).numpy()
    r = simulate_scan(pose, BEAMS, RES, PHI0, RMAX,
                      segments=rect_walls(1.5, 1.5, 8.5, 8.5),
                      circles=[((7.0, 7.2), 0.5)])
    return LaserScan(ranges=r, angle_min=PHI0, angle_increment=RES,
                     range_max=RMAX, stamp=stamp)


def _ransac_cfg(mode):
    """ROOM_CFG with a RANSAC pre-registration mode at a small size."""
    rc = ROOM_CFG.robots[0]
    reg = dataclasses.replace(
        rc.registration, mode=tcfg.RegMode(mode),
        ransac=tcfg.RansacConfig(trials=20, size_control_set=40),
        beam_model=tcfg.BeamModelConfig(max_range=RMAX))
    return dataclasses.replace(
        ROOM_CFG, robots=[dataclasses.replace(rc, registration=reg)])


def _room_trace(node, n=8):
    poses, errs = [], []
    for k in range(n):
        x = 5.12 + 0.03 * k
        out = node.process_scan(0, _room_scan(x, float(k)))
        pose = node.localizers[0].pose
        poses.append(pose.clone())
        if k:
            assert out is not None and not out.is_nan, k
            errs.append(math.hypot(float(pose[0, 2]) - x,
                                   float(pose[1, 2]) - 5.12))
    return torch.stack(poses), max(errs)


def test_node_gives_each_robot_and_scan_its_own_stream():
    node = _cpu_node(ROOM_CFG, seed=9)
    seeds = {node._draws(r, k).initial_seed() for r in range(3)
             for k in range(50)}
    assert len(seeds) == 150
    a = torch.rand(4, generator=node._draws(1, 7))
    assert torch.equal(a, torch.rand(4, generator=node._draws(1, 7)))
    other = _cpu_node(ROOM_CFG, seed=10)
    assert other._draws(1, 7).initial_seed() not in seeds


def test_node_overflow_rerun_draws_the_same_stream(monkeypatch):
    """TSD mode with a segment overflow on every scan: the guard inside
    the step renders with the exact march before the matcher draws, so
    the draws, and the trace, equal those of a node rendering with the
    exact march from the same seed, bit for bit."""
    cfg = _ransac_cfg(3)
    with pytest.MonkeyPatch.context() as mp:
        _exact_march(tlocalize.LocalizeParams, mp)
        want, _ = _room_trace(_cpu_node(cfg, seed=2), 5)
    monkeypatch.setattr(rf, "MAX_SEGMENTS", 128)
    node = _cpu_node(cfg, seed=2)
    got, _ = _room_trace(node, 5)
    assert node.localizers[0].rays_dropped > 0
    assert torch.equal(got, want)


def test_localize_step_takes_a_prereg_seed():
    """T_prereg overrides the matcher dispatch in every mode, and the ICP
    result from a seed differs from the unseeded one only slightly."""
    node = _cpu_node(ROOM_CFG)
    node.process_scan(0, _room_scan(5.12, 0.0))
    loc = node.localizers[0]
    data, mask = node._preprocess(
        loc, np.asarray(_room_scan(5.16, 1.0).ranges, dtype=np.float64))
    seed = se2.make(0.03, 0.0, 0.0, dtype=torch.float64)
    base = tlocalize.localize_step(node.grid, loc.pose, loc.last_pose, data,
                                   mask, loc.params, T_prereg=seed)
    for mode in (1, 2, 3):
        params = LocalizeParams.from_config(
            _ransac_cfg(mode).robots[0].registration, loc.geom)
        res = tlocalize.localize_step(node.grid, loc.pose, loc.last_pose,
                                      data, mask, params, T_prereg=seed)
        assert torch.equal(res.T, base.T)
    assert abs(float(base.pose[0, 2]) - 5.16) < 0.05


def test_tf_map_odom_broadcast():
    """sendTransform's chain (ThreadLocalize.cpp:604-689): identity before
    the odom hop is known, pose·T(laser->footprint)·T(footprint->odom)
    after, NaN tf for the NaN pose sentinel."""
    node = _cpu_node(ROOM_CFG)
    tfs = []
    node.tf_callbacks.append(lambda r, tf: tfs.append(tf))
    node.set_static_tf(0, 0.10, 0.02, 0.05)
    node.process_scan(0, _room_scan(5.12, 0.0))
    node.process_scan(0, _room_scan(5.14, 1.0))
    assert len(tfs) == 1 and tfs[0].x == 0.0 and tfs[0].theta == 0.0

    node.on_footprint_odom(0, -0.30, 0.05, -0.10)
    out = node.process_scan(0, _room_scan(5.16, 2.0))
    assert out is not None and not out.is_nan and len(tfs) == 2
    expect = (se2.make(out.x, out.y, out.theta, dtype=torch.float64)
              @ se2.make(0.10, 0.02, 0.05, dtype=torch.float64)
              @ se2.make(-0.30, 0.05, -0.10, dtype=torch.float64)).numpy()
    # float64 host arithmetic on both sides
    assert abs(tfs[-1].x - expect[0, 2]) < 1e-9
    assert abs(tfs[-1].y - expect[1, 2]) < 1e-9
    assert abs(tfs[-1].theta - math.atan2(expect[1, 0], expect[0, 0])) < 1e-9

    node._broadcast_tf(0, node.localizers[0],
                       PoseStamped(math.nan, math.nan, math.nan), 3.0)
    assert math.isnan(tfs[-1].x) and math.isnan(tfs[-1].theta)


def test_registration_error_gives_nan_sentinel():
    """A scan from 0.35 m away is registered beyond reg_trs_max=0.25:
    NaN pose published, pose kept (ThreadLocalize.cpp:381-387)."""
    node = _cpu_node(ROOM_CFG)
    node.process_scan(0, _room_scan(5.12, 0.0))
    node.process_scan(0, _room_scan(5.12, 1.0))
    before = node.localizers[0].pose.clone()
    out = node.process_scan(0, _room_scan(5.47, 2.0))
    assert out is not None and out.is_nan
    assert torch.equal(node.localizers[0].pose, before)


@pytest.mark.parametrize("kwargs,item", [
    ({"mode": 5}, "item 12"),
    ({"mode": 4}, "item 13"),
])
def test_unported_options_raise(kwargs, item):
    """The modes AMCL (ported by ROADMAP.md queue 1 item 12) and GN (item
    13) no longer raise: from_config builds them with the matcher's
    parameters equal to the JAX package's."""
    geom = SensorPolar2D(size=BEAMS, angular_res=RES, phi_min=PHI0,
                         max_range=RMAX)
    mode = kwargs["mode"]
    amcl = dict(particles=64, iterations=3, sigma_trans=0.3, sigma_rot=0.1)
    reg = dataclasses.replace(ROOM_CFG.robots[0].registration,
                              mode=tcfg.RegMode(mode),
                              amcl=tcfg.AmclConfig(**amcl))
    params = LocalizeParams.from_config(reg, geom)
    jparams = jlocalize.LocalizeParams.from_config(
        jcfg.RegistrationConfig(mode=jcfg.RegMode(mode),
                                amcl=jcfg.AmclConfig(**amcl)), geom)
    assert params.mode == jparams.mode == mode
    assert dataclasses.asdict(params.amcl) == dataclasses.asdict(jparams.amcl)
    assert dataclasses.asdict(params.gn) == dataclasses.asdict(jparams.gn)
    assert LocalizeParams(geom=geom, icp=IcpParams(), **kwargs).mode == mode


@pytest.mark.parametrize("mode", [1, 2, 3])
def test_ransac_modes_are_accepted(mode):
    """from_config fills the matcher's parameters as the JAX package's
    does; a RANSAC mode without them is refused at construction."""
    geom = SensorPolar2D(size=BEAMS, angular_res=RES, phi_min=PHI0,
                         max_range=RMAX)
    reg = _ransac_cfg(mode).robots[0].registration
    params = LocalizeParams.from_config(reg, geom)
    jparams = jlocalize.LocalizeParams.from_config(
        jcfg.RegistrationConfig(
            mode=jcfg.RegMode(mode),
            ransac=jcfg.RansacConfig(trials=20, size_control_set=40)), geom)
    assert params.mode == jparams.mode == mode
    for f in ("trials", "eps_thresh", "size_control_set", "phi_max",
              "resolution", "zrand_tsd", "span"):
        assert getattr(params.ransac, f) == getattr(jparams.ransac, f), f
    assert params.beam == reg.beam_model
    with pytest.raises(ValueError, match="ransac"):
        LocalizeParams(geom=geom, icp=IcpParams(), mode=mode)


def test_from_config_uses_fast_caster():
    """The fast caster is the default renderer, as in the JAX package."""
    rc = ROOM_CFG.robots[0]
    geom = SensorPolar2D(size=BEAMS, angular_res=RES, phi_min=PHI0,
                         max_range=RMAX)
    params = LocalizeParams.from_config(rc.registration, geom)
    jparams = jlocalize.LocalizeParams.from_config(
        jcfg.RegistrationConfig(), geom)
    assert params.fast_raycast and jparams.fast_raycast
    assert LocalizeParams(geom=geom, icp=IcpParams()).fast_raycast


def test_odom_rescue_raises():
    """The odometry rescue (ported by ROADMAP.md queue 1 item 14) no longer
    raises: from_config builds the same OdomRescueParams as the JAX
    package's, cell size included, and none without use_odom_rescue."""
    rc = ROOM_CFG.robots[0]
    geom = SensorPolar2D(size=BEAMS, angular_res=RES, phi_min=PHI0,
                         max_range=RMAX)
    odom = dict(use_odom_rescue=True, laser_x=0.2, laser_y=-0.05,
                laser_yaw=0.3, trns_vel_max=1.2, rot_vel_max=3.0)
    params = LocalizeParams.from_config(
        rc.registration, geom, odom_cfg=tcfg.OdomRescueConfig(**odom),
        cell_size=0.04)
    jparams = jlocalize.LocalizeParams.from_config(
        jcfg.RegistrationConfig(), geom,
        odom_cfg=jcfg.OdomRescueConfig(**odom), cell_size=0.04)
    assert dataclasses.asdict(params.odom) == dataclasses.asdict(jparams.odom)
    assert params.odom.cell_size == 0.04
    assert LocalizeParams.from_config(
        rc.registration, geom, odom_cfg=tcfg.OdomRescueConfig()).odom is None


def test_threaded_runtime():
    """start/on_scan/stop: localizer, mapper and grid threads over the
    latest-wins channels publish poses that track the motion."""
    node = _cpu_node(ROOM_CFG)
    got = []
    node.pose_callbacks.append(lambda robot, msg: got.append((robot, msg)))
    scan = _room_scan

    node.on_scan(0, scan(5.12, 0.0))       # initializes synchronously
    assert node.localizers[0].initialized
    node.start()
    try:
        for k in range(1, 6):
            node.on_scan(0, scan(5.12 + 0.02 * k, float(k)))
            time.sleep(0.3)
        deadline = time.time() + 20.0
        while not got and time.time() < deadline:
            time.sleep(0.1)
    finally:
        node.stop()
    assert not node._threads
    assert got, "no poses published by the localizer thread"
    last = node.localizers[0].pose.numpy()
    assert abs(last[0, 2] - 5.12) < 0.2 and not math.isnan(last[0, 2])
    assert node.grid_pub.get_map() is not None
