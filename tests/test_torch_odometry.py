"""The port's odometry rescue (slam/odometry.py), its node wiring and the
multi-seed ICP (registration/multi_init.py) against the JAX package's, in
float64 on the CPU.

Tolerances: the rescue's transforms and states within 1e-12 (the same
closed forms; sin, cos and acos may round differently in the last bits),
the rescue decision equal; multi-seed ICP and the node's pose traces
within 1e-9 and 1e-6 m, the bounds of the port's ICP and golden-loop
parity tests."""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ohm_tsd_slam_tpu import config as jcfg
from ohm_tsd_slam_tpu.core import se2 as jse2
from ohm_tsd_slam_tpu.registration.icp import IcpParams as JIcpParams
from ohm_tsd_slam_tpu.registration.multi_init import (
    icp_multi_init as jicp_multi_init,
)
from ohm_tsd_slam_tpu.slam import LaserScan as JLaserScan
from ohm_tsd_slam_tpu.slam import SlamNode as JSlamNode
from ohm_tsd_slam_tpu.slam import odometry as jodo
from ohm_tsd_slam_tpu_torch import config as tcfg
from ohm_tsd_slam_tpu_torch.core import se2
from ohm_tsd_slam_tpu_torch.registration.icp import IcpParams
from ohm_tsd_slam_tpu_torch.registration.multi_init import icp_multi_init
from ohm_tsd_slam_tpu_torch.sensor import polar2d as tpolar
from ohm_tsd_slam_tpu_torch.slam import LaserScan, SlamNode
from ohm_tsd_slam_tpu_torch.slam import odometry as todo
from ohm_tsd_slam_tpu_torch.utils.testing import (
    limit_cpu_threads,
    rect_walls,
    simulate_scan,
)

limit_cpu_threads()

F64 = torch.float64
TOL = 1e-12
ICP_TOL = 1e-9
POSE_TOL = 1e-6


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


# the four cases of tests/test_aux.py::TestOdomRescue: a second odometry
# pose 0.1 s after the first at the origin, then a scan match to check
CASES = {
    "plausible_motion_passes": dict(
        params=dict(cell_size=0.025), odom=(0.05, 0.0, 0.01), ok=True,
        T=(0.049, 0.001, 0.012), rescued=False),
    "implausible_motion_rescued": dict(
        params=dict(cell_size=0.025, trns_vel_max=1.5),
        odom=(0.05, 0.0, 0.0), ok=True, T=(1.0, 0.0, 0.0), rescued=True),
    "invalid_odometry_disables_rescue": dict(
        params=dict(cell_size=0.025), odom=(0.0, 0.0, 0.0), ok=False,
        T=(5.0, 0.0, 0.0), rescued=False),
    "laser_offset_conjugation": dict(
        params=dict(cell_size=0.025, tf_laser=(0.2, 0.0, math.pi / 2)),
        odom=(0.1, 0.0, 0.0), ok=True, T=(3.0, 0.0, 0.0), rescued=True),
}


def _jax_case(c):
    p = jodo.OdomRescueParams(**c["params"])
    st = jodo.init(p, jse2.make(0.0, 0.0, 0.0, dtype=jnp.float64), 0.0)
    st = jodo.update(st, jse2.make(*c["odom"], dtype=jnp.float64), 0.1,
                     odom_ok=c["ok"])
    return p, st, jodo.check(st, p, jse2.make(*c["T"], dtype=jnp.float64))


@pytest.mark.parametrize("name", list(CASES))
def test_check_and_update_match_jax(name):
    c = CASES[name]
    _, jst, (jT, jrescued) = _jax_case(c)
    p = todo.OdomRescueParams(**c["params"])
    st = todo.init(p, se2.make(0.0, 0.0, 0.0, dtype=F64), 0.0)
    st = todo.update(st, se2.make(*c["odom"], dtype=F64), 0.1,
                     odom_ok=c["ok"])
    T, rescued = todo.check(st, p, se2.make(*c["T"], dtype=F64))
    assert bool(rescued) == bool(jrescued) == c["rescued"]
    _close(T, jT)
    for f in todo.OdomState._fields:
        _close(getattr(st, f), getattr(jst, f))
    assert st.valid.dtype == torch.bool and st.dt.dtype == F64


@pytest.mark.parametrize("name", ["implausible_motion_rescued",
                                  "laser_offset_conjugation"])
def test_state_taken_across_from_jax(name):
    """from_arrays takes the JAX package's state as it is (numpy arrays of
    its fields); to_arrays gives them back unchanged."""
    c = CASES[name]
    jp, jst, (jT, _) = _jax_case(c)
    st = todo.from_arrays({f: np.asarray(getattr(jst, f))
                           for f in todo.OdomState._fields})
    T, rescued = todo.check(st, todo.OdomRescueParams(**c["params"]),
                            se2.make(*c["T"], dtype=F64))
    assert bool(rescued)
    _close(T, jT)
    back = todo.to_arrays(st)
    for f in todo.OdomState._fields:
        np.testing.assert_array_equal(back[f], np.asarray(getattr(jst, f)))
    f32 = todo.from_arrays(back, dtype=torch.float32)
    assert f32.dt.dtype == torch.float32 and f32.valid.dtype == torch.bool


def test_always_rescue_and_calc_angle():
    """The reference's literal if(1) replaces every match once the
    odometry is valid; calcAngle's [0, 2π) branches as in JAX."""
    p = todo.OdomRescueParams(always_rescue=True)
    st = todo.init(p, se2.make(0.0, 0.0, 0.0, dtype=F64), 0.0)
    T = se2.make(0.001, 0.0, 0.0, dtype=F64)
    assert not bool(todo.check(st, p, T)[1])           # not valid yet
    st = todo.update(st, se2.make(0.002, 0.0, 0.0, dtype=F64), 0.1)
    out, rescued = todo.check(st, p, T)
    assert bool(rescued)
    _close(out, st.rel_odom)
    jp = jodo.OdomRescueParams(always_rescue=True)
    jst = jodo.update(jodo.init(jp, jse2.make(0.0, 0.0, 0.0,
                                              dtype=jnp.float64), 0.0),
                      jse2.make(0.002, 0.0, 0.0, dtype=jnp.float64), 0.1)
    _close(out, jodo.check(jst, jp, jse2.make(0.001, 0.0, 0.0,
                                              dtype=jnp.float64))[0])
    for th in (0.0, 0.3, -0.3, 2.0, -2.0, math.pi):
        _close(todo.calc_angle_02pi(se2.make(0.0, 0.0, th, dtype=F64)),
               jodo._calc_angle(jse2.make(0.0, 0.0, th, dtype=jnp.float64)))


# -------------------------------------------------------------- multi-init

B = 361


def _clouds():
    """tests/test_aux.py's model and scene clouds, in float64."""
    geom = tpolar.SensorPolar2D(size=B, angular_res=math.radians(0.75),
                                phi_min=math.radians(-135.0), max_range=15.0)
    walls = rect_walls(1.0, 1.0, 9.0, 9.0)
    pm = se2.make(5.0, 5.0, 0.2, dtype=F64)
    ps = se2.make(5.08, 4.93, 0.26, dtype=F64)
    out = []
    for p in (pm, ps):
        r = simulate_scan(p.numpy(), B, geom.angular_res, geom.phi_min,
                          geom.max_range, segments=walls)
        data, mask = tpolar.standard_mask(geom, torch.from_numpy(r))
        out += list(tpolar.data_to_cartesian(geom, data, mask))
    return out, (se2.invert(pm) @ ps).numpy()


def test_multi_init_picks_the_best_seed_as_jax():
    """tests/test_aux.py::TestMultiInit: one good seed among two bad ones
    wins, and a T_last carry, appended last, wins over the bad seeds; the
    winner, its pair count and transform as the JAX package's."""
    (M, Mm, S, Sm), T_true = _clouds()
    jclouds = [jnp.asarray(x.numpy()) for x in (M, Mm, S, Sm)]
    good = torch.from_numpy(T_true)
    bad1 = se2.make(2.0, -2.0, 1.2, dtype=F64)
    bad2 = se2.make(-1.5, 1.0, -1.0, dtype=F64)
    seeds = torch.stack([bad1, good, bad2])
    res = icp_multi_init(M, Mm, S, Sm, seeds, IcpParams(iterations=20))
    jres = jicp_multi_init(*jclouds, jnp.asarray(seeds.numpy()),
                           JIcpParams(iterations=20))
    assert int(res.best_seed) == int(jres.best_seed) == 1
    assert int(res.pairs) == int(jres.pairs)
    assert int(res.iterations) == int(jres.iterations)
    _close(res.T, jres.T, ICP_TOL)
    _close(res.rms, jres.rms, ICP_TOL)
    assert math.hypot(float(res.T[0, 2]) - T_true[0, 2],
                      float(res.T[1, 2]) - T_true[1, 2]) < 0.05

    two = torch.stack([bad1, bad2])
    res2 = icp_multi_init(M, Mm, S, Sm, two, IcpParams(iterations=20),
                          T_last=res.T_last)
    jres2 = jicp_multi_init(*jclouds, jnp.asarray(two.numpy()),
                            JIcpParams(iterations=20), T_last=jres.T_last)
    assert int(res2.best_seed) == int(jres2.best_seed) == 2
    _close(res2.T, jres2.T, ICP_TOL)
    assert torch.equal(res2.T_last, res2.T)


# ------------------------------------------------------------ node rescue

BEAMS, RES, PHI0, RMAX = 361, math.radians(0.75), math.radians(-135), 9.0


def _rescue_config(cfg):
    """tests/test_slam_e2e.py::test_slam_odom_rescue's node, from the
    config module `cfg` of either package."""
    return cfg.SlamConfig(
        grid=cfg.GridConfig(map_size=8, cellsize=0.04, truncation_radius=3.0),
        robots=[cfg.RobotConfig(
            local_offset_yaw=0.2,
            sensor=cfg.SensorConfig(max_range=RMAX, min_range=0.01,
                                    low_reflectivity_range=1.0),
            registration=cfg.RegistrationConfig(
                icp=cfg.IcpConfig(iterations=30, dist_filter_max=0.5,
                                  dist_filter_min=0.05)),
            odom=cfg.OdomRescueConfig(use_odom_rescue=True))])


def _rescue_run(node, scan_cls):
    """Odometry says the robot stands still, scans 0.1 s apart; the fourth
    scan is taken 0.35 m away (3.5 m/s): the rescue replaces the match."""
    x, y, th = 5.12, 5.12, 0.2
    poses = []
    for k, dx in enumerate((0.0, 0.0, 0.0, 0.35, 0.0)):
        pose = se2.make(x + dx, y, th, dtype=F64).numpy()
        r = simulate_scan(pose, BEAMS, RES, PHI0, RMAX,
                          segments=rect_walls(1.5, 1.5, 8.5, 8.5),
                          circles=[((7.0, 7.2), 0.5), ((3.0, 7.5), 0.35)])
        node.on_odometry(0, 0.0, 0.0, 0.0, stamp=0.1 * k)
        out = node.process_scan(0, scan_cls(
            ranges=r, angle_min=PHI0, angle_increment=RES, range_max=RMAX,
            stamp=0.1 * k))
        assert k == 0 or (out is not None and not out.is_nan), k
        poses.append(np.array(node.localizers[0].pose))
    return np.asarray(poses)


def test_node_rescue_matches_jax_node():
    """SlamNode with use_odom_rescue fed through on_odometry: the jump is
    replaced by the odometry delta (no NaN, the pose stays), and the pose
    trace and the rescue state equal the JAX node's."""
    node = SlamNode(_rescue_config(tcfg), dtype=F64, device="cpu")
    trace = _rescue_run(node, LaserScan)
    jnode = JSlamNode(_rescue_config(jcfg), dtype=jnp.float64)
    jtrace = _rescue_run(jnode, JLaserScan)
    loc = node.localizers[0]
    assert loc.params.odom is not None and loc.params.odom.cell_size == 0.04
    assert bool(loc.odom_state.valid)
    assert math.hypot(*(trace[3, :2, 2] - trace[2, :2, 2])) < 0.01
    np.testing.assert_allclose(trace, jtrace, rtol=0, atol=POSE_TOL)
    jst = jnode.localizers[0].odom_state
    for f in todo.OdomState._fields:
        _close(getattr(loc.odom_state, f), getattr(jst, f))


def test_node_without_odometry_skips_the_rescue():
    """The rescue is on but no odometry has come: the node localizes as
    without it (no state, no NaN), as the JAX node does."""
    cfg = _rescue_config(tcfg)
    node = SlamNode(cfg, dtype=F64, device="cpu")
    plain = SlamNode(dataclasses.replace(cfg, robots=[dataclasses.replace(
        cfg.robots[0], odom=tcfg.OdomRescueConfig())]), dtype=F64,
        device="cpu")
    for k in range(3):
        pose = se2.make(5.12 + 0.02 * k, 5.12, 0.2, dtype=F64).numpy()
        r = simulate_scan(pose, BEAMS, RES, PHI0, RMAX,
                          segments=rect_walls(1.5, 1.5, 8.5, 8.5))
        for n in (node, plain):
            n.process_scan(0, LaserScan(ranges=r, angle_min=PHI0,
                                        angle_increment=RES, range_max=RMAX,
                                        stamp=float(k)))
    assert node.localizers[0].odom_state is None
    assert torch.equal(node.localizers[0].pose, plain.localizers[0].pose)
