"""The port's Monte-Carlo matcher (registration/amcl.py) and mode AMCL of
the node against the JAX package's, in float64 on the CPU.

The two packages cannot draw the same numbers, so the comparison hands the
port JAX's own draws through `AmclInject`: the test splits the key as
ohm_tsd_slam_tpu/registration/amcl.py::match_amcl does (`split(key, 3)`,
the control set, the three normal draws of `k_init` and its two
`fold_in`s, then `split(k_scan, iterations)` and `split(it_key)` for each
iteration's resampling offset and jitter).  Tolerances: log-likelihoods
within 1e-12, resampled indices equal, the matcher's transform within
1e-9 (64 particles, 3 iterations)."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ohm_tsd_slam_tpu.grid.state import TsdGrid as JTsdGrid
from ohm_tsd_slam_tpu.registration import amcl as jamcl
from ohm_tsd_slam_tpu.registration import ransac as jr
from ohm_tsd_slam_tpu_torch import config as tcfg
from ohm_tsd_slam_tpu_torch.config import GridConfig
from ohm_tsd_slam_tpu_torch.core import se2
from ohm_tsd_slam_tpu_torch.grid.push import push
from ohm_tsd_slam_tpu_torch.grid.state import create, to_arrays
from ohm_tsd_slam_tpu_torch.registration import amcl as tamcl
from ohm_tsd_slam_tpu_torch.sensor import polar2d as tpolar
from ohm_tsd_slam_tpu_torch.slam import LaserScan, SlamNode
from ohm_tsd_slam_tpu_torch.utils.testing import (
    limit_cpu_threads,
    rect_walls,
    simulate_scan,
)

limit_cpu_threads()

F64 = torch.float64
TOL = 1e-9
GEOM = dict(size=361, angular_res=math.radians(0.75),
            phi_min=math.radians(-135.0), max_range=9.0,
            min_range=0.01, low_reflectivity_range=1.0)
POSE = (5.12, 5.12, 0.2)
OFFSET = (0.12, -0.08, 0.06)
PARAMS = dict(particles=64, iterations=3, sigma_trans=0.2, sigma_rot=0.15)
FIELDS = ("tsd", "weight", "tile_init", "tile_initw")
WALLS = rect_walls(1.5, 1.5, 8.5, 8.5)
CIRCLES = [((7.0, 7.2), 0.5), ((3.0, 7.5), 0.35)]


def _scan(pose):
    return simulate_scan(pose.numpy(), GEOM["size"], GEOM["angular_res"],
                         GEOM["phi_min"], GEOM["max_range"],
                         segments=WALLS, circles=CIRCLES)


@pytest.fixture(scope="module")
def case():
    """A grid of three pushes from POSE (both packages), and the scene of
    a scan taken from POSE · OFFSET."""
    geom = tpolar.SensorPolar2D(**GEOM)
    pose = se2.make(*POSE, dtype=F64)
    data, mask = tpolar.standard_mask(geom, torch.from_numpy(_scan(pose)))
    g = create(GridConfig(map_size=8, cellsize=0.04), dtype=F64,
               device="cpu")
    for _ in range(3):
        g = push(g, geom, pose, data, mask)
    d = to_arrays(g)
    jg = JTsdGrid(**{f: jnp.asarray(d[f]) for f in FIELDS},
                  cell_size=d["cell_size"],
                  max_truncation=d["max_truncation"],
                  max_weight=d["max_weight"], tile_dim=d["tile_dim"])
    true = pose @ se2.make(*OFFSET, dtype=F64)
    data2, mask2 = tpolar.standard_mask(geom, torch.from_numpy(_scan(true)))
    scene, smask = tpolar.data_to_cartesian(geom, data2, mask2)
    return dict(grid=g, jgrid=jg, pose=pose, scene=scene, smask=smask)


def _j(t):
    return jnp.asarray(t.numpy())


def _t(a):
    return torch.from_numpy(np.array(a))


def jax_draws(key, scene_mask, params):
    """The draws match_amcl makes from `key`, mirrored line for line
    (ohm_tsd_slam_tpu/registration/amcl.py:110-147), as an AmclInject."""
    P, dtype = params.particles, jnp.float64
    k_ctrl, k_init, k_scan = jax.random.split(key, 3)
    idx, ctrl_mask = jr.random_valid_subset(k_ctrl, scene_mask,
                                            params.size_control_set)
    p0 = jnp.stack([
        params.sigma_trans * jax.random.normal(k_init, (P,), dtype=dtype),
        params.sigma_trans * jax.random.normal(
            jax.random.fold_in(k_init, 1), (P,), dtype=dtype),
        params.sigma_rot * jax.random.normal(
            jax.random.fold_in(k_init, 2), (P,), dtype=dtype),
    ], axis=1)
    u0, noise = [], []
    for it_key in jax.random.split(k_scan, params.iterations):
        k_res, k_jit = jax.random.split(it_key)
        u0.append(jax.random.uniform(k_res, (), minval=0.0, maxval=1.0 / P))
        noise.append(jax.random.normal(k_jit, (P, 3), dtype=dtype))
    return tamcl.AmclInject(ctrl_idx=_t(idx), ctrl_valid=_t(ctrl_mask),
                            p0=_t(p0), u0=_t(jnp.stack(u0)),
                            noise=_t(jnp.stack(noise)))


def test_log_likelihood_matches_jax(case):
    rng = np.random.default_rng(1)
    parts = rng.normal(0.0, [0.2, 0.2, 0.1], (64, 3))
    idx = rng.choice(int(case["smask"].shape[0]), 50, replace=False)
    ctrl = case["scene"][idx]
    cmask = case["smask"][idx].clone()
    cmask[:5] = False
    got = tamcl._log_likelihood(case["grid"], case["pose"], ctrl, cmask,
                                torch.from_numpy(parts), 0.25)
    want = jamcl._log_likelihood(case["jgrid"], _j(case["pose"]), _j(ctrl),
                                 _j(cmask), jnp.asarray(parts), 0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)
    assert float(got.min()) < float(got.max()) < 0.0


@pytest.mark.parametrize("spread", [0.5, 5.0, 80.0])
def test_systematic_resample_matches_jax(spread):
    """Left-sided search of u0 + k/P in the cumulative weights: the same
    indices as JAX from the same offset, for flat and peaked weights."""
    rng = np.random.default_rng(int(spread))
    logw = rng.normal(0.0, spread, 64)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        want = jamcl._systematic_resample(key, jnp.asarray(logw))
        u0 = jax.random.uniform(key, (), minval=0.0, maxval=1.0 / 64)
        got = tamcl._systematic_resample(_t(u0), torch.from_numpy(logw))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [3, 11])
def test_match_amcl_with_jax_draws(case, seed):
    """JAX's draws in the port: the same transform, and the offset
    recovered within 6 cm and 3 degrees (tests/test_inventory.py)."""
    jp = jamcl.AmclParams(**PARAMS)
    key = jax.random.PRNGKey(seed)
    inject = jax_draws(key, _j(case["smask"]), jp)
    T = tamcl.match_amcl(None, case["grid"], case["pose"], case["scene"],
                         case["smask"], tamcl.AmclParams(**PARAMS),
                         inject=inject)
    jT = jamcl.match_amcl(key, case["jgrid"], _j(case["pose"]),
                          _j(case["scene"]), _j(case["smask"]), jp)
    np.testing.assert_allclose(T.numpy(), np.asarray(jT), rtol=TOL,
                               atol=TOL)
    assert not torch.equal(T, torch.eye(3, dtype=F64))


def test_match_amcl_own_draws(case):
    """The port's own draws: a function of the generator's seed, particle
    0 pinned to the prior, and the offset recovered as the JAX test asks
    (768 particles, 10 iterations, tests/test_inventory.py)."""
    p = tamcl.AmclParams(particles=768, iterations=10, sigma_trans=0.2,
                         sigma_rot=0.15)
    args = (case["grid"], case["pose"], case["scene"], case["smask"], p)
    T = tamcl.match_amcl(torch.Generator().manual_seed(3), *args)
    again = tamcl.match_amcl(torch.Generator().manual_seed(3), *args)
    assert torch.equal(T, again)
    want = se2.make(*OFFSET, dtype=F64).numpy()
    assert np.linalg.norm(T[:2, 2].numpy() - want[:2, 2]) < 0.06
    assert abs(float(se2.angle(T)) - OFFSET[2]) < math.radians(3.0)
    with pytest.raises(ValueError, match="Generator"):
        tamcl.match_amcl(None, *args)


# a small room run of the node (tests/test_slam_e2e.py's settings)
BEAMS, RES, PHI0, RMAX = 361, math.radians(0.75), math.radians(-135), 9.0


def _amcl_node(seed):
    cfg = tcfg.SlamConfig(
        grid=tcfg.GridConfig(map_size=8, cellsize=0.04,
                             truncation_radius=3.0),
        robots=[tcfg.RobotConfig(
            local_offset_yaw=0.2,
            sensor=tcfg.SensorConfig(max_range=RMAX, min_range=0.01,
                                     low_reflectivity_range=1.0),
            registration=tcfg.RegistrationConfig(
                mode=tcfg.RegMode.AMCL, trns_thresh=1.0, rot_thresh=0.9,
                icp=tcfg.IcpConfig(iterations=30, dist_filter_max=0.5,
                                   dist_filter_min=0.05),
                amcl=tcfg.AmclConfig(particles=512, iterations=8,
                                     sigma_trans=0.3, sigma_rot=0.1)))])
    return SlamNode(cfg, dtype=F64, device="cpu", seed=seed), cfg


def _kidnap_run(node):
    """Two scans from the start, then one from 0.35 m / 0.35 m away while
    the estimate stays put (tests/test_slam_e2e.py:260-290)."""
    x, y, th = 5.12, 5.12, 0.2
    poses = []
    for k, (dx, dy) in enumerate(((0.0, 0.0), (0.0, 0.0), (0.35, 0.35))):
        pose = se2.make(x + dx, y + dy, th, dtype=F64)
        r = simulate_scan(pose.numpy(), BEAMS, RES, PHI0, RMAX,
                          segments=WALLS, circles=CIRCLES)
        out = node.process_scan(0, LaserScan(
            ranges=r, angle_min=PHI0, angle_increment=RES, range_max=RMAX,
            stamp=float(k)))
        assert k == 0 or (out is not None and not out.is_nan), k
        poses.append(node.localizers[0].pose.clone())
    return torch.stack(poses)


def test_node_relocalizes_after_kidnap_in_amcl_mode():
    """Mode AMCL through SlamNode: after the kidnap (beyond plain ICP's
    basin) the node relocalizes within 3 cells, and the same seed gives
    the same trace."""
    node, cfg = _amcl_node(seed=7)
    trace = _kidnap_run(node)
    loc = node.localizers[0]
    assert loc.params.mode == int(tcfg.RegMode.AMCL)
    assert dataclasses.astuple(loc.params.amcl)[:4] == (512, 8, 0.3, 0.1)
    err = math.hypot(float(trace[-1, 0, 2]) - 5.47,
                     float(trace[-1, 1, 2]) - 5.47)
    assert err < 3.0 * cfg.grid.cellsize, err
    assert torch.equal(trace, _kidnap_run(_amcl_node(seed=7)[0]))
