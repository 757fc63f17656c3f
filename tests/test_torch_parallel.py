"""The port's multi-robot step (ohm_tsd_slam_tpu_torch/parallel/sharded.py)
against the JAX package's (mesh = None), in float64 on the CPU.

Inputs are tests/test_parallel.py's: the base grid of one push and four
robots' scans in the 6.4 m room (`_base_grid`, `_robot_batch`), made with
numpy and pushed by the JAX package, then carried into the port through
the grid's arrays.  The step runs in the modes ICP and GN, and in TSD and
AMCL with JAX's own draws injected into the port (the packages cannot draw
the same numbers): the draws match_tsd and match_amcl make from the
robots' keys (`split(PRNGKey(0), R)`), mirrored line for line.  Tolerances
are tests/test_parallel.py's own (:64-86): poses within 1e-9, the pose
gradient within rtol 1e-6 (atol 1e-9), the fused grid NaN for NaN and
within rtol 1e-9 / atol 1e-12.  `interpolate_bilinear_safe` and
`pose_gradient` are held against JAX and `jax.grad` at 1e-12, and the
descent test of tests/test_parallel.py:89-107 runs on the port."""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ohm_tsd_slam_tpu.config import GridConfig as JGridConfig
from ohm_tsd_slam_tpu.core import se2 as jse2
from ohm_tsd_slam_tpu.grid import create as jcreate
from ohm_tsd_slam_tpu.grid import push as jpush
from ohm_tsd_slam_tpu.grid.interpolate import (
    interpolate_bilinear_safe as j_safe,
)
from ohm_tsd_slam_tpu.grid.raycast_fast import raycast_fast as jraycast_fast
from ohm_tsd_slam_tpu.parallel.sharded import (
    map_residual_loss as j_loss,
    multi_robot_slam_step as j_step,
    pose_gradient as j_pose_gradient,
)
from ohm_tsd_slam_tpu.registration import amcl as jamcl
from ohm_tsd_slam_tpu.registration import ransac as jr
from ohm_tsd_slam_tpu.registration.icp import IcpParams as JIcpParams
from ohm_tsd_slam_tpu.sensor.polar2d import (
    SensorPolar2D as JSensor,
    data_to_cartesian as j_to_cartesian,
    standard_mask as j_standard_mask,
)
from ohm_tsd_slam_tpu.slam.localize import LocalizeParams as JParams
from ohm_tsd_slam_tpu_torch.core import se2
from ohm_tsd_slam_tpu_torch.grid.interpolate import interpolate_bilinear_safe
from ohm_tsd_slam_tpu_torch.grid.state import from_arrays
from ohm_tsd_slam_tpu_torch.parallel import (
    map_residual_loss,
    multi_robot_slam_step,
    pose_gradient,
)
from ohm_tsd_slam_tpu_torch.registration import amcl as tamcl
from ohm_tsd_slam_tpu_torch.registration import ransac as tr
from ohm_tsd_slam_tpu_torch.registration.icp import IcpParams
from ohm_tsd_slam_tpu_torch.sensor.polar2d import SensorPolar2D
from ohm_tsd_slam_tpu_torch.slam.localize import LocalizeParams
from ohm_tsd_slam_tpu_torch.utils.testing import (
    limit_cpu_threads,
    rect_walls,
    simulate_scan,
)
from test_torch_amcl import jax_draws

limit_cpu_threads()

# tests/test_parallel.py's configuration
CFG = JGridConfig(map_size=7, cellsize=0.05)
GW = CFG.size_meters
GEOM = dict(size=181, angular_res=math.radians(1.5),
            phi_min=math.radians(-135.0), max_range=5.0, min_range=0.01,
            low_reflectivity_range=1.0)
BOUNDS = (0.0, GW, 0.0, GW)
RANSAC = dict(trials=30, size_control_set=60)
AMCL = dict(particles=64, iterations=3, sigma_trans=0.1, sigma_rot=0.05)
MODES = {"icp": 0, "tsd": 3, "gn": 4, "amcl": 5}
FIELDS = ("tsd", "weight", "tile_init", "tile_initw")


def _robot_batch(R=4):
    """tests/test_parallel.py::_robot_batch."""
    jgeom = JSensor(**GEOM)
    walls = rect_walls(0.8, 0.8, GW - 0.8, GW - 0.8)
    poses, datas, masks = [], [], []
    for r in range(R):
        pose_np = np.array(jse2.make(GW / 2 + 0.15 * r, GW / 2 - 0.1 * r,
                                     0.1 * r, dtype=jnp.float64))
        ranges = simulate_scan(pose_np, GEOM["size"], GEOM["angular_res"],
                               GEOM["phi_min"], GEOM["max_range"],
                               segments=walls,
                               circles=[((4.5, 4.5), 0.3)])
        d, m = j_standard_mask(jgeom, jnp.asarray(ranges))
        poses.append(jnp.asarray(pose_np))
        datas.append(d)
        masks.append(m)
    return jnp.stack(poses), jnp.stack(datas), jnp.stack(masks)


@functools.lru_cache(maxsize=None)
def _case():
    """tests/test_parallel.py::_base_grid and _robot_batch(4), in both
    packages."""
    jgeom = JSensor(**GEOM)
    poses, data, mask = _robot_batch(1)
    jgrid = jpush(jcreate(CFG, dtype=jnp.float64), jgeom, poses[0], data[0],
                  mask[0])
    jposes, jdata, jmask = _robot_batch(4)
    d = {f: np.asarray(getattr(jgrid, f)) for f in FIELDS}
    d.update(cell_size=jgrid.cell_size, max_truncation=jgrid.max_truncation,
             max_weight=jgrid.max_weight, tile_dim=jgrid.tile_dim)
    t = {name: torch.from_numpy(np.array(x))
         for name, x in (("poses", jposes), ("data", jdata),
                         ("mask", jmask))}
    return dict(jgrid=jgrid, jposes=jposes, jdata=jdata, jmask=jmask,
                grid=from_arrays(d), geom=SensorPolar2D(**GEOM), **t)


def _params(mode):
    jparams = JParams(geom=JSensor(**GEOM),
                      icp=JIcpParams(iterations=15, bounds=BOUNDS),
                      mode=mode, ransac=jr.RansacParams(**RANSAC),
                      amcl=jamcl.AmclParams(**AMCL))
    tparams = LocalizeParams(geom=SensorPolar2D(**GEOM),
                             icp=IcpParams(iterations=15, bounds=BOUNDS),
                             mode=mode, ransac=tr.RansacParams(**RANSAC),
                             amcl=tamcl.AmclParams(**AMCL))
    return jparams, tparams


def _t(a):
    return torch.from_numpy(np.array(a))


def _tsd_draws(c, jparams, keys):
    """Per robot, the draws match_tsd makes from its key
    (ohm_tsd_slam_tpu/registration/ransac.py::_prepare) on the model the
    JAX step renders, as a RansacInject of the port."""
    p = jparams.ransac
    r_ = p.pca_search_range // 2
    jgeom = jparams.geom
    models = jax.vmap(lambda pose: jraycast_fast(c["jgrid"], jgeom, pose))(
        c["jposes"])
    out = []
    for r, key in enumerate(keys):
        k_sub, k_trial, k_ctrl = jax.random.split(key, 3)
        scene, smask = j_to_cartesian(jgeom, c["jdata"][r], c["jmask"][r])
        _, mask_mp = jr.pca_normals(models.coords[r], models.mask[r], r_)
        sub = jr.subsample_mask(k_sub, smask)
        _, msp = jr.pca_normals(scene, smask, r_)
        c_idx, c_valid = jr.random_valid_subset(k_ctrl, msp & sub,
                                                p.size_control_set)
        t_idx, t_valid = jr.random_valid_subset(k_trial, mask_mp, p.trials)
        out.append(tr.RansacInject(*(_t(x) for x in (
            sub, c_idx, c_valid, t_idx, t_valid))))
    return out


def _amcl_draws(c, jparams, keys):
    jgeom = jparams.geom
    out = []
    for r, key in enumerate(keys):
        _, smask = j_to_cartesian(jgeom, c["jdata"][r], c["jmask"][r])
        out.append(jax_draws(key, smask, jparams.amcl))
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_step_matches_jax(mode):
    c = _case()
    jparams, tparams = _params(MODES[mode])
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    inject = {"tsd": _tsd_draws, "amcl": _amcl_draws}.get(mode)
    inject = inject(c, jparams, keys) if inject else None
    ref = j_step(c["jgrid"], c["jposes"], c["jdata"], c["jmask"], jparams)
    got = multi_robot_slam_step(c["grid"], c["poses"], c["data"], c["mask"],
                                tparams, inject=inject)

    assert int(got.rays_dropped) == int(ref.rays_dropped) == 0
    np.testing.assert_array_equal(got.reg_error.numpy(),
                                  np.asarray(ref.reg_error))
    assert not got.reg_error.all()
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(ref.poses),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got.pose_grad.numpy(),
                               np.asarray(ref.pose_grad),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(got.rms.numpy(), np.asarray(ref.rms),
                               rtol=1e-6, atol=1e-12)
    for f in FIELDS:
        a = getattr(got.grid, f).numpy()
        b = np.asarray(getattr(ref.grid, f))
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=f)
            continue
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=f)
        ok = ~np.isnan(b)
        np.testing.assert_allclose(a[ok], b[ok], rtol=1e-9, atol=1e-12,
                                   err_msg=f)
    # the robots moved the grid: every scan was fused
    assert int(got.grid.tile_init.sum()) >= int(c["grid"].tile_init.sum())


def test_failed_robot_keeps_the_old_grid():
    """A robot whose registration fails leaves the grid as it was: with a
    translation gate below zero every registration is an error, so no
    scan is fused and no pose moves, where the same step with the gate
    open changes the grid."""
    c = _case()
    _, tparams = _params(MODES["icp"])
    args = (c["grid"], c["poses"][:2], c["data"][:2], c["mask"][:2])
    shut = multi_robot_slam_step(
        *args, dataclasses.replace(tparams, trns_max=-1.0))
    assert shut.reg_error.all()
    assert torch.equal(shut.poses, c["poses"][:2])
    for f in FIELDS:
        assert torch.equal(getattr(shut.grid, f).nan_to_num(),
                           getattr(c["grid"], f).nan_to_num()), f
    assert torch.equal(shut.grid.tsd.isnan(), c["grid"].tsd.isnan())
    open_ = multi_robot_slam_step(*args, tparams)
    assert not open_.reg_error.any()
    assert not torch.equal(open_.grid.weight, c["grid"].weight)


def test_interpolate_bilinear_safe_matches_jax():
    c = _case()
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.2, GW + 0.2, (4000, 2))
    got, ok = interpolate_bilinear_safe(c["grid"], torch.from_numpy(pts))
    want, jok = j_safe(c["jgrid"], jnp.asarray(pts))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert 100 < int(ok.sum()) < 4000
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)
    assert not got.numpy()[~ok.numpy()].any()

    # the backward never sees a NaN, even for points next to unseen cells
    x = torch.from_numpy(pts).requires_grad_(True)
    v, _ = interpolate_bilinear_safe(c["grid"], x)
    (g,) = torch.autograd.grad((v * v).sum(), x)
    assert bool(torch.isfinite(g).all())


def test_pose_gradient_matches_jax_grad():
    c = _case()
    jgeom = JSensor(**GEOM)
    for r in range(4):
        jpose = c["jposes"][r] @ jse2.make(0.03, -0.02, 0.01,
                                           dtype=jnp.float64)
        pose = _t(jpose)
        got = pose_gradient(c["grid"], c["geom"], pose, c["data"][r],
                            c["mask"][r])
        want = j_pose_gradient(c["jgrid"], jgeom, jpose, c["jdata"][r],
                               c["jmask"][r])
        assert np.abs(np.asarray(want)).max() > 1e-4
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9,
                                   atol=1e-12)
        loss = map_residual_loss(c["grid"], c["geom"], pose, c["data"][r],
                                 c["mask"][r])
        jloss = j_loss(c["jgrid"], jgeom, jpose, c["jdata"][r],
                       c["jmask"][r])
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-12)


def test_pose_gradient_finite_and_descending():
    """tests/test_parallel.py:89-107 on the port: stepping against the
    gradient reduces the residual."""
    c = _case()
    pose = c["poses"][0] @ se2.make(0.03, -0.02, 0.01, dtype=torch.float64)
    data, mask = c["data"][0], c["mask"][0]
    g = pose_gradient(c["grid"], c["geom"], pose, data, mask)
    assert bool(torch.isfinite(g).all())
    l0 = float(map_residual_loss(c["grid"], c["geom"], pose, data, mask))
    step = -1e-3 * g / (torch.linalg.norm(g) + 1e-12)
    delta = se2.make(step[0], step[1], step[2], dtype=torch.float64)
    l1 = float(map_residual_loss(c["grid"], c["geom"], pose @ delta, data,
                                 mask))
    assert l1 < l0
