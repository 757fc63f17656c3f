"""PyTorch port vs the JAX package: pair assignment, filters, estimators
and the ICP loop.  Inputs are made from a seed with numpy, or rendered by
the JAX exact raycast from a map of the analytic room, and handed to both
packages in float64 on the CPU."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ohm_tsd_slam_tpu.config import GridConfig, IcpConfig
from ohm_tsd_slam_tpu.core import se2 as jse2
from ohm_tsd_slam_tpu.grid import create as jcreate
from ohm_tsd_slam_tpu.grid.push import push as jpush
from ohm_tsd_slam_tpu.grid.raycast import raycast as jraycast
from ohm_tsd_slam_tpu.registration import filters as jflt
from ohm_tsd_slam_tpu.registration.icp import IcpParams as JIcpParams
from ohm_tsd_slam_tpu.registration.icp import icp as jicp
from ohm_tsd_slam_tpu.registration import nn as jnn
from ohm_tsd_slam_tpu.sensor import polar2d as jpolar
from ohm_tsd_slam_tpu_torch.registration import filters as tflt
from ohm_tsd_slam_tpu_torch.registration.icp import IcpParams, IcpState
from ohm_tsd_slam_tpu_torch.registration.icp import icp as ticp
from ohm_tsd_slam_tpu_torch.registration import nn as tnn
from ohm_tsd_slam_tpu_torch.utils.testing import rect_walls, simulate_scan

GEOM = dict(size=541, angular_res=math.radians(0.5),
            phi_min=math.radians(-135.0), max_range=8.0,
            min_range=0.01, low_reflectivity_range=1.0)
WALLS = rect_walls(1.0, 1.0, 9.0, 9.0)
CIRCLES = [((7.0, 7.2), 0.5), ((3.0, 7.5), 0.35)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _cloud(rng, n, p_valid=0.9):
    pts = rng.uniform(-5.0, 5.0, (n, 2))
    mask = rng.random(n) < p_valid
    pts[~mask] = 0.0
    return pts, mask


@pytest.mark.parametrize("thresh2,use_reciprocal",
                         [(None, True), (0.3, True), (0.3, False)])
def test_assign_pairs_fused_matches_jax(thresh2, use_reciprocal):
    rng = np.random.default_rng(4)
    model, mmask = _cloud(rng, 400)
    # scene = a noisy subset of the model plus clutter, so the reciprocal
    # rule has many-to-one pairs to resolve
    scene = np.concatenate([model[:300] + rng.normal(0, 0.05, (300, 2)),
                            rng.uniform(-5, 5, (100, 2))])
    smask = rng.random(400) < 0.9
    payload = np.concatenate([model, rng.normal(size=(400, 2))], axis=1)
    j = jnn.assign_pairs_fused(jnp.asarray(model), jnp.asarray(mmask),
                               jnp.asarray(scene), jnp.asarray(smask),
                               jnp.asarray(payload), thresh2=thresh2,
                               use_reciprocal=use_reciprocal)
    t = tnn.assign_pairs_fused(_t(model), _t(mmask), _t(scene), _t(smask),
                               _t(payload), thresh2=thresh2,
                               use_reciprocal=use_reciprocal)
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
    np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))
    assert t[2].numpy().sum() > 50
    # float64 distance matrix summed in another order: last-bit differences
    np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(t[3].numpy(), np.asarray(j[3]),
                               rtol=0, atol=1e-12)


def test_modular_chain_matches_jax():
    rng = np.random.default_rng(5)
    model, mmask = _cloud(rng, 300)
    scene = model + rng.normal(0, 0.05, model.shape)
    smask = rng.random(300) < 0.95
    jidx, jd2 = jnn.nearest_neighbors(jnp.asarray(model), jnp.asarray(mmask),
                                      jnp.asarray(scene), jnp.asarray(smask))
    tidx, td2 = tnn.nearest_neighbors(_t(model), _t(mmask), _t(scene),
                                      _t(smask))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    # float64 distance matrix summed in another order
    np.testing.assert_allclose(td2.numpy(), np.asarray(jd2), rtol=0,
                               atol=1e-12)
    jm = jflt.reciprocal_filter(
        jidx, jd2, jflt.distance_filter(jd2, jnp.asarray(smask), 0.01), 300)
    tm = tflt.reciprocal_filter(
        tidx, td2, tflt.distance_filter(td2, _t(smask), 0.01), 300)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    # the schedule: host numpy in JAX, on-device torch in the port
    for it in (15, 1, 0):
        np.testing.assert_allclose(
            tflt.distance_threshold_schedule(1.0, 0.2, it, 25).numpy(),
            np.asarray(jflt.distance_threshold_schedule(1.0, 0.2, it, 25)),
            rtol=1e-15, atol=0)


@pytest.fixture(scope="module")
def room_map():
    """A JAX float64 map of the room after three pushes."""
    geom = jpolar.SensorPolar2D(**GEOM)
    grid = jcreate(GridConfig(map_size=8, cellsize=0.04), dtype=jnp.float64)
    push = jax.jit(jpush, static_argnames=("geom",))
    for xyt in [(5.0, 5.0, 0.4), (5.3, 5.1, 0.5), (4.8, 5.2, 0.3)]:
        pose = jse2.make(*xyt, dtype=jnp.float64)
        r = simulate_scan(np.asarray(pose), geom.size, geom.angular_res,
                          geom.phi_min, geom.max_range, segments=WALLS,
                          circles=CIRCLES)
        d, m = jpolar.standard_mask(geom, jnp.asarray(r))
        grid = push(grid, geom, pose, d, m)
    return grid, geom


def _pair(room_map, est_xyt, true_xyt):
    """Model rendered from the estimate, scene scanned at the truth."""
    grid, geom = room_map
    model = jax.jit(jraycast, static_argnames=("geom",))(
        grid, geom, jse2.make(*est_xyt, dtype=jnp.float64))
    r = simulate_scan(np.asarray(jse2.make(*true_xyt, dtype=jnp.float64)),
                      geom.size, geom.angular_res, geom.phi_min,
                      geom.max_range, segments=WALLS, circles=CIRCLES)
    d, m = jpolar.standard_mask(geom, jnp.asarray(r))
    scene, smask = jpolar.data_to_cartesian(geom, d, m)
    return (np.asarray(model.coords), np.asarray(model.mask),
            np.asarray(model.normals), np.asarray(scene), np.asarray(smask),
            np.asarray(jse2.make(*est_xyt, dtype=jnp.float64)))


@pytest.mark.parametrize("fused,estimator", [
    (True, "closed_form"), (False, "closed_form"), (True, "point_to_line")])
def test_icp_matches_jax(room_map, fused, estimator):
    cfg = IcpConfig(iterations=30, dist_filter_max=0.5, dist_filter_min=0.05,
                    estimator=estimator)
    bounds = (0.0, 10.24, 0.0, 10.24)
    tp = dataclasses.replace(IcpParams.from_config(cfg, bounds=bounds),
                             fused=fused)
    jp = JIcpParams(**dataclasses.asdict(tp))
    for est, true in [((5.1, 4.9, 0.45), (5.14, 4.88, 0.47)),
                      ((3.0, 6.5, -2.0), (2.95, 6.52, -1.98))]:
        model, mmask, normals, scene, smask, pose = _pair(room_map, est, true)
        j = jicp(jnp.asarray(model), jnp.asarray(mmask), jnp.asarray(scene),
                 jnp.asarray(smask), jp, sensor_pose=jnp.asarray(pose),
                 model_normals=jnp.asarray(normals))
        t = ticp(_t(model), _t(mmask), _t(scene), _t(smask), tp,
                 sensor_pose=_t(pose), model_normals=_t(normals))
        # float64 loop; the estimators' sums run in another order
        np.testing.assert_allclose(t.T.numpy(), np.asarray(j.T), rtol=0,
                                   atol=1e-9)
        assert int(t.iterations) == int(j.iterations)
        assert int(t.state) == int(j.state)
        assert int(t.pairs) == int(j.pairs)
        np.testing.assert_array_equal(t.pair_history.numpy(),
                                      np.asarray(j.pair_history))
        np.testing.assert_allclose(t.rms.numpy(), np.asarray(j.rms),
                                   rtol=1e-9, atol=1e-12)
        # the registration did move the scene onto the model
        assert abs(float(t.T[0, 2])) + abs(float(t.T[1, 2])) > 1e-3


def test_icp_unmatchable_matches_jax():
    rng = np.random.default_rng(6)
    model, mmask = _cloud(rng, 200)
    mmask[2:] = False                 # two model points: under 3 pairs
    scene = model + 0.01
    smask = np.ones(200, bool)
    jp = JIcpParams(iterations=10)
    tp = IcpParams(iterations=10)
    j = jicp(jnp.asarray(model), jnp.asarray(mmask), jnp.asarray(scene),
             jnp.asarray(smask), jp)
    t = ticp(_t(model), _t(mmask), _t(scene), _t(smask), tp)
    assert int(t.state) == int(j.state) == int(IcpState.NOTMATCHABLE)
    assert int(t.iterations) == int(j.iterations) == 1
    np.testing.assert_array_equal(t.T.numpy(), np.eye(3))
    np.testing.assert_array_equal(t.T.numpy(), np.asarray(j.T))
