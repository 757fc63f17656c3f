"""PyTorch port vs the JAX package: SE(2), the polar sensor, the config
copy, and the port's independence from jax.

The same numpy inputs (from a seed) go through both packages in float64
on the CPU."""

import dataclasses
import math
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ohm_tsd_slam_tpu import config as jcfg
from ohm_tsd_slam_tpu.core import se2 as jse2
from ohm_tsd_slam_tpu.sensor import polar2d as jpolar
from ohm_tsd_slam_tpu_torch import config as tcfg
from ohm_tsd_slam_tpu_torch.core import se2 as tse2
from ohm_tsd_slam_tpu_torch.sensor import polar2d as tpolar

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64
# float64 on both sides; the two libraries may round sin/cos/atan2 and
# fused multiply-adds differently in the last bit
TOL = 1e-12

GEOM = dict(size=541, angular_res=math.radians(0.5),
            phi_min=math.radians(-135.0), max_range=8.0,
            min_range=0.01, low_reflectivity_range=1.0)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _poses(rng, n=4):
    return [(float(x), float(y), float(t)) for x, y, t in
            zip(rng.uniform(-5, 5, n), rng.uniform(-5, 5, n),
                rng.uniform(-math.pi, math.pi, n))]


def test_se2_matches_jax():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-10, 10, (64, 2))
    for (x, y, th), (x2, y2, th2) in zip(_poses(rng), _poses(rng)):
        A_j = jse2.make(x, y, th, dtype=jnp.float64)
        B_j = jse2.make(x2, y2, th2, dtype=jnp.float64)
        A_t = tse2.make(x, y, th, dtype=F64)
        B_t = tse2.make(x2, y2, th2, dtype=F64)
        pairs = [
            (A_j, A_t),
            (jse2.invert(A_j), tse2.invert(A_t)),
            (jse2.compose(A_j, B_j), tse2.compose(A_t, B_t)),
            (jse2.transform_points(A_j, jnp.asarray(pts)),
             tse2.transform_points(A_t, _t(pts))),
            (jse2.rotate_vectors(A_j, jnp.asarray(pts)),
             tse2.rotate_vectors(A_t, _t(pts))),
            (jse2.angle(A_j), tse2.angle(A_t)),
            (jse2.translation(A_j), tse2.translation(A_t)),
        ]
        for j, t in pairs:
            np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                       rtol=0, atol=TOL)


def _ranges(rng, size):
    r = rng.uniform(0.05, 10.0, size)
    r[rng.random(size) < 0.05] = 0.0          # zero depth
    r[rng.random(size) < 0.05] = np.nan       # invalid
    r[rng.random(size) < 0.05] = np.inf       # no return
    # depth discontinuities: piecewise-constant runs with jumps
    r[100:140] = 2.0
    r[140:180] = 6.0
    return r


def test_polar2d_matches_jax():
    rng = np.random.default_rng(1)
    jg = jpolar.SensorPolar2D(**GEOM)
    tg = tpolar.SensorPolar2D(**GEOM)
    r = _ranges(rng, GEOM["size"])

    jd, jm = jpolar.standard_mask(jg, jnp.asarray(r))
    td, tm = tpolar.standard_mask(tg, _t(r))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))

    jc, jv = jpolar.data_to_cartesian(jg, jd, jm)
    tc, tv = tpolar.data_to_cartesian(tg, td, tm)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=TOL)

    np.testing.assert_array_equal(
        tpolar.clamp_min_range(_t(r), 0.5).numpy(),
        np.asarray(jpolar.clamp_min_range(jnp.asarray(r), 0.5)))
    np.testing.assert_allclose(tg.rays_local(F64).numpy(),
                               np.asarray(jg.rays_local(jnp.float64)),
                               rtol=0, atol=TOL)


def test_back_project_indices_equal():
    rng = np.random.default_rng(2)
    jg = jpolar.SensorPolar2D(**GEOM)
    tg = tpolar.SensorPolar2D(**GEOM)
    pts = rng.uniform(0, 10, (4000, 2))
    for x, y, th in zip(rng.uniform(3, 7, 3), rng.uniform(3, 7, 3),
                        rng.uniform(-math.pi, math.pi, 3)):
        jidx = jpolar.back_project(jg, jse2.make(x, y, th, dtype=jnp.float64),
                                   jnp.asarray(pts))
        tidx = tpolar.back_project(tg, tse2.make(x, y, th, dtype=F64),
                                   _t(pts))
        assert tidx.dtype == torch.int32
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        # all three kinds occur: below, above and inside the FOV
        for code in (-2, -1):
            assert (tidx.numpy() == code).any()
        assert (tidx.numpy() >= 0).any()


def _flat_params(name):
    with open(os.path.join(REPO, "configs", name)) as f:
        doc = yaml.safe_load(f)
    for v in doc.values():
        if isinstance(v, dict) and "ros__parameters" in v:
            return dict(v["ros__parameters"])
    return dict(doc)


@pytest.mark.parametrize("profile", ["double-laser.yaml", "slamparams.yaml"])
def test_config_copy_matches_jax(profile):
    params = _flat_params(profile)
    got = dataclasses.asdict(tcfg.from_flat_params(params))
    want = dataclasses.asdict(jcfg.from_flat_params(params))
    assert got == want
    assert len(got["robots"]) == params.get("robot_nbr", 1)


def test_port_imports_without_jax():
    code = ("import sys, ohm_tsd_slam_tpu_torch, ohm_tsd_slam_tpu_torch.slam, "
            "ohm_tsd_slam_tpu_torch.ops, ohm_tsd_slam_tpu_torch.grid, "
            "ohm_tsd_slam_tpu_torch.registration.ransac, "
            "ohm_tsd_slam_tpu_torch.ops.compact_channels_cuda, "
            "ohm_tsd_slam_tpu_torch.ops.kernel_check, "
            "ohm_tsd_slam_tpu_torch.utils.testing; "
            "print('jax' in sys.modules, 'ohm_tsd_slam_tpu' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False"]


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
