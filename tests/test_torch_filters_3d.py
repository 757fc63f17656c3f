"""PyTorch port vs the JAX package: projective pair assignment of 3D
clouds, the occlusion, robot-footprint and trimmed filters, the SE(2)
helpers and data_to_cartesian's dtype.

The same numpy inputs (a synthetic depth image from a seed, seeded pair
sets with ties) go through both packages on the CPU; indices and masks
must be equal in every element."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ohm_tsd_slam_tpu.core import se2 as jse2
from ohm_tsd_slam_tpu.registration import filters as jfilters
from ohm_tsd_slam_tpu.registration.nn import (
    projective_pairs_3d as jprojective,
)
from ohm_tsd_slam_tpu.sensor import polar2d as jpolar
from ohm_tsd_slam_tpu_torch.core import se2
from ohm_tsd_slam_tpu_torch.registration import filters
from ohm_tsd_slam_tpu_torch.registration.nn import (
    projective_pairs_3d,
    to_int32,
)
from ohm_tsd_slam_tpu_torch.sensor import polar2d as tpolar
from ohm_tsd_slam_tpu_torch.utils.testing import limit_cpu_threads

limit_cpu_threads()

WIDTH, HEIGHT = 64, 48
F = 50.0
P = np.array([[F, 0.0, WIDTH / 2, 0.0],
              [0.0, F, HEIGHT / 2, 0.0],
              [0.0, 0.0, 1.0, 0.0]])


def _depth_cloud(seed, width=WIDTH, height=HEIGHT, f=F):
    """A depth image (a slanted wall with a bump and noise, some pixels
    without a return) back-projected through the pinhole: [H·W, 3]
    points, z = 0 where the pixel has no return."""
    rng = np.random.default_rng(seed)
    v, u = np.mgrid[0:height, 0:width].astype(np.float64)
    z = 2.0 + 0.01 * u + 0.3 * np.exp(-((u - width / 3) ** 2
                                        + (v - height / 2) ** 2) / 60.0)
    z = z + rng.normal(0.0, 0.002, z.shape)
    z[rng.random(z.shape) < 0.05] = 0.0
    x = (u - width / 2) * z / f
    y = (v - height / 2) * z / f
    return np.stack([x, y, z], -1).reshape(-1, 3)


def _se3(rx, ry, rz, t):
    """A 4x4 rigid motion: rotations about x, y, z, then t."""
    cx, sx, cy, sy, cz, sz = (math.cos(rx), math.sin(rx), math.cos(ry),
                              math.sin(ry), math.cos(rz), math.sin(rz))
    R = (np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
         @ np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
         @ np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]]))
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, t
    return T


def _moved(cloud, T):
    return cloud @ T[:3, :3].T + T[:3, 3]


def _both(fn, jfn, *arrays, **kw):
    """fn on torch tensors and jfn on jnp arrays of the same numpy
    inputs, both results as numpy."""
    got = fn(*(torch.as_tensor(a) for a in arrays), **kw)
    want = jfn(*(jnp.asarray(a) for a in arrays), **kw)
    if isinstance(got, tuple):
        return ([g.numpy() for g in got], [np.asarray(w) for w in want])
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_projective_pairs_equal_jax(seed):
    """A depth cloud against itself moved by a small SE(3) step: model
    indices, d² and the pair mask equal JAX's in every element."""
    model = _depth_cloud(seed)
    scene = _moved(model, _se3(0.01, -0.02, 0.015, [0.02, -0.01, 0.03]))
    rng = np.random.default_rng(10 + seed)
    scene_mask = (scene[:, 2] > 0) & (rng.random(len(scene)) < 0.9)
    got, want = _both(projective_pairs_3d, jprojective, model, scene,
                      scene_mask, P, width=WIDTH, height=HEIGHT)
    for g, w, name in zip(got, want, ("idx", "dist2", "pair")):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got[0].dtype == np.int32
    assert 0.5 * len(scene) < got[2].sum() < len(scene)


def test_projective_pairs_index_zero_is_unmatchable():
    """tests/test_aux.py:232-250 on the port: image value 0 means "no
    model point", so a scene point on model point 0's pixel stays
    unpaired."""
    Pj = np.array([[50.0, 0.0, 50.0, 0.0], [0.0, 50.0, 50.0, 0.0],
                   [0.0, 0.0, 1.0, 0.0]])
    model = np.array([[0.2, 0.2, 1.0],      # index 0: unmatchable
                      [0.0, 0.0, 1.0],
                      [0.5, 0.0, 1.0]])
    scene = np.array([[0.201, 0.2, 1.0], [0.001, 0.0, 1.0],
                      [0.501, 0.0, 1.0], [0.0, 0.0, 0.0]])
    mask = np.ones(4, bool)
    (idx, d2, pm), want = _both(projective_pairs_3d, jprojective, model,
                                scene, mask, Pj, width=100, height=100)
    for g, w in zip((idx, d2, pm), want):
        np.testing.assert_array_equal(g, w)
    assert pm.tolist() == [False, True, True, False]
    assert idx[1] == 1 and idx[2] == 2 and np.isinf(d2[0])


def test_to_int32_saturates_as_xla():
    x = np.array([np.nan, 1e20, -1e20, 3e9, -3e9, 2.0, -7.0, np.inf])
    for dt, jdt in ((torch.float64, jnp.float64),
                    (torch.float32, jnp.float32)):
        got = to_int32(torch.as_tensor(x, dtype=dt)).numpy()
        want = np.asarray(jnp.asarray(x, jdt).astype(jnp.int32))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_occlusion_filter_equals_jax(seed):
    """The depth cloud, a second layer 0.5 m behind it on the same rays
    (occluded), points inside the 1e-3 band of a nearer point (kept) and
    points behind the camera or masked: the kept mask equals JAX's."""
    front = _depth_cloud(seed)
    behind = front * ((front[:, 2:] + 0.5) / np.maximum(front[:, 2:], 1e-9))
    band = front * ((front[:, 2:] + 5e-4) / np.maximum(front[:, 2:], 1e-9))
    cloud = np.concatenate([behind[::2], front, band[::3],
                            [[0.1, 0.1, -1.0]]])
    rng = np.random.default_rng(seed)
    mask = (cloud[:, 2] != 0) & (rng.random(len(cloud)) < 0.95)
    got, want = _both(filters.occlusion_filter, jfilters.occlusion_filter,
                      cloud, mask, P, width=WIDTH, height=HEIGHT)
    np.testing.assert_array_equal(got, want)
    # a point behind a kept front point on its ray is occluded; a point
    # in the band of one is kept
    nb, nf = len(behind[::2]), len(front)
    front_kept = mask[nb:nb + nf]
    hidden = mask[:nb] & (behind[::2, 2] > 0.5) & front_kept[::2]
    assert hidden.sum() > 1000 and not got[:nb][hidden].any()
    in_band = mask[nb + nf:-1] & (band[::3, 2] > 0)
    assert in_band.sum() > 500 and got[nb + nf:-1][in_band].all()


def test_occlusion_filter_band_pair():
    """Two points on one pixel 0.5e-3 apart both survive (inside the
    band), a third 2e-3 behind is occluded."""
    Pj = np.array([[50.0, 0.0, 50.0, 0.0], [0.0, 50.0, 50.0, 0.0],
                   [0.0, 0.0, 1.0, 0.0]])
    scene = np.array([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0005],
                      [0.0, 0.0, 1.002], [0.5, 0.0, 1.0]])
    got, want = _both(filters.occlusion_filter, jfilters.occlusion_filter,
                      scene, np.ones(4, bool), Pj, width=100, height=100)
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [True, True, False, True]


def test_robot_footprint_filter_equals_jax():
    rng = np.random.default_rng(7)
    scene = rng.uniform(-1.0, 1.0, (500, 2))
    mask = rng.random(500) < 0.9
    center = np.array([0.1, -0.05])
    got, want = _both(filters.robot_footprint_filter,
                      jfilters.robot_footprint_filter, scene, mask, center,
                      radius=0.4)
    np.testing.assert_array_equal(got, want)
    assert 0 < (mask & ~got).sum() < mask.sum()


def _pairs(seed, n=1000, n_pairs=None):
    """d² with many ties (values on a coarse grid) and a pair mask of
    n_pairs true entries (seeded) or a random one."""
    rng = np.random.default_rng(seed)
    d2 = np.round(rng.uniform(0.0, 1.0, n), 2)
    if n_pairs is None:
        mask = rng.random(n) < 0.8
    else:
        mask = np.zeros(n, bool)
        mask[rng.permutation(n)[:n_pairs]] = True
    return d2, mask


@pytest.mark.parametrize("p", [80.0, 33.3, 100.0, 0.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_trimmed_filter_equals_jax_f64(seed, p):
    """Ties broken by index on both sides (stable sorts), the same count
    kept, in float64."""
    d2, mask = _pairs(seed)
    got, want = _both(filters.trimmed_filter, jfilters.trimmed_filter, d2,
                      mask, overlap_percent=p)
    np.testing.assert_array_equal(got, want)
    assert got.sum() == math.floor(mask.sum() * p / 100.0)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_trimmed_filter_count_rounds_as_jax(dtype):
    """750 pairs at 5.2%: 750 · 5.2 / 100 is 39 in float64 and floors to
    38 in float32.  The port rounds in dist2's dtype, as JAX rounds with
    and without x64."""
    d2, mask = _pairs(3, n_pairs=750)
    got = filters.trimmed_filter(
        torch.as_tensor(d2, dtype=getattr(torch, dtype)),
        torch.as_tensor(mask), 5.2).numpy()
    with jax.enable_x64(dtype == "float64"):
        want = np.asarray(jfilters.trimmed_filter(
            jnp.asarray(d2, dtype), jnp.asarray(mask), 5.2))
    np.testing.assert_array_equal(got, want)
    assert got.sum() == (39 if dtype == "float64" else 38)


def test_se2_helpers_equal_jax():
    T = se2.make(0.3, -1.2, 0.7, dtype=torch.float64)
    jT = jse2.make(0.3, -1.2, 0.7, dtype=jnp.float64)
    for got, want in (
            (se2.identity(torch.float64), jse2.identity(jnp.float64)),
            (se2.rotation(T), jse2.rotation(jT)),
            (se2.embed44(T), jse2.embed44(jT)),
            (se2.extract33(se2.embed44(T)), jse2.extract33(jse2.embed44(jT)))):
        assert got.numpy().tobytes() == np.asarray(want).tobytes()
    assert se2.identity().dtype == torch.float32
    assert se2.embed44(T).shape == (4, 4)


@pytest.mark.parametrize("dtype", [None, "float32"])
def test_data_to_cartesian_dtype_equals_jax(dtype):
    geom = dict(size=181, angular_res=math.radians(1.5),
                phi_min=math.radians(-135.0), max_range=8.0)
    rng = np.random.default_rng(5)
    r = rng.uniform(0.2, 7.0, 181)
    r[::17] = np.inf
    mask = rng.random(181) < 0.9
    tdt = None if dtype is None else getattr(torch, dtype)
    jdt = None if dtype is None else jnp.dtype(dtype)
    (c, v) = tpolar.data_to_cartesian(tpolar.SensorPolar2D(**geom),
                                      torch.as_tensor(r),
                                      torch.as_tensor(mask), dtype=tdt)
    (jc, jv) = jpolar.data_to_cartesian(jpolar.SensorPolar2D(**geom),
                                        jnp.asarray(r), jnp.asarray(mask),
                                        dtype=jdt)
    assert c.dtype == (torch.float64 if dtype is None else torch.float32)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0,
                               atol=1e-12 if dtype is None else 1e-6)
