"""The port's differentiable render (grid/render.py) against the JAX
package's, in float64 on the CPU, on the scene of tests/test_render.py
(map_size 8 at 0.04 m, 181 beams, two pushed scans that both packages
read).

Tolerances: the forward ranges within 1e-9 (the Newton polish takes the
derivative along the ray in closed form where JAX takes a jvp, so the
steps differ in the last bits; with refine=False the forward is the
raycaster's, bit for bit), the pose and cell gradients of the same
weighted sum within 1e-9 of `jax.grad`'s, miss beams exactly 0."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ohm_tsd_slam_tpu.core import se2 as jse2
from ohm_tsd_slam_tpu.grid.render import render_ranges_jit as jrender
from ohm_tsd_slam_tpu.grid.state import TsdGrid as JTsdGrid
from ohm_tsd_slam_tpu.sensor import polar2d as jpolar
from ohm_tsd_slam_tpu_torch.config import GridConfig
from ohm_tsd_slam_tpu_torch.core import se2
from ohm_tsd_slam_tpu_torch.grid import raycast_fast as rf
from ohm_tsd_slam_tpu_torch.grid.push import push
from ohm_tsd_slam_tpu_torch.grid.raycast import raycast
from ohm_tsd_slam_tpu_torch.grid.render import render_ranges
from ohm_tsd_slam_tpu_torch.grid.state import create, to_arrays
from ohm_tsd_slam_tpu_torch.sensor import polar2d as tpolar
from ohm_tsd_slam_tpu_torch.utils.testing import (
    limit_cpu_threads,
    rect_walls,
    simulate_scan,
)

limit_cpu_threads()

F64 = torch.float64
TOL = 1e-9
GEOM = dict(size=181, angular_res=math.radians(1.5),
            phi_min=math.radians(-135.0), max_range=9.0,
            min_range=0.01, low_reflectivity_range=1.0)
X0 = (5.2, 5.05, 0.15)
FIELDS = ("tsd", "weight", "tile_init", "tile_initw")


@pytest.fixture(scope="module")
def scene():
    geom = tpolar.SensorPolar2D(**GEOM)
    g = create(GridConfig(map_size=8, cellsize=0.04), dtype=F64,
               device="cpu")
    for xyt in [(5.12, 5.12, 0.2), (5.4, 4.9, -0.3)]:
        pose = se2.make(*xyt, dtype=F64)
        r = simulate_scan(pose.numpy(), GEOM["size"], GEOM["angular_res"],
                          GEOM["phi_min"], GEOM["max_range"],
                          segments=rect_walls(1.5, 1.5, 8.5, 8.5),
                          circles=[((7.0, 7.2), 0.5)])
        data, mask = tpolar.standard_mask(geom, torch.from_numpy(r))
        g = push(g, geom, pose, data, mask)
    d = to_arrays(g)
    jg = JTsdGrid(**{f: jnp.asarray(d[f]) for f in FIELDS},
                  cell_size=d["cell_size"],
                  max_truncation=d["max_truncation"],
                  max_weight=d["max_weight"], tile_dim=d["tile_dim"])
    rng = np.random.default_rng(0)
    return dict(grid=g, jgrid=jg, geom=geom, jgeom=jpolar.SensorPolar2D(
        **GEOM), w=rng.normal(size=GEOM["size"]))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("use_fast", [False, True])
def test_forward_matches_jax(scene, use_fast):
    pose = se2.make(*X0, dtype=F64)
    ranges, hit, res = render_ranges(scene["grid"], scene["geom"], pose,
                                     use_fast=use_fast)
    jranges, jhit, _ = jrender(scene["jgrid"], scene["jgeom"],
                               jse2.make(*X0, dtype=jnp.float64),
                               use_fast=use_fast)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    assert int(hit.sum()) > 150
    _close(ranges.detach(), jranges)
    assert not bool(ranges[~hit].any())
    # refine=False: the raycaster's ranges, bit for bit
    raw, _, _ = render_ranges(scene["grid"], scene["geom"], pose,
                              use_fast=use_fast, refine=False)
    march = (rf.raycast_checked(scene["grid"], scene["geom"], pose)
             if use_fast else raycast(scene["grid"], scene["geom"], pose))
    assert torch.equal(raw.detach(), march.ranges)
    assert torch.equal(res.ranges, march.ranges)


def _pose_grad(scene, use_fast, segments=None):
    x = torch.tensor(X0, dtype=F64, requires_grad=True)
    pose = se2.make(x[0], x[1], x[2], dtype=F64)
    ranges, _, _ = render_ranges(scene["grid"], scene["geom"], pose,
                                 use_fast=use_fast, segments=segments)
    (torch.from_numpy(scene["w"]) * ranges).sum().backward()
    return x.grad


@pytest.mark.parametrize("use_fast", [False, True])
def test_pose_gradients_match_jax(scene, use_fast):
    """d/d(x, y, θ) of Σ w·ranges, through se2.make, against jax.grad;
    and against central differences as tests/test_render.py checks."""
    w = jnp.asarray(scene["w"])

    def loss(xyt):
        pose = jse2.make(xyt[0], xyt[1], xyt[2], dtype=jnp.float64)
        r, _, _ = jrender(scene["jgrid"], scene["jgeom"], pose,
                          use_fast=use_fast)
        return jnp.sum(w * r)

    g = _pose_grad(scene, use_fast)
    _close(g, jax.jit(jax.grad(loss))(jnp.asarray(X0)))

    def tloss(xyt):
        r, _, _ = render_ranges(scene["grid"], scene["geom"],
                                se2.make(*xyt, dtype=F64), use_fast=use_fast)
        return float((torch.from_numpy(scene["w"]) * r).sum())

    h = 1e-6
    fd = [(tloss([v + h * (i == j) for j, v in enumerate(X0)])
           - tloss([v - h * (i == j) for j, v in enumerate(X0)])) / (2 * h)
          for i in range(3)]
    np.testing.assert_allclose(g.numpy(), fd, rtol=2e-4, atol=1e-6)


def test_cell_gradients_match_jax(scene):
    """d/d tsd of Σ ranges (the exact march, as tests/test_render.py):
    the whole cotangent grid against jax.grad's, nonzero on the stencils
    of the hit beams."""
    pose = se2.make(*X0, dtype=F64)
    tsd = scene["grid"].tsd.clone().requires_grad_(True)
    g2 = dataclasses.replace(scene["grid"], tsd=tsd)
    ranges, _, _ = render_ranges(g2, scene["geom"], pose, use_fast=False)
    ranges.sum().backward()
    jpose = jse2.make(*X0, dtype=jnp.float64)

    def loss(t):
        jg = dataclasses.replace(scene["jgrid"], tsd=t)
        return jnp.sum(jrender(jg, scene["jgeom"], jpose,
                               use_fast=False)[0])

    want = np.asarray(jax.jit(jax.grad(loss))(scene["jgrid"].tsd))
    got = tsd.grad.numpy()
    assert np.isfinite(got).all() and (got != 0).sum() > 50
    np.testing.assert_array_equal(got != 0, want != 0)
    _close(got, want)


def test_miss_beams_zero_gradient(scene):
    """Each beam's range against the pose: exactly 0 for a miss beam,
    nonzero for nearly every hit beam."""
    def per_beam(xyt):
        pose = se2.make(xyt[0], xyt[1], xyt[2], dtype=F64)
        return render_ranges(scene["grid"], scene["geom"], pose)[0]

    x0 = torch.tensor(X0, dtype=F64)
    J = torch.autograd.functional.jacobian(per_beam, x0).numpy()
    _, hit, _ = render_ranges(scene["grid"], scene["geom"],
                              se2.make(*X0, dtype=F64))
    hit = hit.numpy()
    assert (~hit).sum() > 0
    assert np.all(J[~hit] == 0.0) and np.isfinite(J).all()
    assert (np.abs(J[hit]).sum(axis=1) > 0).mean() > 0.99


def test_cached_segments_match_inline_extraction(scene):
    """render_ranges(segments=) gives the forward and pose gradient of the
    inline extraction, bit for bit; a stale cache falls back to the exact
    march and stays right."""
    seg = rf.extract_segments(scene["grid"])
    pose = se2.make(*X0, dtype=F64)
    inline = render_ranges(scene["grid"], scene["geom"], pose)
    cached = render_ranges(scene["grid"], scene["geom"], pose, segments=seg)
    assert torch.equal(inline[1], cached[1])
    assert torch.equal(inline[0], cached[0])
    assert torch.equal(_pose_grad(scene, True),
                       _pose_grad(scene, True, segments=seg))
    other = dataclasses.replace(scene["grid"],
                                tsd=scene["grid"].tsd.clone())
    stale = render_ranges(other, scene["geom"], pose, segments=seg)
    exact = render_ranges(other, scene["geom"], pose, use_fast=False)
    assert int(stale[2].n_dropped) > 0
    assert torch.equal(stale[0], exact[0])
