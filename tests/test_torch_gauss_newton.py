"""The port's direct Gauss-Newton matcher (registration/gauss_newton.py)
and mode GN of localize_step against the JAX package's, in float64 on the
CPU, on the cases of tests/test_gauss_newton.py (map_size 8 at 0.04 m,
361 beams, a grid of two pushed scans that both packages read).

The room's walls stand 1 to 3 cm off tests/test_gauss_newton.py's (1.5 m
and 8.5 m, on the lines through the cell centres at 0.04 m): a scene point
on such a wall lies exactly on an edge of the bilinear stencil, where the
field's gradient jumps, and one ulp of rounding picks the side.  The JAX
package itself differs there with and without jit (XLA fuses the point
transform), so no comparison can hold such points to 1e-9.

Tolerances: the field's value and gradient within 1e-12; the transform,
RMS and pose within 1e-9 after 30-40 iterations (the port solves the 3x3
system in closed form where JAX factors it, so the steps differ in the
last bits); match counts and gate flags equal."""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ohm_tsd_slam_tpu.config import RegMode as JRegMode
from ohm_tsd_slam_tpu.grid.state import TsdGrid as JTsdGrid
from ohm_tsd_slam_tpu.registration import gauss_newton as jgn
from ohm_tsd_slam_tpu.registration.icp import IcpParams as JIcpParams
from ohm_tsd_slam_tpu.sensor import polar2d as jpolar
from ohm_tsd_slam_tpu.slam import localize as jlocalize
from ohm_tsd_slam_tpu_torch.config import GridConfig, RegMode
from ohm_tsd_slam_tpu_torch.core import se2
from ohm_tsd_slam_tpu_torch.grid.push import push
from ohm_tsd_slam_tpu_torch.grid.state import create, to_arrays
from ohm_tsd_slam_tpu_torch.registration import gauss_newton as tgn
from ohm_tsd_slam_tpu_torch.registration.icp import IcpParams
from ohm_tsd_slam_tpu_torch.sensor import polar2d as tpolar
from ohm_tsd_slam_tpu_torch.slam import localize as tlocalize
from ohm_tsd_slam_tpu_torch.utils.testing import (
    limit_cpu_threads,
    rect_walls,
    simulate_scan,
)

limit_cpu_threads()

F64 = torch.float64
TOL = 1e-9
CFG = GridConfig(map_size=8, cellsize=0.04)
GEOM = dict(size=361, angular_res=math.radians(0.75),
            phi_min=math.radians(-135.0), max_range=9.0,
            min_range=0.01, low_reflectivity_range=1.0)
TRUE = (5.12, 5.12, 0.2)
FIELDS = ("tsd", "weight", "tile_init", "tile_initw")


def _scan(xyt):
    pose = se2.make(*xyt, dtype=F64).numpy()
    return simulate_scan(pose, GEOM["size"], GEOM["angular_res"],
                         GEOM["phi_min"], GEOM["max_range"],
                         segments=rect_walls(1.51, 1.53, 8.47, 8.49),
                         circles=[((7.0, 7.2), 0.5), ((3.0, 7.5), 0.35)])


def _jgrid(g):
    d = to_arrays(g)
    return JTsdGrid(**{f: jnp.asarray(d[f]) for f in FIELDS},
                    cell_size=d["cell_size"],
                    max_truncation=d["max_truncation"],
                    max_weight=d["max_weight"], tile_dim=d["tile_dim"])


@pytest.fixture(scope="module")
def scene():
    """The grid (both packages), the geometry and the scan from TRUE."""
    geom = tpolar.SensorPolar2D(**GEOM)
    g = create(CFG, dtype=F64, device="cpu")
    for xyt in [TRUE, (5.3, 5.0, 0.0)]:
        data, mask = tpolar.standard_mask(geom, torch.from_numpy(_scan(xyt)))
        g = push(g, geom, se2.make(*xyt, dtype=F64), data, mask)
    data, mask = tpolar.standard_mask(geom, torch.from_numpy(_scan(TRUE)))
    return dict(grid=g, jgrid=_jgrid(g), geom=geom, data=data, mask=mask)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


def _j(t):
    return jnp.asarray(t.numpy())


def test_field_value_grad_matches_jax(scene):
    """Value, analytic gradient and validity at points on and off the
    grid, on unwritten (NaN) cells and on the walls."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-0.5, 10.8, (4000, 2))
    got = tgn._field_value_grad(scene["grid"], torch.from_numpy(x))
    want = jgn._field_value_grad(scene["jgrid"], jnp.asarray(x))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert 100 < int(got[3].sum()) < 4000
    for a, b in zip(got[:3], want[:3]):
        _close(a, b, 1e-12)


def _clouds(scene):
    pts, pmask = tpolar.data_to_cartesian(scene["geom"], scene["data"],
                                          scene["mask"])
    return pts, pmask


@pytest.mark.parametrize("dx,dy,dth", [
    (0.05, -0.03, 0.04),
    (-0.08, 0.06, -0.06),
    (0.12, 0.10, 0.08),
])
def test_recovers_perturbation_as_jax(scene, dx, dy, dth):
    pts, pmask = _clouds(scene)
    start = se2.make(TRUE[0] + dx, TRUE[1] + dy, TRUE[2] + dth, dtype=F64)
    res = tgn.match_gauss_newton(scene["grid"], start, pts, pmask,
                                 tgn.GnParams(iterations=40))
    jres = jgn.match_gauss_newton(scene["jgrid"], _j(start), _j(pts),
                                  _j(pmask), jgn.GnParams(iterations=40))
    _close(res.T, jres.T)
    _close(res.rms, jres.rms)
    assert int(res.matches) == int(jres.matches) > 100
    assert int(res.iterations) == 40
    rec = (start @ res.T).numpy()
    assert np.hypot(rec[0, 2] - TRUE[0], rec[1, 2] - TRUE[1]) < 0.01
    assert abs(math.atan2(rec[1, 0], rec[0, 0]) - TRUE[2]) < 0.01
    assert float(res.rms) < 0.02


def test_identity_when_aligned_as_jax(scene):
    pts, pmask = _clouds(scene)
    pose = se2.make(*TRUE, dtype=F64)
    res = tgn.match_gauss_newton(scene["grid"], pose, pts, pmask,
                                 tgn.GnParams())
    jres = jgn.match_gauss_newton(scene["jgrid"], _j(pose), _j(pts),
                                  _j(pmask), jgn.GnParams())
    _close(res.T, jres.T)
    assert np.linalg.norm(res.T[:2, 2].numpy()) < 2e-3


def test_too_few_points_returns_identity(scene):
    """No valid point: no step, identity, 0 matches (as in JAX), and with
    T_init the seed comes back unchanged."""
    pose = se2.make(*TRUE, dtype=F64)
    pts = torch.zeros((GEOM["size"], 2), dtype=F64)
    none = torch.zeros(GEOM["size"], dtype=torch.bool)
    res = tgn.match_gauss_newton(scene["grid"], pose, pts, none,
                                 tgn.GnParams())
    _close(res.T, np.eye(3))
    assert int(res.matches) == 0
    seed = se2.make(0.01, -0.02, 0.03, dtype=F64)
    res = tgn.match_gauss_newton(scene["grid"], pose, pts, none,
                                 tgn.GnParams(iterations=3), T_init=seed)
    _close(res.T, seed, 1e-12)


def _gn_params(pkg_params, icp_cls, geom, gn):
    return pkg_params(
        geom=geom,
        icp=icp_cls(iterations=25,
                    bounds=(0.0, CFG.size_meters, 0.0, CFG.size_meters)),
        mode=4, gn=gn)


def test_localize_step_gn_mode_as_jax(scene):
    """Mode GN: no render (rays_dropped 0, the model count is the GN
    matches), the pose back to the truth, every result as JAX's."""
    assert int(RegMode.GN) == int(JRegMode.GN) == 4
    geom = scene["geom"]
    params = _gn_params(tlocalize.LocalizeParams, IcpParams, geom,
                        tgn.GnParams(iterations=40))
    jparams = _gn_params(jlocalize.LocalizeParams, JIcpParams,
                         jpolar.SensorPolar2D(**GEOM),
                         jgn.GnParams(iterations=40))
    start = se2.make(TRUE[0] + 0.06, TRUE[1] - 0.05, TRUE[2] + 0.05,
                     dtype=F64)
    res = tlocalize.localize_step(scene["grid"], start, start,
                                  scene["data"], scene["mask"], params)
    jres = jlocalize.localize_step(scene["jgrid"], _j(start), _j(start),
                                   _j(scene["data"]), _j(scene["mask"]),
                                   jparams)
    assert not bool(res.reg_error) and bool(res.significant)
    for f in ("reg_error", "significant", "model_valid", "scene_valid",
              "icp_iterations", "rays_dropped"):
        assert int(getattr(res, f)) == int(getattr(jres, f)), f
    assert int(res.rays_dropped) == 0
    for f in ("pose", "T", "rms"):
        _close(getattr(res, f), getattr(jres, f))
    rec = res.pose.numpy()
    assert np.hypot(rec[0, 2] - TRUE[0], rec[1, 2] - TRUE[1]) < 0.01


def test_localize_step_gn_renders_nothing(scene, monkeypatch):
    """Mode GN never calls the caster or the march; with T_prereg it
    seeds ICP on the rendered model instead, as in JAX."""
    def refuse(*a, **k):
        raise AssertionError("mode GN rendered a model scan")

    monkeypatch.setattr(tlocalize, "raycast_checked", refuse)
    monkeypatch.setattr(tlocalize, "raycast", refuse)
    geom = scene["geom"]
    params = _gn_params(tlocalize.LocalizeParams, IcpParams, geom,
                        tgn.GnParams(iterations=5))
    pose = se2.make(*TRUE, dtype=F64)
    tlocalize.localize_step(scene["grid"], pose, pose, scene["data"],
                            scene["mask"], params)
    monkeypatch.undo()
    params = dataclasses.replace(params, fast_raycast=False)
    res = tlocalize.localize_step(scene["grid"], pose, pose, scene["data"],
                                  scene["mask"], params,
                                  T_prereg=torch.eye(3, dtype=F64))
    assert int(res.icp_iterations) > 0 and not bool(res.reg_error)
