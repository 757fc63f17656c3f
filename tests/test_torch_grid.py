"""PyTorch port vs the JAX package: grid state, interpolation, the plain
push, the exact raycast and the occupancy/colour extraction.

The same numpy scans (from a seed and the analytic room) go through both
packages on the CPU.  Grids are 256^2 (32x32 tiles) as in
tests/test_push_pallas.py."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ohm_tsd_slam_tpu.config import GridConfig as JGridConfig
from ohm_tsd_slam_tpu.core import se2 as jse2
from ohm_tsd_slam_tpu.grid import create as jcreate
from ohm_tsd_slam_tpu.grid import interpolate as jinterp
from ohm_tsd_slam_tpu.grid.axis_aligned import occupancy_grid as jocc
from ohm_tsd_slam_tpu.grid.color import grid_to_color_image as jcolor
from ohm_tsd_slam_tpu.grid.push import push as jpush
from ohm_tsd_slam_tpu.grid.raycast import raycast as jraycast
from ohm_tsd_slam_tpu.grid.state import free_footprint as jfree
from ohm_tsd_slam_tpu.sensor import polar2d as jpolar
from ohm_tsd_slam_tpu_torch.config import GridConfig
from ohm_tsd_slam_tpu_torch.core import se2
from ohm_tsd_slam_tpu_torch.grid import interpolate as tinterp
from ohm_tsd_slam_tpu_torch.grid.axis_aligned import occupancy_grid
from ohm_tsd_slam_tpu_torch.grid.color import grid_to_color_image
from ohm_tsd_slam_tpu_torch.grid.push import push
from ohm_tsd_slam_tpu_torch.grid.raycast import raycast
from ohm_tsd_slam_tpu_torch.grid.state import (
    create,
    free_footprint,
    from_arrays,
    to_arrays,
)
from ohm_tsd_slam_tpu_torch.sensor import polar2d as tpolar
from ohm_tsd_slam_tpu_torch.utils.testing import rect_walls, simulate_scan

GRID = dict(map_size=8, cellsize=0.04)            # 256^2, 32x32 tiles
GEOM = dict(size=541, angular_res=math.radians(0.5),
            phi_min=math.radians(-135.0), max_range=8.0,
            min_range=0.01, low_reflectivity_range=1.0)
POSES = [(5.0, 5.0, 0.4), (5.3, 5.1, 0.5), (4.8, 5.2, 0.3)]
GRID_FIELDS = ("tsd", "weight", "tile_init", "tile_initw")

jpush_jit = jax.jit(jpush, static_argnames=("geom",))
jraycast_jit = jax.jit(jraycast, static_argnames=("geom",))


def _jgrid_arrays(g):
    d = {f: np.asarray(getattr(g, f)) for f in GRID_FIELDS}
    d.update(cell_size=g.cell_size, max_truncation=g.max_truncation,
             max_weight=g.max_weight, tile_dim=g.tile_dim)
    return d


def _scan(xyt):
    pose = np.array(jse2.make(*xyt, dtype=jnp.float64))
    walls = rect_walls(1.0, 1.0, 9.0, 9.0)
    return simulate_scan(pose, GEOM["size"], GEOM["angular_res"],
                         GEOM["phi_min"], GEOM["max_range"],
                         segments=walls, circles=[((7.0, 7.2), 0.5)])


def _push_both(poses, dtype_np, ranges=None, push=push):
    """Push the same scans into a JAX grid and a port grid (by `push`)."""
    jdt = jnp.dtype(dtype_np)
    tdt = torch.float64 if dtype_np == np.float64 else torch.float32
    jg_geom = jpolar.SensorPolar2D(**GEOM)
    tg_geom = tpolar.SensorPolar2D(**GEOM)
    jg = jcreate(JGridConfig(**GRID), dtype=jdt)
    tg = create(GridConfig(**GRID), dtype=tdt)
    for xyt in poses:
        r = _scan(xyt) if ranges is None else ranges
        jd, jm = jpolar.standard_mask(jg_geom, jnp.asarray(r, jdt))
        td, tm = tpolar.standard_mask(tg_geom, torch.as_tensor(r, dtype=tdt))
        jg = jpush_jit(jg, jg_geom, jse2.make(*xyt, dtype=jdt), jd, jm)
        tg = push(tg, tg_geom, se2.make(*xyt, dtype=tdt), td, tm)
    return jg, tg


def _assert_grids_equal(jg, tg, tol):
    want = _jgrid_arrays(jg)
    got = to_arrays(tg)
    a, b = got["tsd"], want["tsd"]
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    fin = ~np.isnan(a)
    np.testing.assert_allclose(a[fin], b[fin], rtol=0, atol=tol)
    np.testing.assert_allclose(got["weight"], want["weight"], rtol=0,
                               atol=tol)
    np.testing.assert_array_equal(got["tile_init"], want["tile_init"])
    np.testing.assert_array_equal(got["tile_initw"], want["tile_initw"])


@pytest.fixture(scope="module")
def pushed64():
    """JAX and port grids after the three pushes, float64."""
    return _push_both(POSES, np.float64)


@pytest.mark.parametrize("case", ["one_pose", "three_poses",
                                  "into_converted_jax_map"])
def test_push_matches_jax_f64(case, pushed64):
    if case == "three_poses":
        jg, tg = pushed64
    elif case == "one_pose":
        jg, tg = _push_both(POSES[:1], np.float64)
    else:
        # both packages push one more scan into the same mid-run map
        jg0, _ = pushed64
        xyt = (5.6, 4.7, 1.0)
        jgeom = jpolar.SensorPolar2D(**GEOM)
        tgeom = tpolar.SensorPolar2D(**GEOM)
        r = _scan(xyt)
        jg = jpush_jit(jg0, jgeom, jse2.make(*xyt, dtype=jnp.float64),
                       *jpolar.standard_mask(jgeom, jnp.asarray(r)))
        tg = push(from_arrays(_jgrid_arrays(jg0)), tgeom,
                  se2.make(*xyt, dtype=torch.float64),
                  *tpolar.standard_mask(tgeom, torch.as_tensor(r)))
    # float64 on both sides: only the last-bit rounding of atan2 and of
    # fused multiply-adds differs
    _assert_grids_equal(jg, tg, 1e-12)
    assert np.isfinite(to_arrays(tg)["tsd"]).sum() > 1000


def test_push_wrapper_on_cpu_matches_jax_f64(pushed64):
    """ops/push_cuda.py::push_cuda takes the plain push for a grid on the
    CPU: equal to it in every bit, and to JAX as the plain push is."""
    from ohm_tsd_slam_tpu_torch.ops.push_cuda import push_cuda

    launches = push_cuda.launches
    jg, tg = _push_both(POSES, np.float64, push=push_cuda)
    assert push_cuda.launches == launches
    _assert_grids_equal(jg, tg, 1e-12)
    got, want = to_arrays(tg), to_arrays(pushed64[1])
    for f in GRID_FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


@pytest.mark.parametrize("case", ["sensor_outside", "all_masked"])
def test_push_edge_cases_match_jax(case):
    ranges = np.full(GEOM["size"], np.inf)
    if case == "sensor_outside":
        jg, tg = _push_both([(50.0, 50.0, 0.0)], np.float64, ranges)
        assert not to_arrays(tg)["tile_init"].any()
    else:
        jg, tg = _push_both([(5.0, 5.0, 0.0)], np.float64, ranges)
    # same tolerance reason as the float64 push test
    _assert_grids_equal(jg, tg, 1e-12)


def test_push_matches_jax_f32():
    jg, tg = _push_both(POSES, np.float32)
    a = to_arrays(tg)["tsd"]
    b = np.asarray(jg.tsd)
    # float32: the two atan2 implementations can put a cell whose bearing
    # sits on a bin edge into the neighbouring beam; the rates are those
    # tests/test_push_pallas.py allows the Pallas kernel
    assert (np.isnan(a) != np.isnan(b)).mean() < 5e-4
    fin = ~np.isnan(a) & ~np.isnan(b)
    d = np.abs(a[fin] - b[fin])
    assert (d > 1e-3).mean() < 5e-4
    assert np.median(d) < 1e-5
    np.testing.assert_allclose(to_arrays(tg)["weight"], np.asarray(jg.weight),
                               atol=1e-2)
    np.testing.assert_array_equal(to_arrays(tg)["tile_init"],
                                  np.asarray(jg.tile_init))
    np.testing.assert_allclose(to_arrays(tg)["tile_initw"],
                               np.asarray(jg.tile_initw), atol=1e-6)


def test_interpolation_matches_jax(pushed64):
    jg, _ = pushed64
    tg = from_arrays(_jgrid_arrays(jg))         # the same map in the port
    rng = np.random.default_rng(3)
    # inside, near the walls and beyond the grid edges
    q = np.concatenate([rng.uniform(-0.5, 10.8, (3000, 2)),
                        rng.uniform(0.9, 1.1, (500, 2))])
    jv, jc = jinterp.interpolate_bilinear(jg, jnp.asarray(q))
    tv, tc = tinterp.interpolate_bilinear(tg, torch.from_numpy(q))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert len(np.unique(tc.numpy())) == 4       # every return code occurs
    # float64, same tap order: last-bit differences at most
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-12)

    jn, jok = jinterp.interpolate_normal(jg, jnp.asarray(q))
    tn, tok = tinterp.interpolate_normal(tg, torch.from_numpy(q))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert tok.numpy().any()
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=0, atol=1e-12)


def test_raycast_matches_jax(pushed64):
    jg, tg = pushed64
    jgeom = jpolar.SensorPolar2D(**GEOM)
    tgeom = tpolar.SensorPolar2D(**GEOM)
    for xyt in [(5.1, 4.9, 0.45), (3.0, 6.5, -2.0), (50.0, 50.0, 0.0)]:
        jr = jraycast_jit(jg, jgeom, jse2.make(*xyt, dtype=jnp.float64))
        tr = raycast(tg, tgeom, se2.make(*xyt, dtype=torch.float64))
        np.testing.assert_array_equal(tr.mask.numpy(), np.asarray(jr.mask))
        # float64 march: sample positions and sub-cell interpolation agree
        # to rounding; 1e-9 m leaves room for the normalisation
        for name in ("coords", "normals", "ranges"):
            np.testing.assert_allclose(getattr(tr, name).numpy(),
                                       np.asarray(getattr(jr, name)),
                                       rtol=0, atol=1e-9, err_msg=name)
        if xyt[0] < 10:
            assert tr.mask.numpy().mean() > 0.5


def test_occupancy_and_color_match_jax(pushed64):
    jg, _ = pushed64
    jg = jfree(jg, np.array([5.0, 5.0]), 0.6, 0.6)
    tg = free_footprint(from_arrays(_jgrid_arrays(jg)), (5.0, 5.0), 0.6, 0.6)
    for infl in (False, True):
        jo = jocc(jg, use_inflation=infl, inflation_factor=2)
        to = occupancy_grid(tg, use_inflation=infl, inflation_factor=2)
        assert to.occupancy.dtype == torch.int8
        np.testing.assert_array_equal(to.occupancy.numpy(),
                                      np.asarray(jo.occupancy))
        assert int(to.n_surface) == int(jo.n_surface)
        # the room's walls lie in the skipped outer tile ring; the pillar
        # is extracted
        assert (to.occupancy.numpy() == 100).sum() > 20
    np.testing.assert_array_equal(grid_to_color_image(tg).numpy(),
                                  np.asarray(jcolor(jg)))


def test_free_footprint_matches_jax():
    jg = jcreate(JGridConfig(**GRID), dtype=jnp.float64)
    tg = create(GridConfig(**GRID), dtype=torch.float64)
    for center, w, h in [((5.12, 5.12), 1.0, 1.0), ((5.4, 4.0), 0.6, 0.8),
                         ((0.1, 0.1), 1.0, 1.0)]:
        jg = jfree(jg, np.array(center), w, h)
        tg = free_footprint(tg, center, w, h)
    _assert_grids_equal(jg, tg, 0.0)


def test_arrays_round_trip(pushed64):
    _, tg = pushed64
    d = to_arrays(tg)
    back = from_arrays(d)
    for f in GRID_FIELDS:
        a, b = getattr(back, f), getattr(tg, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    for f in ("cell_size", "max_truncation", "max_weight", "tile_dim"):
        assert getattr(back, f) == getattr(tg, f)
