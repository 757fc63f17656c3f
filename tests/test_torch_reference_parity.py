"""The port's room replay against the COMPILED C++ REFERENCE.

golden/harness.cpp runs the reference's TsdGrid on the analytic room
(golden/data/room.bin: map_size 8, 256² cells of 0.025 m, 32-cell tiles,
1081 beams) and dumps its float64 state after the footprint and after
each of six pushes, three exact raycasts, the axis-aligned occupancy and
a storeGrid file; tests/test_reference_parity.py:106-216 holds the JAX
package to them.  Here the same replay runs through the port on the CPU
in float64 (the plain push, grid/push.py) and must reproduce:

  * SensorPolar2D::setStandardMask      (SensorPolar2D.cpp:59-98)
  * TsdGrid::freeFootprint              (TsdGrid.cpp:609-638)
  * TsdGrid::push / addTsd / isInRange  (TsdGrid.cpp:217-284)
  * RayCastPolar2D::calcCoordsFromCurrentViewMask, the exact march
                                        (RayCastPolar2D.cpp:113-281)
  * RayCastAxisAligned2D::calcCoords    (RayCastAxisAligned2D.cpp:13-105)
  * TsdGrid::storeGrid read back        (TsdGrid.cpp:548-607)

The fast caster's rays and the unique surface coordinates are held to the
same data in tests/test_torch_raycast_fast.py and
tests/test_torch_push_tree.py.
"""

import os

import numpy as np
import pytest
import torch

from ohm_tsd_slam_tpu_torch.config import GridConfig
from ohm_tsd_slam_tpu_torch.grid.axis_aligned import occupancy_grid
from ohm_tsd_slam_tpu_torch.grid.checkpoint import load_text
from ohm_tsd_slam_tpu_torch.grid.push import push
from ohm_tsd_slam_tpu_torch.grid.raycast import raycast
from ohm_tsd_slam_tpu_torch.grid.state import create, free_footprint
from ohm_tsd_slam_tpu_torch.sensor.polar2d import SensorPolar2D, standard_mask
from ohm_tsd_slam_tpu_torch.utils.testing import limit_cpu_threads

from golden_io import ROOM_BIN, ROOM_STORE, Scenario, load_golden

limit_cpu_threads()

pytestmark = pytest.mark.skipif(
    not os.path.exists(ROOM_BIN),
    reason="golden data not generated (make -C golden)")


@pytest.fixture(scope="module")
def golden():
    return load_golden()


@pytest.fixture(scope="module")
def scenario():
    return Scenario()


@pytest.fixture(scope="module")
def geom(scenario):
    s = scenario
    return SensorPolar2D(
        size=s.size, angular_res=s.angular_res, phi_min=s.phi_min,
        max_range=s.max_range, min_range=s.min_range,
        low_reflectivity_range=s.low_reflectivity_range)


@pytest.fixture(scope="module")
def pushed_grids(scenario, geom):
    """The scenario replayed through the port on the CPU: the grid after
    the footprint and after each push, and each masked scan."""
    s = scenario
    cfg = GridConfig(map_size=s.layout_grid, cellsize=s.cellsize,
                     truncation_radius=s.max_trunc / s.cellsize,
                     tile_dim=2 ** s.layout_part)
    grid = create(cfg, dtype=torch.float64, device="cpu")
    states = {}
    if s.footprint is not None:
        cx, cy, w, h = s.footprint
        grid = free_footprint(grid, (cx, cy), w, h)
        states["after_footprint"] = grid
    for p, (pose, ranges) in enumerate(zip(s.push_poses, s.push_ranges)):
        data, mask = standard_mask(geom, torch.as_tensor(ranges))
        grid = push(grid, geom, torch.as_tensor(pose), data, mask)
        states["after_push%02d" % p] = grid
        states["scan%02d" % p] = (data, mask)
    states["final"] = grid
    return states


def _grid_close(grid, g, tag):
    tsd = grid.tsd.numpy()
    ref = g[tag + ".tsd"]
    assert np.array_equal(np.isnan(tsd), np.isnan(ref)), tag + " NaN pattern"
    m = ~np.isnan(ref)
    np.testing.assert_allclose(tsd[m], ref[m], rtol=0, atol=1e-12,
                               err_msg=tag + " tsd")
    np.testing.assert_allclose(grid.weight.numpy(), g[tag + ".weight"],
                               rtol=0, atol=1e-12, err_msg=tag + " weight")
    init = grid.tile_init.numpy()
    initw = grid.tile_initw.numpy()
    state = init.astype(np.int32) * 2 + (~init & (initw > 0)).astype(np.int32)
    np.testing.assert_array_equal(state, g[tag + ".state"],
                                  err_msg=tag + " tile state")
    # _initWeight is compared only where the reference still reads it
    # (uninitialised tiles); the reference never resets it on init
    uninit = g[tag + ".state"] != 2
    np.testing.assert_allclose(initw[uninit], g[tag + ".initw"][uninit],
                               rtol=0, atol=1e-12, err_msg=tag + " initw")


def test_standard_mask_parity(golden, scenario, pushed_grids):
    for p in range(len(scenario.push_poses)):
        data, mask = pushed_grids["scan%02d" % p]
        np.testing.assert_array_equal(
            mask.numpy(), golden["scan%02d.mask" % p].astype(bool),
            err_msg="scan %d mask" % p)
        d = data.numpy()
        ref = golden["scan%02d.data" % p]
        assert np.array_equal(np.isinf(d), np.isinf(ref))
        fin = ~np.isinf(ref)
        np.testing.assert_allclose(d[fin], ref[fin], rtol=0, atol=0,
                                   err_msg="scan %d data" % p)


def test_footprint_parity(golden, pushed_grids):
    _grid_close(pushed_grids["after_footprint"], golden, "after_footprint")


@pytest.mark.parametrize("p", range(6))
def test_push_parity(golden, pushed_grids, p):
    _grid_close(pushed_grids["after_push%02d" % p], golden,
                "after_push%02d" % p)


@pytest.mark.parametrize("q", range(3))
def test_raycast_parity(golden, scenario, geom, pushed_grids, q):
    """The exact dense march agrees with the reference beam for beam."""
    res = raycast(pushed_grids["final"], geom,
                  torch.as_tensor(scenario.query_poses[q]))
    mask = res.mask.numpy()
    np.testing.assert_array_equal(mask, golden["ray%02d.mask" % q]
                                  .astype(bool), err_msg="ray %d mask" % q)
    np.testing.assert_allclose(res.coords.numpy()[mask],
                               golden["ray%02d.coords" % q][mask], rtol=0,
                               atol=1e-9, err_msg="ray %d coords" % q)
    np.testing.assert_allclose(res.normals.numpy()[mask],
                               golden["ray%02d.normals" % q][mask], rtol=0,
                               atol=1e-9, err_msg="ray %d normals" % q)
    assert int(golden["ray%02d.cnt" % q][0]) == int(mask.sum())


def test_axis_aligned_parity(golden, pushed_grids):
    """The free/unknown channel of the occupancy char grid and the event
    count (with the reference's tile-boundary duplicates)."""
    res = occupancy_grid(pushed_grids["final"])
    got_occ = res.occupancy.numpy()
    ref_occ = golden["axis.occ"].astype(np.int8)
    # the reference's char grid holds 0 (free) / -1 (unknown): the harness
    # did not stamp its coords list, so a cell stamped occupied (100) here
    # is compared as the reference's value there
    stamped = got_occ == 100
    np.testing.assert_array_equal(
        np.where(stamped, ref_occ, got_occ.astype(np.int8)), ref_occ,
        err_msg="occ char grid")
    assert int(golden["axis.cnt"][0]) == 2 * int(res.n_surface)


def test_store_grid_roundtrip(golden, pushed_grids):
    """The reference's storeGrid file of the final room loads in the port
    to the pushed field (the file holds 6 significant digits)."""
    grid = load_text(ROOM_STORE, dtype=torch.float64, device="cpu")
    final = pushed_grids["final"]
    ref = golden["after_push05.tsd"]
    tsd = grid.tsd.numpy()
    assert np.array_equal(np.isnan(tsd), np.isnan(ref))
    m = ~np.isnan(ref)
    np.testing.assert_allclose(tsd[m], ref[m], rtol=1e-5, atol=1e-6)
    assert grid.cell_size == pytest.approx(final.cell_size, rel=1e-5)
    assert grid.max_truncation == pytest.approx(final.max_truncation,
                                                rel=1e-5)
