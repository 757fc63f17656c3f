"""PyTorch port vs the JAX package: the quadtree-gated push (push_tree,
branch_gate, push(tile_gate=)), the push kernel with a gate, the
axis-aligned surface points, tile_of_cell and tile_sharding.

The same numpy scans (an analytic room, seeded gates) go through both
packages on the CPU in float64, at the sizes of tests/test_inventory.py
(map_size 7, 271 beams).  The push kernel with a gate is held against its
twin on the card in tests/test_torch_push_kernel.py, which imports torch
only (the card's machine has no jax)."""

import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from ohm_tsd_slam_tpu.config import GridConfig as JGridConfig
from ohm_tsd_slam_tpu.core import se2 as jse2
from ohm_tsd_slam_tpu.grid import create as jcreate
from ohm_tsd_slam_tpu.grid.push import branch_gate as jbranch_gate
from ohm_tsd_slam_tpu.grid.push import push as jpush
from ohm_tsd_slam_tpu.grid.push import push_tree as jpush_tree
from ohm_tsd_slam_tpu.grid.axis_aligned import surface_points as jsurface
from ohm_tsd_slam_tpu.grid.state import TsdGrid as JTsdGrid
from ohm_tsd_slam_tpu.grid.state import tile_of_cell as jtile_of_cell
from ohm_tsd_slam_tpu.parallel import mesh as jmesh
from ohm_tsd_slam_tpu.sensor import polar2d as jpolar
from ohm_tsd_slam_tpu_torch.config import GridConfig
from ohm_tsd_slam_tpu_torch.core import se2
from ohm_tsd_slam_tpu_torch.grid import push_tree as push_tree_export
from ohm_tsd_slam_tpu_torch.grid.axis_aligned import surface_points
from ohm_tsd_slam_tpu_torch.grid.push import (
    branch_gate,
    push,
    push_tree,
    tile_cull,
)
from ohm_tsd_slam_tpu_torch.grid.state import (
    create,
    free_footprint,
    tile_of_cell,
    to_arrays,
)
from ohm_tsd_slam_tpu_torch.ops.push_cuda import push_cuda
from ohm_tsd_slam_tpu_torch.sensor import polar2d as tpolar
from ohm_tsd_slam_tpu_torch.utils.testing import (
    limit_cpu_threads,
    rect_walls,
    simulate_scan,
)

from golden_io import ROOM_BIN, Scenario, load_golden
from torch_mesh_worker import run_world

limit_cpu_threads()

GRID = dict(map_size=7, cellsize=0.05, truncation_radius=3.0,
            tile_dim=16)                             # 8x8 tiles of 16 cells
GEOM = dict(size=271, angular_res=math.radians(1.0),
            phi_min=math.radians(-135.0), max_range=4.0,
            min_range=0.01, low_reflectivity_range=2.0)
POSES = [(3.2, 3.2, 0.3), (3.4, 3.0, 0.5), (2.9, 3.3, -0.2)]
# the short-range case of tests/test_inventory.py: 32x32 tiles, 0.5 m
SHORT = dict(GEOM, max_range=0.5)
BIG = dict(map_size=9, cellsize=0.05, truncation_radius=3.0)
FIELDS = ("tsd", "weight", "tile_init", "tile_initw")


def _scan(xyt, geom=GEOM):
    pose = np.array(jse2.make(*xyt, dtype=jnp.float64))
    return simulate_scan(pose, geom["size"], geom["angular_res"],
                         geom["phi_min"], geom["max_range"],
                         segments=rect_walls(0.8, 0.8, 5.6, 5.6),
                         circles=[((4.5, 4.5), 0.4)])


def _inputs(xyt, geom=GEOM, dtype=torch.float64, device="cpu"):
    """(port pose, data, mask), (JAX pose, data, mask) of one scan."""
    r = _scan(xyt, geom)
    tg = tpolar.SensorPolar2D(**geom)
    jg = jpolar.SensorPolar2D(**geom)
    t = (se2.make(*xyt, dtype=dtype, device=device),
         *tpolar.standard_mask(tg, torch.as_tensor(r, dtype=dtype,
                                                   device=device)))
    j = (jse2.make(*xyt, dtype=jnp.float64),
         *jpolar.standard_mask(jg, jnp.asarray(r)))
    return tg, jg, t, j


def _jgrid(g):
    """The port grid `g` as a JAX grid."""
    d = to_arrays(g)
    return JTsdGrid(**{f: jnp.asarray(d[f]) for f in FIELDS},
                    cell_size=d["cell_size"],
                    max_truncation=d["max_truncation"],
                    max_weight=d["max_weight"], tile_dim=d["tile_dim"])


def _assert_grids_equal(tg, jg, tol):
    """The tolerance of tests/test_torch_grid.py's push parity in float64:
    NaN pattern and tile arrays equal, values within `tol`."""
    got = to_arrays(tg)
    want = {f: np.asarray(getattr(jg, f)) for f in FIELDS}
    np.testing.assert_array_equal(np.isnan(got["tsd"]),
                                  np.isnan(want["tsd"]))
    fin = ~np.isnan(got["tsd"])
    np.testing.assert_allclose(got["tsd"][fin], want["tsd"][fin], rtol=0,
                               atol=tol)
    np.testing.assert_allclose(got["weight"], want["weight"], rtol=0,
                               atol=tol)
    np.testing.assert_array_equal(got["tile_init"], want["tile_init"])
    np.testing.assert_array_equal(got["tile_initw"], want["tile_initw"])


def _assert_same_bits(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.cpu().numpy().tobytes() == y.cpu().numpy().tobytes(), f


def _gate_pose_cases():
    """(grid config, geometry, pose): the room's poses, a pose near a
    corner, and the short-range sensor at the centre of a 32x32-tile
    grid, where the gate prunes."""
    cases = [(GRID, GEOM, xyt) for xyt in POSES]
    cases += [(GRID, GEOM, (0.4, 5.9, 1.0)), (BIG, SHORT, (12.8, 12.8, 0.0)),
              (BIG, SHORT, (3.1, 20.7, 2.0))]
    return cases


@pytest.mark.parametrize("cfg,geom,xyt", _gate_pose_cases())
def test_branch_gate_equals_jax(cfg, geom, xyt):
    """The gate equals JAX's on every tile, in float64."""
    tg, jg, (pose, _, _), (jpose, _, _) = _inputs(xyt, geom)
    grid = create(GridConfig(**cfg), dtype=torch.float64, device="cpu")
    jgrid = jcreate(JGridConfig(**cfg), dtype=jnp.float64)
    got = branch_gate(grid, tg, pose).numpy()
    want = np.asarray(jbranch_gate(jgrid, jg, jpose))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.bool_ and got.shape == grid.tile_init.shape


def _push_seq(fn, jfn, dtype=torch.float64):
    """The room's poses pushed by `fn` into a port grid and by `jfn` into
    a JAX grid."""
    g = create(GridConfig(**GRID), dtype=dtype, device="cpu")
    jgrid = jcreate(JGridConfig(**GRID), dtype=jnp.float64)
    for xyt in POSES:
        tg, jg, t, j = _inputs(xyt, dtype=dtype)
        g = fn(g, tg, *t)
        jgrid = jfn(jgrid, jg, *j)
    return g, jgrid


def test_push_tree_equals_jax_f64():
    g, jgrid = _push_seq(push_tree, jpush_tree)
    _assert_grids_equal(g, jgrid, 1e-12)
    assert np.isfinite(to_arrays(g)["tsd"]).sum() > 1000
    assert push_tree_export is push_tree


@pytest.mark.parametrize("seed", [0, 1])
def test_push_with_a_random_gate_equals_jax_f64(seed):
    """push(tile_gate=) with a seeded random gate equals JAX's push with
    the same gate: the gate ANDs into touch and empty_inc alike."""
    rng = np.random.default_rng(seed)
    gates = [rng.random((8, 8)) < 0.6 for _ in POSES]
    it = iter(gates)
    jt = iter(gates)
    g, jgrid = _push_seq(
        lambda g, geom, p, d, m: push(g, geom, p, d, m,
                                      tile_gate=torch.from_numpy(next(it))),
        lambda g, geom, p, d, m: jpush(
            g, geom, p, d, m, tile_gate=jnp.asarray(next(jt))))
    _assert_grids_equal(g, jgrid, 1e-12)
    # the gate pruned tiles that the ungated push fuses
    ungated, _ = _push_seq(push, jpush)
    assert not np.array_equal(to_arrays(g)["tile_init"],
                              to_arrays(ungated)["tile_init"])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_push_tree_is_push_in_every_bit(dtype):
    """The gate is conservative, so push_tree's grid is push's, bit for
    bit, in either dtype."""
    a, _ = _push_seq(push_tree, jpush_tree, dtype)
    b, _ = _push_seq(push, jpush, dtype)
    _assert_same_bits(a, b)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("cfg,geom,xyt", _gate_pose_cases())
def test_gate_is_conservative(cfg, geom, xyt, dtype):
    """Every tile the leaf cull touches or empties passes the gate
    (tests/test_inventory.py:60-70), in float32 too."""
    tg, _, (pose, data, mask), _ = _inputs(xyt, geom, dtype)
    grid = create(GridConfig(**cfg), dtype=dtype, device="cpu")
    gate = branch_gate(grid, tg, pose)
    touch, empty_inc, _ = tile_cull(grid, tg, pose, data, mask)
    assert bool((~(touch | empty_inc) | gate).all())


def test_gate_prunes_far_tiles():
    """tests/test_inventory.py:72-87 on the port: the short-range sensor
    at the centre prunes the corners, and push_tree still equals push."""
    tg, _, (pose, data, mask), _ = _inputs((12.8, 12.8, 0.0), SHORT)
    grid = create(GridConfig(**BIG), dtype=torch.float64, device="cpu")
    gate = branch_gate(grid, tg, pose)
    assert not bool(gate[0, 0]) and not bool(gate[-1, -1])
    assert bool(gate.any()) and int((~gate).sum()) > 100
    _assert_same_bits(push_tree(grid, tg, pose, data, mask),
                      push(grid, tg, pose, data, mask))


def test_push_cuda_takes_the_gate_on_the_cpu():
    """On the CPU the wrapper runs the plain push with the gate and counts
    no launch; push_tree goes through the dispatcher to it."""
    rng = np.random.default_rng(3)
    gate = torch.from_numpy(rng.random((8, 8)) < 0.5)
    tg, _, (pose, data, mask), _ = _inputs(POSES[0])
    grid = create(GridConfig(**GRID), dtype=torch.float64, device="cpu")
    before = push_cuda.launches
    _assert_same_bits(push_cuda(grid, tg, pose, data, mask, tile_gate=gate),
                      push(grid, tg, pose, data, mask, tile_gate=gate))
    assert push_cuda.launches == before


def test_open_gate_on_a_row_block_is_the_ungated_push():
    """push's tile_gate and ty0 are separate keywords: a gate of all
    tiles on a row block gives the ungated block push in every bit."""
    tg, _, (pose, data, mask), _ = _inputs(POSES[0])
    grid = create(GridConfig(**GRID), dtype=torch.float64, device="cpu")
    block = dataclasses.replace(
        grid, tsd=grid.tsd[32:64].clone(), weight=grid.weight[32:64].clone(),
        tile_init=grid.tile_init[2:4].clone(),
        tile_initw=grid.tile_initw[2:4].clone())
    ones = torch.ones((2, 8), dtype=torch.bool)
    _assert_same_bits(push(block, tg, pose, data, mask, tile_gate=ones,
                           ty0=2),
                      push(block, tg, pose, data, mask, ty0=2))


# ---------------------------------------------------------------------------
# surface_points, tile_of_cell, tile_sharding
# ---------------------------------------------------------------------------

def test_surface_points_equal_jax_f64():
    """On a pushed room (with a footprint), points within 1e-12 of JAX's
    and the mask equal, at the fixed size H·(W−1) + (H−1)·W."""
    g, _ = _push_seq(push, jpush)
    g = free_footprint(g, (3.2, 3.2), 0.5, 0.5)
    pts, mask = surface_points(g)
    jpts, jmask = jsurface(_jgrid(g))
    H, W = g.tsd.shape
    assert pts.shape == (H * (W - 1) + (H - 1) * W, 2)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    m = mask.numpy()
    assert m.sum() > 50
    np.testing.assert_allclose(pts.numpy()[m], np.asarray(jpts)[m], rtol=0,
                               atol=1e-12)


def test_surface_points_match_golden_coords():
    """tests/test_reference_parity.py:190-200 on the port: the golden
    room pushed by the port, coordinates as unique sets within 1e-12 of
    the compiled reference's `axis.coords`."""
    if not os.path.exists(ROOM_BIN):
        pytest.skip("golden data not generated (make -C golden)")
    s = Scenario()
    geom = tpolar.SensorPolar2D(
        size=s.size, angular_res=s.angular_res, phi_min=s.phi_min,
        max_range=s.max_range, min_range=s.min_range,
        low_reflectivity_range=s.low_reflectivity_range)
    g = create(GridConfig(map_size=s.layout_grid, cellsize=s.cellsize,
                          truncation_radius=s.max_trunc / s.cellsize,
                          tile_dim=2 ** s.layout_part), dtype=torch.float64,
               device="cpu")
    if s.footprint is not None:
        cx, cy, w, h = s.footprint
        g = free_footprint(g, (cx, cy), w, h)
    for pose, ranges in zip(s.push_poses, s.push_ranges):
        d, m = tpolar.standard_mask(geom, torch.as_tensor(ranges))
        g = push(g, geom, torch.as_tensor(pose), d, m)
    pts, mask = surface_points(g)
    got = np.unique(pts.numpy()[mask.numpy()], axis=0)
    ref = np.unique(load_golden()["axis.coords"], axis=0)
    assert got.shape == ref.shape

    def key(a):
        return np.lexsort((a[:, 1], a[:, 0]))

    np.testing.assert_allclose(got[key(got)], ref[key(ref)], rtol=0,
                               atol=1e-12)


def test_tile_of_cell_equals_jax():
    rng = np.random.default_rng(2)
    ix = rng.integers(0, 128, 50)
    iy = rng.integers(0, 128, 50)
    g = create(GridConfig(**GRID), device="cpu")
    jg = jcreate(JGridConfig(**GRID))
    got = tile_of_cell(g, torch.as_tensor(ix), torch.as_tensor(iy))
    want = jtile_of_cell(jg, jnp.asarray(ix), jnp.asarray(iy))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tile_of_cell(g, 17, 40) == (2, 1)


def test_tile_sharding_in_a_world_of_two(tmp_path):
    """tile_sharding on each rank of a gloo world (sp, dp) = (2, 1): the
    shard JAX places on that rank's device, and grid_sharding's tile
    rows, both in every bit; an uneven split raises."""
    rng = np.random.default_rng(4)
    tiles = rng.uniform(0, 3, (8, 8)).astype(np.float32)
    ranks = run_world("tiles", {"tiles": tiles}, (2, 1), tmp_path)
    jm = Mesh(np.array(jax.devices()[:2]).reshape(2, 1), ("sp", "dp"))
    placed = jax.device_put(tiles, jmesh.tile_sharding(jm))
    for r, res in enumerate(ranks):
        want = next(np.asarray(s.data) for s in placed.addressable_shards
                    if s.device == jm.devices[r, 0])
        assert res["tiles"].tobytes() == want.tobytes(), r
        assert res["from_grid"].tobytes() == want.tobytes(), r
        assert res["init_rows"].tobytes() == res["init_want"].tobytes(), r
        assert bool(res["raised"])
