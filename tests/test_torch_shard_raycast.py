"""The port's raycast against a row-sharded grid
(ohm_tsd_slam_tpu_torch/parallel/shard_raycast.py) and the push into a
row block, against the JAX package's shard_map paths
(ohm_tsd_slam_tpu/parallel/shard_raycast.py) on the same mesh shape and
against the port's own one-card functions, in float64 on the CPU.

The scene is tests/test_parallel.py::test_sharded_raycast_matches_single_
device's (map_size 8, 0.04 m cells, 361 beams, two pushes, a pillar) with
its walls moved off the lines of cell centres: a point on such a line is
where the JAX package's shard-local taps, which shift the coordinates
into the block, round into the neighbouring cell (the port takes the
block's offset off the integer row and rounds as the whole grid does).
Ranks are gloo processes (tests/torch_mesh_worker.py), one world a mesh
shape, run once for the module: (sp, dp) = (2, 1), (4, 1) and make_mesh
over 4 ranks ((2, 2)); the JAX package runs the same shapes on virtual
CPU devices.

Tolerances are tests/test_parallel.py's: the render's masks equal and its
coordinates and normals within 1e-9, the pose gradient within rtol 1e-6
(atol 1e-9; not n times the gradient, not one rank's part of it), the
residual within rtol 1e-12.  Against the port's one-card caster the mask
is equal and the coordinates within 1e-12.  The push into a row block
equals the same rows of the whole grid's push in every bit."""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ohm_tsd_slam_tpu.config import GridConfig
from ohm_tsd_slam_tpu.core import se2 as jse2
from ohm_tsd_slam_tpu.grid import create as jcreate
from ohm_tsd_slam_tpu.grid import push as jpush
from ohm_tsd_slam_tpu.parallel import mesh as jmesh
from ohm_tsd_slam_tpu.parallel.shard_raycast import (
    sharded_map_residual as j_residual,
    sharded_pose_gradient as j_gradient,
    sharded_raycast as j_raycast,
)
from ohm_tsd_slam_tpu.sensor import polar2d as jpolar
from ohm_tsd_slam_tpu_torch.grid.push import push
from ohm_tsd_slam_tpu_torch.grid.raycast_fast import ROUNDS, raycast_fast
from ohm_tsd_slam_tpu_torch.grid.state import from_arrays
from ohm_tsd_slam_tpu_torch.parallel import map_residual_loss, pose_gradient
from ohm_tsd_slam_tpu_torch.sensor.polar2d import SensorPolar2D
from ohm_tsd_slam_tpu_torch.utils.testing import (
    limit_cpu_threads,
    rect_walls,
    simulate_scan,
)
from torch_mesh_worker import GRID_FIELDS, grid_arrays, run_world

limit_cpu_threads()

SHAPES = [(2, 1), (4, 1), "auto"]
GEOM = dict(size=361, angular_res=math.radians(0.75),
            phi_min=math.radians(-135.0), max_range=9.0, min_range=0.01,
            low_reflectivity_range=1.0)
WALLS = rect_walls(1.53, 1.51, 8.47, 8.49)
PILLAR = [((7.0, 7.2), 0.5)]
BUILD = [(5.12, 5.12, 0.2), (5.3, 5.2, 0.5)]    # the pushes that make it
QUERY = [(5.0, 5.0, 0.9), (5.3, 5.2, 2.6)]      # the renders
SCANS = [((5.05, 4.95, 0.85), (0.03, -0.02, 0.01)),
         ((5.2, 5.1, 2.0), (-0.02, 0.01, -0.015))]   # scan pose, offset
PUSH = (5.4, 5.3, 0.3)


def _ids(shape):
    return "make_mesh4" if shape == "auto" else f"{shape[0]}x{shape[1]}"


def _jax_mesh(shape):
    devices = jax.devices()
    if shape == "auto":
        return jmesh.make_mesh(devices[:4])
    return Mesh(np.array(devices[:shape[0] * shape[1]]).reshape(shape),
                ("sp", "dp"))


def _scan(xyt):
    jgeom = jpolar.SensorPolar2D(**GEOM)
    pose = np.array(jse2.make(*xyt, dtype=jnp.float64))
    r = simulate_scan(pose, GEOM["size"], GEOM["angular_res"],
                      GEOM["phi_min"], GEOM["max_range"], segments=WALLS,
                      circles=PILLAR)
    data, mask = jpolar.standard_mask(jgeom, jnp.asarray(r))
    return pose, np.array(data), np.array(mask)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    jgeom = jpolar.SensorPolar2D(**GEOM)
    jgrid = jcreate(GridConfig(map_size=8, cellsize=0.04),
                    dtype=jnp.float64)
    for xyt in BUILD:
        pose, d, m = _scan(xyt)
        jgrid = jpush(jgrid, jgeom, jnp.asarray(pose), jnp.asarray(d),
                      jnp.asarray(m))
    arrays = {f: np.asarray(getattr(jgrid, f)) for f in GRID_FIELDS}
    qposes = np.stack([np.array(jse2.make(*q, dtype=jnp.float64))
                       for q in QUERY])
    gscans = [_scan(xyt) for xyt, _ in SCANS]
    gposes = np.stack([p @ np.array(jse2.make(*off, dtype=jnp.float64))
                       for (p, _, _), (_, off) in zip(gscans, SCANS)])
    ppose, pdata, pmask = _scan(PUSH)
    inputs = grid_arrays(arrays)
    inputs.update(qposes=qposes, gposes=gposes,
                  gdata=np.stack([d for _, d, _ in gscans]),
                  gmask=np.stack([m for _, _, m in gscans]),
                  push_pose=ppose, push_data=pdata, push_mask=pmask,
                  params=np.array(json.dumps({"geom": GEOM})))
    tmp = tmp_path_factory.mktemp("shard_raycast")
    ranks = {shape: run_world("raycast", inputs, shape, tmp)
             for shape in SHAPES}
    return dict(jgrid=jgrid, grid=from_arrays(arrays), inputs=inputs,
                ranks=ranks, geom=SensorPolar2D(**GEOM), jgeom=jgeom)


def _jax_sharded(case, shape):
    """The JAX package's shard_map functions on the same mesh shape, the
    grid placed row-sharded as its tests place it."""
    jm = _jax_mesh(shape)
    jgrid = case["jgrid"]
    gshard = NamedSharding(jm, P("sp", None))
    grid_sh = dataclasses.replace(jgrid,
                                  tsd=jax.device_put(jgrid.tsd, gshard))
    jgeom = case["jgeom"]
    inp = case["inputs"]
    ray = jax.jit(lambda g, p: j_raycast(jm, g, jgeom, p))
    res = jax.jit(lambda g, p, d, m: j_residual(jm, g, jgeom, p, d, m))
    grad = jax.jit(lambda g, p, d, m: j_gradient(jm, g, jgeom, p, d, m))
    scans = list(zip(inp["gposes"], inp["gdata"], inp["gmask"]))
    return ([ray(grid_sh, jnp.asarray(q)) for q in inp["qposes"]],
            [float(res(grid_sh, *map(jnp.asarray, s))) for s in scans],
            [np.asarray(grad(grid_sh, *map(jnp.asarray, s)))
             for s in scans])


@pytest.fixture(scope="module")
def jax_refs(case):
    return {shape: _jax_sharded(case, shape) for shape in SHAPES}


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_render_matches_jax(case, jax_refs, shape):
    renders, _, _ = jax_refs[shape]
    for res in case["ranks"][shape]:
        for i, ref in enumerate(renders):
            m = np.asarray(ref.mask)
            assert m.sum() > 250
            np.testing.assert_array_equal(res[f"ray{i}_mask"], m)
            np.testing.assert_allclose(res[f"ray{i}_coords"][m],
                                       np.asarray(ref.coords)[m], atol=1e-9)
            np.testing.assert_allclose(res[f"ray{i}_normals"][m],
                                       np.asarray(ref.normals)[m], atol=1e-9)
            np.testing.assert_allclose(res[f"ray{i}_ranges"],
                                       np.asarray(ref.ranges), atol=1e-9)
            assert int(res[f"ray{i}_n_dropped"]) == int(ref.n_dropped) == 0


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_render_matches_one_card(case, shape):
    """Every rank holds the one-card caster's render (the whole grid,
    the same kernels' twins)."""
    for i, q in enumerate(case["inputs"]["qposes"]):
        ref = raycast_fast(case["grid"], case["geom"], torch.from_numpy(q))
        m = ref.mask.numpy()
        for res in case["ranks"][shape]:
            np.testing.assert_array_equal(res[f"ray{i}_mask"], m)
            np.testing.assert_allclose(res[f"ray{i}_coords"],
                                       ref.coords.numpy(), rtol=0,
                                       atol=1e-12)
            np.testing.assert_allclose(res[f"ray{i}_normals"],
                                       ref.normals.numpy(), rtol=0,
                                       atol=1e-12)


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_render_collectives(case, shape):
    """One halo all_reduce, a MIN and a SUM a round (the SUM carries the
    replay's normals and the drops): 1 + 2 ROUNDS, whatever the mesh (the
    JAX package's compiled render has 2 collective-permutes and 9
    all-reduces at sp >= 2, MULTICHIP_SCALING.json)."""
    for res in case["ranks"][shape]:
        for i in range(len(QUERY)):
            assert res[f"ray{i}_collectives"][0] == 1 + 2 * ROUNDS


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_map_residual_matches_jax_and_one_card(case, jax_refs, shape):
    _, losses, _ = jax_refs[shape]
    inp = case["inputs"]
    for i, want in enumerate(losses):
        one = map_residual_loss(case["grid"], case["geom"],
                                *(torch.from_numpy(inp[k][i])
                                  for k in ("gposes", "gdata", "gmask")))
        assert want > 1e-6
        for res in case["ranks"][shape]:
            np.testing.assert_allclose(float(res[f"loss{i}"]), want,
                                       rtol=1e-12)
            np.testing.assert_allclose(float(res[f"loss{i}"]), float(one),
                                       rtol=1e-12)


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_pose_gradient_matches_jax(case, jax_refs, shape):
    """Held against jax.grad of the JAX package's sharded residual: a
    gradient n times too large, or one rank's part alone, fails."""
    _, _, grads = jax_refs[shape]
    for i, want in enumerate(grads):
        assert np.abs(want).max() > 1e-4
        for res in case["ranks"][shape]:
            np.testing.assert_allclose(res[f"grad{i}"], want, rtol=1e-6,
                                       atol=1e-9)
            # the halo, the (sum, count) pair, the gradient's sum
            assert res[f"grad{i}_collectives"][0] == 3


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_pose_gradient_matches_one_card(case, shape):
    inp = case["inputs"]
    for i in range(len(SCANS)):
        want = pose_gradient(case["grid"], case["geom"],
                             *(torch.from_numpy(inp[k][i])
                               for k in ("gposes", "gdata", "gmask")))
        for res in case["ranks"][shape]:
            np.testing.assert_allclose(res[f"grad{i}"], want.numpy(),
                                       rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_push_into_row_block_equals_whole_grid_rows(case, shape):
    inp = case["inputs"]
    whole = push(case["grid"], case["geom"],
                 *(torch.from_numpy(inp[k]) for k in
                   ("push_pose", "push_data", "push_mask")))
    sp, dp = _jax_mesh(shape).devices.shape
    h = case["grid"].cells_y // sp
    th = h // case["grid"].tile_dim
    for r, res in enumerate(case["ranks"][shape]):
        i = r // dp
        for f, rows in (("tsd", h), ("weight", h), ("tile_init", th),
                        ("tile_initw", th)):
            want = getattr(whole, f).numpy()[i * rows:(i + 1) * rows]
            assert res[f"push_{f}"].tobytes() == want.tobytes(), (r, f)
    # the scan was fused
    assert not torch.equal(whole.weight, case["grid"].weight)
