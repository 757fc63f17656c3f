"""The port's multi-robot step over a mesh (ohm_tsd_slam_tpu_torch/
parallel/sharded.py: make_sharded_step, multi_robot_slam_step(mesh=))
against the JAX package's make_sharded_step on the same mesh shape and
against the port's one-card step, in float64 on the CPU, in the modes ICP
and GN (this file), TSD and AMCL (test_torch_sharded_step_tsd.py and
_amcl.py).

Inputs are tests/test_torch_parallel.py's (tests/test_parallel.py's base
grid and four robots); in the modes that draw, the draws JAX makes from
each robot's key are injected into the port.  Ranks are gloo processes
(tests/torch_mesh_worker.py), one world a mesh shape running every mode
of the file: (sp, dp) = (2, 1), (4, 1) and make_mesh over 4 ranks, (2, 2),
where each rank registers two of the four robots.  Each rank returns its
row block of the new grid and every robot's results.

Tolerances are tests/test_parallel.py's (:64-86): poses within 1e-9, the
pose gradient within rtol 1e-6 (atol 1e-9), the grid NaN for NaN and
within rtol 1e-9 / atol 1e-12; the registration errors equal."""

import json

import jax
import numpy as np
import pytest

from ohm_tsd_slam_tpu.parallel import make_sharded_step as j_make_step
from ohm_tsd_slam_tpu.parallel import mesh as jmesh
from ohm_tsd_slam_tpu_torch.grid.raycast_fast import ROUNDS
from ohm_tsd_slam_tpu_torch.parallel import multi_robot_slam_step
from ohm_tsd_slam_tpu_torch.utils.testing import limit_cpu_threads
from jax.sharding import Mesh
from test_torch_parallel import (
    AMCL,
    BOUNDS,
    FIELDS,
    GEOM,
    MODES,
    RANSAC,
    _amcl_draws,
    _case,
    _params,
    _tsd_draws,
)
from torch_mesh_worker import GRID_FIELDS, grid_arrays, run_world

limit_cpu_threads()

SHAPES = [(2, 1), (4, 1), "auto"]
STEP_MODES = ("icp", "gn")


def _ids(shape):
    return "make_mesh4" if shape == "auto" else f"{shape[0]}x{shape[1]}"


def jax_mesh(shape):
    devices = jax.devices()
    if shape == "auto":
        return jmesh.make_mesh(devices[:4])
    return Mesh(np.array(devices[:shape[0] * shape[1]]).reshape(shape),
                ("sp", "dp"))


def run_case(modes, tmp):
    """The worlds of every shape running `modes`, the JAX package's
    sharded steps on the same shapes and the port's one-card steps."""
    c = _case()
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    inputs = grid_arrays({f: np.asarray(getattr(c["jgrid"], f))
                          for f in GRID_FIELDS})
    inputs.update(poses=np.asarray(c["jposes"]), data=np.asarray(c["jdata"]),
                  mask=np.asarray(c["jmask"]),
                  params=np.array(json.dumps(
                      {"geom": GEOM, "icp_iterations": 15,
                       "bounds": list(BOUNDS), "ransac": RANSAC,
                       "amcl": AMCL, "modes": {m: MODES[m] for m in modes}})))
    inject = {}
    for name, draws in (("tsd", _tsd_draws), ("amcl", _amcl_draws)):
        if name in modes:
            inject[name] = draws(c, _params(MODES[name])[0], keys)
            for r, inj in enumerate(inject[name]):
                for f in inj._fields:
                    inputs[f"{name}{r}_{f}"] = getattr(inj, f).numpy()
    ranks = {shape: run_world("step", inputs, shape, tmp)
             for shape in SHAPES}
    jax_out, one_card = {}, {}
    for mode in modes:
        jparams, tparams = _params(MODES[mode])
        one_card[mode] = multi_robot_slam_step(
            c["grid"], c["poses"], c["data"], c["mask"], tparams,
            inject=inject.get(mode))
        for shape in SHAPES:
            jm = jax_mesh(shape)
            step, place = j_make_step(jm, jparams)
            with jm:
                args = place(c["jgrid"], c["jposes"], c["jdata"],
                             c["jmask"])
                jax_out[shape, mode] = jax.block_until_ready(
                    step(*args, key=jax.random.PRNGKey(0)))
    return dict(c=c, ranks=ranks, jax=jax_out, one_card=one_card)


def expected_collectives(mode: str, robots_a_rank: int) -> int:
    """all_reduce calls a step takes on a rank: a render (1 + 2 ROUNDS)
    and its matcher's for each of its robots, the pose gradient's 3 each,
    and one gather of every robot's results over dp."""
    render = 1 + 2 * ROUNDS
    per_robot = {"icp": render, "gn": 1 + 30, "tsd": render + 3,
                 "amcl": render + 2 + AMCL["iterations"] + 1}[mode]
    return robots_a_rank * (per_robot + 3) + 1


def check_step(case, shape, mode):
    """The rank results of one (shape, mode) against the JAX package's
    sharded step and the port's one-card step."""
    ref, one = case["jax"][shape, mode], case["one_card"][mode]
    sp, dp = jax_mesh(shape).devices.shape
    H = case["c"]["grid"].cells_y
    h, th = H // sp, H // sp // case["c"]["grid"].tile_dim
    for r, res in enumerate(case["ranks"][shape]):
        np.testing.assert_array_equal(res[f"{mode}_reg_error"],
                                      np.asarray(ref.reg_error))
        assert not res[f"{mode}_reg_error"].all()
        for want in (np.asarray(ref.poses), one.poses.numpy()):
            np.testing.assert_allclose(res[f"{mode}_poses"], want,
                                       rtol=1e-9, atol=1e-9)
        for want in (np.asarray(ref.pose_grad), one.pose_grad.numpy()):
            np.testing.assert_allclose(res[f"{mode}_pose_grad"], want,
                                       rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(res[f"{mode}_rms"], one.rms.numpy(),
                                   rtol=1e-6, atol=1e-12)
        assert int(res[f"{mode}_rays_dropped"]) == 0
        i = r // dp
        for f in FIELDS:
            rows = th if f.startswith("tile") else h
            got = res[f"{mode}_grid_{f}"]
            for want in (np.asarray(getattr(ref.grid, f)),
                         getattr(one.grid, f).numpy()):
                want = want[i * rows:(i + 1) * rows]
                if got.dtype == bool:
                    np.testing.assert_array_equal(got, want, err_msg=f)
                    continue
                np.testing.assert_array_equal(np.isnan(got), np.isnan(want),
                                              err_msg=f)
                ok = ~np.isnan(want)
                np.testing.assert_allclose(got[ok], want[ok], rtol=1e-9,
                                           atol=1e-12, err_msg=f)
        assert res[f"{mode}_collectives"][0] == expected_collectives(
            mode, 4 // dp)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    return run_case(STEP_MODES, tmp_path_factory.mktemp("sharded_step"))


@pytest.mark.parametrize("mode", STEP_MODES)
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_sharded_step_matches_jax_and_one_card(case, shape, mode):
    check_step(case, shape, mode)
