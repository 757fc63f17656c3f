"""The port's grid-reading matchers against a row-sharded grid
(ohm_tsd_slam_tpu_torch/parallel/shard_matchers.py) against the JAX
package's shard_map matchers (ohm_tsd_slam_tpu/parallel/shard_matchers.py)
on the same mesh shape and against the port's one-card matchers, in
float64 on the CPU; and the three hooks the sharded matchers plug into
(`match_tsd`'s and `match_amcl`'s logp_sum_fn, `match_gauss_newton`'s
field_fn, reduce_fn and max_truncation).

Inputs are tests/test_torch_parallel.py's (tests/test_parallel.py's base
grid and robots, RANSAC at 30 trials and 60 control points, AMCL at 64
particles and 3 iterations): robot 1's scan against the model the JAX
package renders from its pose, the draws JAX makes from that robot's key
injected into the port (the packages cannot draw the same numbers).  Ranks
are gloo processes (tests/torch_mesh_worker.py), one world a mesh shape:
(sp, dp) = (2, 1), (4, 1) and make_mesh over 4 ranks ((2, 2)).
Tolerances are tests/test_parallel.py's: transforms within 1e-9 (GN's
rtol 1e-9, atol 1e-12), GN's rms within rtol 1e-9 and its match count
equal."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ohm_tsd_slam_tpu.parallel import mesh as jmesh
from ohm_tsd_slam_tpu.parallel.shard_matchers import (
    sharded_match_amcl as j_amcl,
    sharded_match_gauss_newton as j_gn,
    sharded_match_tsd as j_tsd,
)
from ohm_tsd_slam_tpu.core import se2 as jse2
from ohm_tsd_slam_tpu.grid.raycast_fast import raycast_fast as jraycast_fast
from ohm_tsd_slam_tpu.registration.gauss_newton import GnParams as JGnParams
from ohm_tsd_slam_tpu.sensor.polar2d import data_to_cartesian as j_cart
from ohm_tsd_slam_tpu_torch.grid.interpolate import interpolate_bilinear
from ohm_tsd_slam_tpu_torch.grid.state import INTERPOLATE_SUCCESS
from ohm_tsd_slam_tpu_torch.registration import amcl as tamcl
from ohm_tsd_slam_tpu_torch.registration import gauss_newton as tgn
from ohm_tsd_slam_tpu_torch.registration import ransac as tr
from ohm_tsd_slam_tpu_torch.utils.testing import limit_cpu_threads
from test_torch_parallel import (
    AMCL,
    RANSAC,
    _amcl_draws,
    _case,
    _params,
    _tsd_draws,
)
from torch_mesh_worker import GRID_FIELDS, grid_arrays, run_world

limit_cpu_threads()

SHAPES = [(2, 1), (4, 1), "auto"]
ROBOT = 1
GN = dict(iterations=12)
GN_OFFSET = (0.02, -0.015, 0.01)


def _ids(shape):
    return "make_mesh4" if shape == "auto" else f"{shape[0]}x{shape[1]}"


def _jax_mesh(shape):
    devices = jax.devices()
    if shape == "auto":
        return jmesh.make_mesh(devices[:4])
    return Mesh(np.array(devices[:shape[0] * shape[1]]).reshape(shape),
                ("sp", "dp"))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    c = _case()
    jparams, tparams = _params(3)
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    r = ROBOT
    jgeom = jparams.geom
    model = jraycast_fast(c["jgrid"], jgeom, c["jposes"][r])
    scene, smask = j_cart(jgeom, c["jdata"][r], c["jmask"][r])
    gn_pose = c["jposes"][r] @ jse2.make(*GN_OFFSET, dtype=jnp.float64)
    tsd_inj = _tsd_draws(c, jparams, keys)[r]
    amcl_inj = _amcl_draws(c, jparams, keys)[r]
    inputs = grid_arrays({f: np.asarray(getattr(c["jgrid"], f))
                          for f in GRID_FIELDS})
    inputs.update(pose=np.asarray(c["jposes"][r]), scene=np.asarray(scene),
                  smask=np.asarray(smask), model=np.asarray(model.coords),
                  model_mask=np.asarray(model.mask),
                  gn_pose=np.asarray(gn_pose),
                  params=np.array(json.dumps(
                      {"ransac": RANSAC, "amcl": AMCL, "gn": GN})))
    for name, inj in (("tsd", tsd_inj), ("amcl", amcl_inj)):
        for f in inj._fields:
            inputs[f"{name}0_{f}"] = getattr(inj, f).numpy()
    tmp = tmp_path_factory.mktemp("shard_matchers")
    ranks = {shape: run_world("matchers", inputs, shape, tmp)
             for shape in SHAPES}
    return dict(c=c, jparams=jparams, tparams=tparams, key=keys[r],
                inputs=inputs, ranks=ranks, tsd_inj=tsd_inj,
                amcl_inj=amcl_inj)


@pytest.fixture(scope="module")
def jax_refs(case):
    """The JAX package's sharded matchers on each mesh shape."""
    c, p, inp = case["c"], case["jparams"], case["inputs"]
    pose, scene, smask, model, mmask, gn_pose = (
        jnp.asarray(inp[k]) for k in ("pose", "scene", "smask", "model",
                                      "model_mask", "gn_pose"))
    out = {}
    for shape in SHAPES:
        jm = _jax_mesh(shape)
        g = c["jgrid"]
        g = dataclasses.replace(g, tsd=jax.device_put(
            g.tsd, NamedSharding(jm, P("sp", None))))
        tsd = jax.jit(lambda g, k: j_tsd(jm, k, g, pose, model, mmask, scene,
                                         smask, p.ransac))(g, case["key"])
        amcl = jax.jit(lambda g, k: j_amcl(jm, k, g, pose, scene, smask,
                                           p.amcl))(g, case["key"])
        gn = jax.jit(lambda g: j_gn(jm, g, gn_pose, scene, smask,
                                    JGnParams(**GN)))(g)
        out[shape] = dict(tsd=np.asarray(tsd), amcl=np.asarray(amcl), gn=gn)
    return out


def _one_card(case):
    c, tp, inp = case["c"], case["tparams"], case["inputs"]
    pose, scene, smask = (_t(inp[k]) for k in ("pose", "scene", "smask"))
    return dict(
        tsd=tr.match_tsd(None, c["grid"], pose, _t(inp["model"]),
                         _t(inp["model_mask"]), scene, smask, tp.ransac,
                         inject=case["tsd_inj"]),
        amcl=tamcl.match_amcl(None, c["grid"], pose, scene, smask, tp.amcl,
                              inject=case["amcl_inj"]),
        gn=tgn.match_gauss_newton(c["grid"], _t(inp["gn_pose"]), scene, smask,
                                  tgn.GnParams(**GN)))


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_match_tsd_matches_jax_and_one_card(case, jax_refs, shape):
    want = jax_refs[shape]["tsd"]
    one = _one_card(case)["tsd"].numpy()
    assert np.abs(want - np.eye(3)).max() > 1e-4
    for res in case["ranks"][shape]:
        np.testing.assert_allclose(res["tsd_T"], want, rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(res["tsd_T"], one, rtol=1e-9, atol=1e-9)
        # the halo, the whole tile_init, one sum of the candidates' scores
        assert res["tsd_collectives"][0] == 3


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_match_amcl_matches_jax_and_one_card(case, jax_refs, shape):
    want = jax_refs[shape]["amcl"]
    one = _one_card(case)["amcl"].numpy()
    assert np.abs(want - np.eye(3)).max() > 1e-4
    for res in case["ranks"][shape]:
        np.testing.assert_allclose(res["amcl_T"], want, rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(res["amcl_T"], one, rtol=1e-9, atol=1e-9)
        # the halo, tile_init, a sum each iteration and the final pick
        assert res["amcl_collectives"][0] == 2 + AMCL["iterations"] + 1


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_match_gauss_newton_matches_jax_and_one_card(case, jax_refs, shape):
    want = jax_refs[shape]["gn"]
    one = _one_card(case)["gn"]
    for res in case["ranks"][shape]:
        for ref in (want, one):
            np.testing.assert_allclose(res["gn_T"], np.asarray(ref.T),
                                       rtol=1e-9, atol=1e-12)
            np.testing.assert_allclose(float(res["gn_rms"]),
                                       float(ref.rms), rtol=1e-9)
            assert int(res["gn_matches"]) == int(ref.matches) > 50
        # the halo, then one sum of the normal equations an iteration
        assert res["gn_collectives"][0] == 1 + GN["iterations"]


# ---- the hooks: in place of the grid taps, bit for bit ----------------

def _default_logp_sum(grid, zrand):
    """What match_tsd and match_amcl compute without a hook."""
    def fn(world, pmask):
        tsd, code = interpolate_bilinear(grid, world.reshape(-1, 2))
        logp = torch.where(
            code == INTERPOLATE_SUCCESS,
            torch.log((1.0 - (1.0 - zrand) * tsd.abs()).clamp(min=1e-30)),
            float(np.log(zrand))).reshape(world.shape[:-1])
        return torch.where(pmask, logp, 0.0).sum(-1)
    return fn


def test_match_tsd_hook_replaces_the_taps(case):
    c, tp, inp = case["c"], case["tparams"], case["inputs"]
    args = (_t(inp["pose"]), _t(inp["model"]), _t(inp["model_mask"]),
            _t(inp["scene"]), _t(inp["smask"]), tp.ransac)
    plain = tr.match_tsd(None, c["grid"], *args, inject=case["tsd_inj"])
    hooked = tr.match_tsd(None, None, *args, inject=case["tsd_inj"],
                          logp_sum_fn=_default_logp_sum(
                              c["grid"], tp.ransac.zrand_tsd))
    assert torch.equal(plain, hooked)
    assert not torch.equal(plain, torch.eye(3, dtype=plain.dtype))


def test_match_amcl_hook_replaces_the_taps(case):
    c, tp, inp = case["c"], case["tparams"], case["inputs"]
    args = (_t(inp["pose"]), _t(inp["scene"]), _t(inp["smask"]), tp.amcl)
    plain = tamcl.match_amcl(None, c["grid"], *args, inject=case["amcl_inj"])
    hooked = tamcl.match_amcl(None, None, *args, inject=case["amcl_inj"],
                              logp_sum_fn=_default_logp_sum(
                                  c["grid"], tp.amcl.zrand))
    assert torch.equal(plain, hooked)


def test_match_gauss_newton_hooks_replace_the_taps(case):
    c, inp = case["c"], case["inputs"]
    grid = c["grid"]
    args = (_t(inp["gn_pose"]), _t(inp["scene"]), _t(inp["smask"]),
            tgn.GnParams(**GN))
    plain = tgn.match_gauss_newton(grid, *args)
    hooked = tgn.match_gauss_newton(
        None, *args, field_fn=lambda x: tgn._field_value_grad(grid, x),
        reduce_fn=lambda stats: stats, max_truncation=grid.max_truncation)
    for f in plain._fields:
        assert torch.equal(getattr(plain, f), getattr(hooked, f)), f
    assert int(plain.matches) > 50
