"""The port's compiled entry points (utils/compiled.py and the five
`*_jit` names: localize_step_jit, icp_jit, extract_segments_jit,
raycast_fast_jit, match_gauss_newton_jit) on the CPU, in float64.

On CPU tensors each runs its eager function and builds no graph; here
each is held against the JAX package's `*_jit` on the same inputs: the
grid, poses and scans of tests/test_torch_parallel.py's case (the 6.4 m
room of tests/test_parallel.py, one JAX push, 181 beams), carried into
the port through the grid's arrays.  localize_step_jit runs in the modes
ICP and GN, and in TSD and AMCL with the JAX package's draws for the
robot's key injected into the port's matcher (the packages cannot draw
the same numbers), as tests/test_torch_parallel.py mirrors them.
Tolerances are those of the parity tests of the same stages: poses,
transforms and RMS within 1e-9 (tests/test_torch_parallel.py,
tests/test_torch_gauss_newton.py, tests/test_torch_registration.py), the
caster's coordinates and normals within 1e-9
(tests/test_torch_raycast_fast.py), every flag, count and mask equal.

On a segment cache that overflows its capacity (the same in both
packages) the port's localize_step renders with the exact march, as the
JAX package's guarded step does, and reports the fast caster's drops.

The node's trace with the compiled step equals the eager node's in every
bit, in the modes ICP and TSD (its draws included); the cache key
separates static arguments, shapes, dtypes, None-ness and a segment
cache's staleness, and equal inputs in other tensors share one key.
The replay itself is tested on the card (tests/test_torch_compiled_cuda.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ohm_tsd_slam_tpu.grid import raycast_fast as jrf
from ohm_tsd_slam_tpu.registration import ransac as jr
from ohm_tsd_slam_tpu.registration.gauss_newton import (
    match_gauss_newton_jit as j_gn_jit,
)
from ohm_tsd_slam_tpu.registration.icp import icp_jit as j_icp_jit
from ohm_tsd_slam_tpu.sensor.polar2d import data_to_cartesian as j_cart
from ohm_tsd_slam_tpu.slam import localize as jlocalize
from ohm_tsd_slam_tpu_torch.grid import raycast_fast as rf
from ohm_tsd_slam_tpu_torch.registration.ransac import RansacInject
from ohm_tsd_slam_tpu_torch.registration.gauss_newton import (
    match_gauss_newton_jit,
)
from ohm_tsd_slam_tpu_torch.registration.icp import icp_jit
from ohm_tsd_slam_tpu_torch.sensor.polar2d import data_to_cartesian
from ohm_tsd_slam_tpu_torch.slam import localize as tlocalize
from ohm_tsd_slam_tpu_torch.slam import node as tnode
from ohm_tsd_slam_tpu_torch.utils import compiled as tcompiled
from ohm_tsd_slam_tpu_torch.utils.compiled import Compiled, compiled
from ohm_tsd_slam_tpu_torch.utils.testing import limit_cpu_threads
from test_torch_amcl import jax_draws
from test_torch_parallel import MODES, _case, _params
from test_torch_slam import ROOM_CFG, _cpu_node, _ransac_cfg, _room_scan

limit_cpu_threads()

TOL = 1e-9
ROBOT = 1                    # the case's robot: 0.15 m off the centre


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


def _equal(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _inputs():
    c = _case()
    r = ROBOT
    return c, (c["poses"][r], c["data"][r], c["mask"][r]), (
        c["jposes"][r], c["jdata"][r], c["jmask"][r])


def _tsd_draws(jparams, key, jgrid, jseg, jpose, jdata, jmask):
    """The draws match_tsd makes from `key` on the model the JAX step
    renders (ohm_tsd_slam_tpu/registration/ransac.py::_prepare), as a
    RansacInject of the port: tests/test_torch_parallel.py::_tsd_draws
    for one robot, its render jitted."""
    p = jparams.ransac
    r_ = p.pca_search_range // 2
    model = jrf.raycast_fast_jit(jgrid, jparams.geom, jpose, segments=jseg)
    k_sub, k_trial, k_ctrl = jax.random.split(key, 3)
    scene, smask = j_cart(jparams.geom, jdata, jmask)
    _, mask_mp = jr.pca_normals(model.coords, model.mask, r_)
    sub = jr.subsample_mask(k_sub, smask)
    _, msp = jr.pca_normals(scene, smask, r_)
    c_idx, c_valid = jr.random_valid_subset(k_ctrl, msp & sub,
                                            p.size_control_set)
    t_idx, t_valid = jr.random_valid_subset(k_trial, mask_mp, p.trials)
    return RansacInject(*(_t(x) for x in (sub, c_idx, c_valid, t_idx,
                                          t_valid)))


@pytest.fixture
def no_graphs(monkeypatch):
    """A graph built on the CPU fails the test."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA graph was built for a CPU call")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", refuse)
    monkeypatch.setattr(torch.cuda, "graph", refuse)


@pytest.mark.parametrize("mode", list(MODES))
def test_localize_step_jit_matches_jax(mode, monkeypatch, no_graphs):
    c, (pose, data, mask), (jpose, jdata, jmask) = _inputs()
    jparams, tparams = _params(MODES[mode])
    key = jax.random.split(jax.random.PRNGKey(0), 4)[ROBOT]
    seg = rf.extract_segments_jit(c["grid"])
    jseg = jrf.extract_segments_jit(c["jgrid"])
    if mode == "tsd":
        inject = _tsd_draws(jparams, key, c["jgrid"], jseg, jpose, jdata,
                            jmask)
        match = tlocalize.match_tsd
        monkeypatch.setattr(tlocalize, "match_tsd", lambda g, *a, **k: match(
            None, *a, inject=inject, **k))
    elif mode == "amcl":
        inject = jax_draws(key, j_cart(jparams.geom, jdata, jmask)[1],
                           jparams.amcl)
        match = tlocalize.match_amcl
        monkeypatch.setattr(tlocalize, "match_amcl", lambda g, *a, **k: match(
            None, *a, inject=inject, **k))
    captures = tlocalize.localize_step_jit.compiled.captures
    got = tlocalize.localize_step_jit(c["grid"], pose, pose, data, mask,
                                      tparams, segments=seg)
    want = jlocalize.localize_step_jit(c["jgrid"], jpose, jpose, jdata,
                                       jmask, jparams, key=key,
                                       segments=jseg)
    assert tlocalize.localize_step_jit.compiled.captures == captures
    for f in ("reg_error", "significant", "model_valid", "scene_valid",
              "icp_iterations", "rays_dropped"):
        assert int(getattr(got, f)) == int(getattr(want, f)), f
    assert not bool(got.reg_error) and int(got.rays_dropped) == 0
    for f in ("pose", "T", "rms"):
        _close(getattr(got, f), getattr(want, f))
    eager = tlocalize.localize_step(c["grid"], pose, pose, data, mask,
                                    tparams, segments=seg)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(eager, f)), f


OVERFLOW_SEGMENTS = 128       # below the case grid's 283 segments


def test_localize_step_guards_an_overflow_as_jax(no_graphs):
    """A segment cache that overflows its capacity, the same in both
    packages: the JAX step renders with the guarded caster
    (raycast_checked: the exact march), so the port's step must too, and
    report the fast caster's drop count."""
    c, (pose, data, mask), (jpose, jdata, jmask) = _inputs()
    jparams, tparams = _params(MODES["icp"])
    assert tparams.fast_raycast and jparams.fast_raycast
    seg = rf.extract_segments(c["grid"], max_segments=OVERFLOW_SEGMENTS)
    jseg = jrf.extract_segments(c["jgrid"], max_segments=OVERFLOW_SEGMENTS)
    assert int(seg.n_dropped) == int(jseg.n_dropped) > 0
    got = tlocalize.localize_step(c["grid"], pose, pose, data, mask,
                                  tparams, segments=seg)
    want = jlocalize.localize_step(c["jgrid"], jpose, jpose, jdata, jmask,
                                   jparams, segments=jseg)
    for f in ("reg_error", "significant", "model_valid", "scene_valid",
              "icp_iterations", "rays_dropped"):
        assert int(getattr(got, f)) == int(getattr(want, f)), f
    assert int(got.rays_dropped) > 0 and not bool(got.reg_error)
    for f in ("pose", "T", "rms"):
        _close(getattr(got, f), getattr(want, f))
    compiled_ = tlocalize.localize_step_jit(c["grid"], pose, pose, data,
                                            mask, tparams, segments=seg)
    for f in got._fields:
        assert torch.equal(getattr(compiled_, f), getattr(got, f)), f


def test_icp_jit_matches_jax(no_graphs):
    c, (pose, data, mask), (jpose, jdata, jmask) = _inputs()
    jparams, tparams = _params(MODES["icp"])
    model = rf.raycast_fast_jit(c["grid"], tparams.geom, pose)
    jmodel = jrf.raycast_fast_jit(c["jgrid"], jparams.geom, jpose)
    scene, smask = data_to_cartesian(tparams.geom, data, mask)
    jscene, jsmask = j_cart(jparams.geom, jdata, jmask)
    seed = torch.tensor([[1.0, -0.02, 0.03], [0.02, 1.0, -0.02],
                         [0.0, 0.0, 1.0]], dtype=torch.float64)
    for record in (False, True):
        p = dataclasses.replace(tparams.icp, record_pairs=record,
                                record_T=record)
        jp = dataclasses.replace(jparams.icp, record_pairs=record,
                                 record_T=record)
        got = icp_jit(model.coords, model.mask, scene, smask, p,
                           T_init=seed, sensor_pose=pose,
                           model_normals=model.normals)
        want = j_icp_jit(jmodel.coords, jmodel.mask, jscene, jsmask, jp,
                            T_init=jnp.asarray(seed.numpy()),
                            sensor_pose=jpose, model_normals=jmodel.normals)
        _close(got.T, want.T)
        _close(got.rms, want.rms)
        for f in ("iterations", "state", "pairs", "pair_history"):
            _equal(getattr(got, f), getattr(want, f))
        assert int(got.iterations) > 1
        if record:
            _equal(got.pair_mask_history, want.pair_mask_history)
            _close(got.T_history, want.T_history)
        else:
            assert got.T_history is None and got.pair_idx_history is None


def test_match_gauss_newton_jit_matches_jax(no_graphs):
    c, (pose, data, mask), (jpose, jdata, jmask) = _inputs()
    jparams, tparams = _params(MODES["gn"])
    scene, smask = data_to_cartesian(tparams.geom, data, mask)
    jscene, jsmask = j_cart(jparams.geom, jdata, jmask)
    start = pose.clone()
    start[0, 2] += 0.04
    start[1, 2] -= 0.03
    got = match_gauss_newton_jit(c["grid"], start, scene, smask,
                                     tparams.gn)
    want = j_gn_jit(c["jgrid"], jnp.asarray(start.numpy()),
                                      jscene, jsmask, jparams.gn)
    _close(got.T, want.T)
    _close(got.rms, want.rms)
    assert int(got.matches) == int(want.matches) > 50
    assert int(got.iterations) == int(want.iterations)


def test_extract_segments_jit_and_raycast_fast_jit_match_jax(no_graphs):
    c, (pose, _, _), (jpose, _, _) = _inputs()
    jparams, tparams = _params(MODES["icp"])
    seg = rf.extract_segments_jit(c["grid"])
    jseg = jrf.extract_segments_jit(c["jgrid"])
    eager = rf.extract_segments(c["grid"])
    for f in rf.SegmentCache._fields:
        a, b = getattr(seg, f), getattr(eager, f)
        assert (a is b) if f == "tsd" else (
            a == b if f == "version" else torch.equal(a, b)), f
    assert not rf.is_stale(seg, c["grid"])
    valid = seg.valid.numpy()
    _equal(seg.valid, jseg.valid)
    assert int(seg.n_dropped) == int(jseg.n_dropped) == 0
    assert int(seg.count) == int(valid.sum()) > 50
    # within rounding of the endpoints, as tests/test_torch_raycast_fast.py
    for f in ("p0", "p1"):
        np.testing.assert_allclose(getattr(seg, f).numpy()[valid],
                                   np.asarray(getattr(jseg, f))[valid],
                                   rtol=4 * np.finfo(np.float64).eps, atol=0)
    for segments, jsegments in ((seg, jseg), (None, None)):
        got = rf.raycast_fast_jit(c["grid"], tparams.geom, pose,
                                  segments=segments)
        want = jrf.raycast_fast_jit(c["jgrid"], jparams.geom, jpose,
                                    segments=jsegments)
        m = got.mask.numpy()
        _equal(got.mask, want.mask)
        assert int(got.n_dropped) == int(want.n_dropped) == 0
        assert m.sum() > 100
        for f in ("coords", "normals"):
            np.testing.assert_allclose(getattr(got, f).numpy()[m],
                                       np.asarray(getattr(want, f))[m],
                                       rtol=0, atol=TOL)


@pytest.mark.parametrize("mode", [0, 3], ids=["icp", "tsd"])
def test_node_trace_compiled_equals_eager(mode, monkeypatch, no_graphs):
    """The node as it is (localize_step_jit, extract_segments_jit) against
    the node with the eager localize_step and extract_segments put in
    their place."""
    cfg = ROOM_CFG if mode == 0 else _ransac_cfg(mode)

    def trace():
        node = _cpu_node(cfg, seed=5)
        poses = []
        for k in range(6):
            node.process_scan(0, _room_scan(5.12 + 0.03 * k, float(k)))
            poses.append(node.localizers[0].pose)
        return torch.stack(poses)

    got = trace()
    monkeypatch.setattr(tnode, "localize_step_jit", tlocalize.localize_step)
    monkeypatch.setattr(tnode, "extract_segments_jit", rf.extract_segments)
    assert torch.equal(got, trace())


def _fn(x, y=None, flag=False, scale=1.0):
    return x * scale if y is None else x + y


def test_key_separates_what_the_capture_froze():
    f = Compiled(_fn, static_argnames=("flag",))
    x = torch.zeros(3)
    base, leaves = f.key(x)
    assert leaves == [x]
    assert f.key(torch.ones(3))[0] == base              # other values
    assert f.key(x=torch.ones(3), flag=False)[0] == base
    others = [f.key(torch.zeros(4)),                    # shape
              f.key(torch.zeros(3, dtype=torch.float64)),   # dtype
              f.key(x, torch.zeros(3)),                 # None-ness
              f.key(x, flag=True),                      # a static argument
              f.key(x, scale=2.0),                      # a Python number
              f.key(x, scale=1)]                        # ... and its type
    keys = [base] + [k for k, _ in others]
    assert len(set(keys)) == len(keys)
    with pytest.raises(TypeError):
        f.key(x, flag=[1])                              # not hashable
    with pytest.raises(ValueError):
        Compiled(_fn, static_argnames=("nope",))


def test_key_takes_staleness_not_the_cache_version(monkeypatch):
    """raycast_fast_jit and localize_step_jit decide a cache's staleness
    on the caller's grid and pass it as a static argument; the cache goes
    in without its field and version, so a new grid version alone keys no
    new graph."""
    c, (pose, data, mask), _ = _inputs()
    grid = c["grid"]
    _, tparams = _params(MODES["icp"])
    seg = rf.extract_segments(grid)
    newer = dataclasses.replace(grid, tsd=grid.tsd.clone())
    seen = []

    def record(self, *args, **kwargs):
        seen.append(self.key(*args, **kwargs)[0])
        return self.fn(*args, **kwargs)

    monkeypatch.setattr(Compiled, "__call__", record)
    fresh = rf.raycast_fast_jit(grid, tparams.geom, pose, segments=seg)
    stale = rf.raycast_fast_jit(newer, tparams.geom, pose, segments=seg)
    again = rf.raycast_fast_jit(newer, tparams.geom, pose,
                                segments=rf.extract_segments(newer))
    assert int(fresh.n_dropped) == 0 and int(again.n_dropped) == 0
    assert int(stale.n_dropped) == tparams.geom.size
    assert seen[0] != seen[1] and seen[0] == seen[2]
    seen.clear()
    for g in (grid, newer):
        tlocalize.localize_step_jit(g, pose, pose, data, mask, tparams,
                                    segments=seg)
    assert seen[0] != seen[1]


def test_cpu_call_builds_no_graph(no_graphs):
    f = compiled(_fn, static_argnames=("flag",))
    x = torch.arange(4.0)
    assert torch.equal(f(x, scale=2.0), x * 2.0)
    assert f.captures == 0 and f.graphs() == []
    for name in ("_extract_graph", "_render_graph", "_checked_graph"):
        assert getattr(rf, name).graphs() == []
    assert tlocalize.localize_step_jit.compiled.graphs() == []
    assert icp_jit.graphs() == []
    assert match_gauss_newton_jit.graphs() == []
    assert tcompiled.cuda_device([x, torch.Generator()]) is None
