"""The one-card multi-robot step on a segment overflow, on the CPU in
float64, against the JAX package's (mesh=None): the JAX step renders every
robot again with the exact march under one lax.cond when any robot's fast
render overflowed, and so must the port's guard (utils/compiled.py::when,
once for the batch).  The case is tests/test_torch_parallel.py's (two of
its robots), with both packages' MAX_SEGMENTS below the grid's 283
segments; the tolerances are test_step_matches_jax's there.
"""

import numpy as np

from ohm_tsd_slam_tpu.grid import raycast_fast as jrf
from ohm_tsd_slam_tpu.parallel.sharded import (
    multi_robot_slam_step as j_step,
)
from ohm_tsd_slam_tpu_torch.grid import raycast_fast as rf
from ohm_tsd_slam_tpu_torch.parallel import multi_robot_slam_step
from ohm_tsd_slam_tpu_torch.utils.testing import limit_cpu_threads
from test_torch_parallel import FIELDS, MODES, _case, _params

limit_cpu_threads()

TOL = 1e-9
OVERFLOW = 128               # a capacity below the case grid's segments


def test_multi_robot_step_guards_an_overflow_as_jax(monkeypatch):
    """A segment capacity below the grid's in both packages: every robot's
    model comes from the exact march, rays_dropped is the fast sum."""
    c = _case()
    jparams, tparams = _params(MODES["icp"])
    monkeypatch.setattr(rf, "MAX_SEGMENTS", OVERFLOW)
    monkeypatch.setattr(jrf, "MAX_SEGMENTS", OVERFLOW)
    R = 2
    ref = j_step(c["jgrid"], c["jposes"][:R], c["jdata"][:R],
                 c["jmask"][:R], jparams)
    got = multi_robot_slam_step(c["grid"], c["poses"][:R], c["data"][:R],
                                c["mask"][:R], tparams)
    assert int(got.rays_dropped) == int(ref.rays_dropped) > 0
    np.testing.assert_array_equal(got.reg_error.numpy(),
                                  np.asarray(ref.reg_error))
    assert not got.reg_error.all()
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(ref.poses),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.pose_grad.numpy(),
                               np.asarray(ref.pose_grad), rtol=1e-6,
                               atol=TOL)
    np.testing.assert_allclose(got.rms.numpy(), np.asarray(ref.rms),
                               rtol=1e-6, atol=1e-12)
    for f in FIELDS:
        a, b = getattr(got.grid, f).numpy(), np.asarray(getattr(ref.grid, f))
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=f)
        ok = ~np.isnan(b)
        np.testing.assert_allclose(a[ok], b[ok], rtol=TOL, atol=1e-12,
                                   err_msg=f)
