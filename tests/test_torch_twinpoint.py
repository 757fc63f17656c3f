"""The port's two-point matcher (registration/twinpoint.py) against the JAX
package's, in float64 on the CPU.

Both packages get the same draws through `TwinInject` (a control set and
trial rank pairs made with numpy from a seed, within the ranges the
matcher draws from); the compiled reference's rows are held in
tests/test_torch_ransac_golden.py.  Clouds are simulated scans of the
analytic room with 3 mm of numpy noise.  Tolerances: indices, masks and
counts equal, errors and the winning transform within 1e-9."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ohm_tsd_slam_tpu.registration import ransac as jr
from ohm_tsd_slam_tpu.registration import twinpoint as jtp
from ohm_tsd_slam_tpu_torch.core import se2
from ohm_tsd_slam_tpu_torch.registration import ransac as tr
from ohm_tsd_slam_tpu_torch.registration import twinpoint as ttp
from ohm_tsd_slam_tpu_torch.sensor import polar2d as tpolar
from ohm_tsd_slam_tpu_torch.utils.testing import (
    limit_cpu_threads,
    rect_walls,
    simulate_scan,
)

limit_cpu_threads()

F64 = torch.float64
TOL = 1e-9
GEOM = dict(size=361, angular_res=math.radians(0.75),
            phi_min=math.radians(-135.0), max_range=15.0)
PARAMS = dict(trials=30, size_control_set=60,
              resolution=GEOM["angular_res"])
POSE_M = (5.0, 5.0, 0.3)
POSE_S = (5.1, 4.85, 0.38)


def _cloud(xyt, rng):
    geom = tpolar.SensorPolar2D(**GEOM)
    r = simulate_scan(se2.make(*xyt, dtype=F64).numpy(), GEOM["size"],
                      GEOM["angular_res"], GEOM["phi_min"],
                      GEOM["max_range"], segments=rect_walls(1.0, 1.0, 9.0,
                                                             9.0))
    r = r + rng.normal(0.0, 0.003, r.shape)
    data, mask = tpolar.standard_mask(geom, torch.from_numpy(r))
    return tpolar.data_to_cartesian(geom, data, mask)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    M, maskM = _cloud(POSE_M, rng)
    S, maskS = _cloud(POSE_S, rng)
    maskM[40:52] = False         # a gap of invalid beams in each cloud
    maskS[200:209] = False
    return dict(M=M, maskM=maskM, S=S, maskS=maskS)


def _inject(case, seed, params):
    """Control indices and rank pairs drawn with numpy as the matcher
    draws them (TwinPointMatching.cpp:184-191), for both packages."""
    rng = np.random.default_rng(seed)
    res_deg = math.degrees(params.resolution)
    min_d, max_d = max(1, int(3.0 / res_deg)), max(2, int(10.0 / res_deg))
    n_valid = int(case["maskM"].sum())
    rank1 = rng.integers(0, n_valid - 1 - min_d, params.trials)
    remaining = np.minimum(n_valid - rank1 - 1, max_d)
    rank2 = rank1 + min_d + rng.integers(0, 1 << 30, params.trials) % (
        np.maximum(remaining - min_d, 1))
    valid_s = np.nonzero(case["maskS"].numpy())[0]
    ctrl = rng.choice(valid_s, params.size_control_set, replace=False)
    arrays = (ctrl, np.ones(len(ctrl), bool), rank1, rank2,
              rank2 < n_valid)
    return (ttp.TwinInject(*(torch.from_numpy(np.asarray(a))
                             for a in arrays)),
            jtp.TwinInject(*(jnp.asarray(a) for a in arrays)))


def _clouds(case, to=lambda t: t):
    return tuple(to(case[k]) for k in ("M", "maskM", "S", "maskS"))


def _j(t):
    return jnp.asarray(t.numpy())


def test_intra_distance_lut_matches_jax(case):
    got, gidx = ttp._intra_distance_lut(case["S"], case["maskS"], 4, 13)
    want, widx = jtp._intra_distance_lut(_j(case["S"]), _j(case["maskS"]),
                                         4, 13)
    np.testing.assert_array_equal(gidx.numpy(), np.asarray(widx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("seed", [1, 2])
def test_match_twinpoint_matches_jax(case, seed):
    """The same draws: every candidate's pair, gates and scores and the
    winning transform as JAX's."""
    tp = tr.RansacParams(**PARAMS, chunk=96)
    jp = jr.RansacParams(**PARAMS)
    tinj, jinj = _inject(case, seed, tp)
    T, aux = ttp.match_twinpoint(None, *_clouds(case), tp, inject=tinj,
                                 return_scores=True)
    jT, jaux = jtp.match_twinpoint(jax.random.PRNGKey(0),
                                   *_clouds(case, _j), jp, inject=jinj,
                                   return_scores=True)
    for k in ("idx1", "idx2", "i_s", "i2_best", "pair_ok", "max_cnt"):
        np.testing.assert_array_equal(aux[k].numpy(), np.asarray(jaux[k]),
                                      err_msg=k)
    assert int(aux["pair_ok"].sum()) > 50
    good = aux["pair_ok"].reshape(-1).numpy()
    for k in ("rate_q", "cnt"):
        np.testing.assert_array_equal(aux[k].numpy()[good],
                                      np.asarray(jaux[k])[good], err_msg=k)
    for k in ("phi", "t", "err"):
        np.testing.assert_allclose(aux[k].numpy(), np.asarray(jaux[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)
    np.testing.assert_allclose(T.numpy(), np.asarray(jT), rtol=TOL,
                               atol=TOL)
    assert not np.allclose(T.numpy(), np.eye(3))


def test_own_draws_recover_transform(case):
    """The port's own draws (tests/test_ransac.py::TestTwinPoint's bounds)
    and a function of the generator's seed."""
    p = tr.RansacParams(trials=60, size_control_set=60,
                        resolution=GEOM["angular_res"], chunk=256)
    T = ttp.match_twinpoint(torch.Generator().manual_seed(7),
                            *_clouds(case), p)
    again = ttp.match_twinpoint(torch.Generator().manual_seed(7),
                                *_clouds(case), p)
    assert torch.equal(T, again)
    T_true = (se2.invert(se2.make(*POSE_M, dtype=F64))
              @ se2.make(*POSE_S, dtype=F64)).numpy()
    T = T.numpy()
    ang = math.atan2(T[1, 0], T[0, 0])
    assert abs(ang - math.atan2(T_true[1, 0], T_true[0, 0])) < 0.02
    assert math.hypot(T[0, 2] - T_true[0, 2], T[1, 2] - T_true[1, 2]) < 0.05


def test_too_few_points_identity(case):
    few = torch.zeros_like(case["maskM"])
    few[:ttp.MIN_VALID_POINTS - 1] = True
    p = tr.RansacParams(trials=20, size_control_set=40,
                        resolution=GEOM["angular_res"])
    T = ttp.match_twinpoint(torch.Generator().manual_seed(0), case["M"],
                            few, case["S"], case["maskS"], p)
    assert torch.equal(T, torch.eye(3, dtype=F64))
    with pytest.raises(ValueError, match="Generator"):
        ttp.match_twinpoint(None, *_clouds(case), p)
