"""The port's ICP (ohm_tsd_slam_tpu_torch/registration/icp.py) against the
COMPILED C++ REFERENCE, per iteration.

golden/reg_harness.cpp runs the reference's Icp engine on six scripted
model/scene cases and dumps the accumulated transform, the RMS and the
pair count of every iteration (tests/test_reference_parity_reg.py holds
the JAX package to them).  Here the port's loop, fused and modular, runs
the same cases in float64 on the CPU with IcpParams.record_T and must
reproduce every iteration: iteration and pair counts equal, RMS and T per
iteration and the final T at 1e-9.  The pair assignments it records with
IcpParams.record_pairs must equal the JAX package's in every entry, and
with both flags off the loop gives what it gives with them on, every
bit.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ohm_tsd_slam_tpu.registration.icp import IcpParams as JIcpParams
from ohm_tsd_slam_tpu.registration.icp import icp as jicp
from ohm_tsd_slam_tpu_torch.registration.icp import IcpParams, icp
from ohm_tsd_slam_tpu_torch.utils.testing import limit_cpu_threads

from golden_io import GOLDEN_DIR, load_golden

limit_cpu_threads()

REG_BIN = os.path.join(GOLDEN_DIR, "data", "reg.bin")
REG_NPZ = os.path.join(GOLDEN_DIR, "data", "reg_inputs.npz")

pytestmark = pytest.mark.skipif(
    not os.path.exists(REG_BIN),
    reason="golden registration data not generated (make -C golden)")

CASES = ["cf_full", "cf_seeded", "cf_distonly", "cf_nofilter",
         "p2l_full", "p2l_partial"]
FUSED = pytest.mark.parametrize("fused", [True, False],
                                ids=["fused", "modular"])


@pytest.fixture(scope="module")
def golden():
    return load_golden(REG_BIN)


@pytest.fixture(scope="module")
def inputs():
    return np.load(REG_NPZ)


def _params(inputs, name, fused, **flags):
    """The case's IcpParams; dist_iterations straight from the spec (the
    harness sets the filter's count itself, no unsigned wrap)."""
    (iters, maxrms, conv, use_dist, dist_max, dist_min, dist_iters,
     use_rec, use_oob) = inputs[f"{name}.spec"]
    return IcpParams(
        iterations=int(iters), max_rms=float(maxrms),
        convergence_count=int(conv),
        dist_min=float(dist_min), dist_max=float(dist_max),
        dist_iterations=int(dist_iters),
        use_distance_filter=bool(int(use_dist)),
        use_reciprocal_filter=bool(int(use_rec)),
        bounds=tuple(float(b) for b in inputs["bounds"]) if int(use_oob)
        else None,
        estimator=("point_to_line" if name.startswith("p2l")
                   else "closed_form"),
        fused=fused, **flags)


def _arrays(inputs, name):
    return {k: inputs[f"{name}.{k}"]
            for k in ("model", "normals", "scene", "tinit", "pose")}


def _run(inputs, name, params):
    a = {k: torch.as_tensor(v, dtype=torch.float64)
         for k, v in _arrays(inputs, name).items()}
    return icp(a["model"], torch.ones(a["model"].shape[0], dtype=torch.bool),
               a["scene"], torch.ones(a["scene"].shape[0], dtype=torch.bool),
               params, T_init=a["tinit"], sensor_pose=a["pose"],
               model_normals=a["normals"])


@FUSED
@pytest.mark.parametrize("name", CASES)
def test_icp_iteration_parity(golden, inputs, name, fused):
    """tests/test_reference_parity_reg.py:86-113 for the port: per
    iteration T / RMS / pair count against the compiled reference's loop
    at 1e-9."""
    res = _run(inputs, name, _params(inputs, name, fused, record_T=True))
    ref_T = np.asarray(golden[f"{name}.T_hist"])
    n = int(res.iterations)
    assert n == int(golden[f"{name}.meta"][0]), (name, n)
    np.testing.assert_array_equal(res.pair_history.numpy()[:n],
                                  golden[f"{name}.pair_hist"],
                                  err_msg=f"{name}: pair counts")
    np.testing.assert_allclose(res.rms_history.numpy()[:n],
                               golden[f"{name}.rms_hist"], rtol=0,
                               atol=1e-9, err_msg=f"{name}: rms trajectory")
    np.testing.assert_allclose(res.T_history.numpy()[:n].reshape(n, 9),
                               ref_T.reshape(n, 9), rtol=0, atol=1e-9,
                               err_msg=f"{name}: per-iteration T")
    np.testing.assert_allclose(res.T.numpy(), golden[f"{name}.T_final"],
                               rtol=0, atol=1e-9, err_msg=f"{name}: final T")


@FUSED
@pytest.mark.parametrize("name", CASES)
def test_pair_history_matches_jax(inputs, name, fused):
    """The recorded pair assignments (model index of every scene point,
    the active mask frozen at the exit) equal the JAX package's record on
    the same case in every entry, and the T history the JAX package's at
    1e-9."""
    tp = _params(inputs, name, fused, record_pairs=True, record_T=True)
    t = _run(inputs, name, tp)
    a = {k: jnp.asarray(v, jnp.float64)
         for k, v in _arrays(inputs, name).items()}
    j = jicp(a["model"], jnp.ones(a["model"].shape[0], bool), a["scene"],
             jnp.ones(a["scene"].shape[0], bool),
             JIcpParams(**dataclasses.asdict(tp)), T_init=a["tinit"],
             sensor_pose=a["pose"], model_normals=a["normals"])
    S = a["scene"].shape[0]
    assert t.pair_idx_history.shape == (tp.iterations, S)
    assert t.pair_idx_history.dtype == torch.int32
    assert t.pair_mask_history.dtype == torch.bool
    np.testing.assert_array_equal(t.pair_idx_history.numpy(),
                                  np.asarray(j.pair_idx_history))
    np.testing.assert_array_equal(t.pair_mask_history.numpy(),
                                  np.asarray(j.pair_mask_history))
    np.testing.assert_allclose(t.T_history.numpy(), np.asarray(j.T_history),
                               rtol=0, atol=1e-9)
    # the active mask sums to the pair count; nothing after the exit
    np.testing.assert_array_equal(t.pair_mask_history.sum(1).numpy(),
                                  t.pair_history.numpy())


@FUSED
@pytest.mark.parametrize("name", CASES)
def test_flags_leave_the_result_alone(inputs, name, fused):
    """With both flags off the loop returns no history and the same T,
    rms, pairs, iterations, state and per-iteration rms and pair counts,
    every bit, as with both on; T_history ends, frozen, at the final T."""
    off = _run(inputs, name, _params(inputs, name, fused))
    on = _run(inputs, name, _params(inputs, name, fused, record_pairs=True,
                                    record_T=True))
    assert off.pair_idx_history is None and off.pair_mask_history is None
    assert off.T_history is None
    for f in ("T", "rms", "pairs", "iterations", "state", "rms_history",
              "pair_history"):
        torch.testing.assert_close(getattr(on, f), getattr(off, f), rtol=0,
                                   atol=0, equal_nan=True, msg=f)
    n = int(on.iterations)
    assert torch.equal(on.T_history[n - 1], on.T)
    assert torch.equal(on.T_history[-1], on.T)
