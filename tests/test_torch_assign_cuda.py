"""ICP's pair assignment kernel (csrc/assign_pairs.cu) on the card
(`cuda`-marked: they skip without one; on the card run them with
`python -m pytest --noconftest -m cuda tests/test_torch_assign_cuda.py`).

This file imports torch and numpy only: the card's machine has no JAX.
Asserted:
  * ops/assign_pairs_cuda.py::assign_pairs equals its plain twin
    registration/nn.py::assign_pairs_plain run on the card in every bit of
    all four outputs (idx, dist2, pair_mask, paired), in float32 and
    float64, with no gate, a gate tensor and a number, the reciprocal rule
    on and off, payloads of 2 and 4 columns: on random clouds, on clouds
    on a coarse lattice (many equal distances), with S != M, with
    duplicate model points and scene points equidistant from one model
    point, with every model or every scene point masked, with NaN
    coordinates under a true mask, with more model points than one staged
    tile holds, and on two real 1081-beam scans of utils/testing.py's room;
  * icp_jit equals eager icp in every bit (T, rms, pairs, iterations,
    state and the histories) for both estimators;
  * a capture of icp_jit calls the wrapper once an iteration in its
    warm-up and once in its capture, a replay not at all;
  * a torch.profiler trace of one localize_step_jit replay holds the
    kernel once an ICP iteration, and the scatter kernels that the twin's
    reciprocal rule launches (two an iteration) are gone from it.
"""

import importlib
import math
import os
import sys
import time

import numpy as np
import pytest
import torch

from ohm_tsd_slam_tpu_torch.config import GridConfig
from ohm_tsd_slam_tpu_torch.core import se2
from ohm_tsd_slam_tpu_torch.grid import raycast_fast as rf
from ohm_tsd_slam_tpu_torch.grid.push import push
from ohm_tsd_slam_tpu_torch.grid.state import create
from ohm_tsd_slam_tpu_torch.ops.assign_pairs_cuda import assign_pairs
from ohm_tsd_slam_tpu_torch.registration.icp import IcpParams, icp, icp_jit
from ohm_tsd_slam_tpu_torch.registration.nn import assign_pairs_plain
from ohm_tsd_slam_tpu_torch.sensor import polar2d
from ohm_tsd_slam_tpu_torch.slam.localize import (
    LocalizeParams,
    localize_step,
    localize_step_jit,
)
from ohm_tsd_slam_tpu_torch.utils.testing import (
    limit_cpu_threads,
    rect_walls,
    scan_ranges,
    simulate_scan,
)

# the card's run passes --noconftest: the helpers' file by its folder
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_card as tc  # noqa: E402

limit_cpu_threads()

# the module (the package's `icp` is the function)
icp_mod = importlib.import_module("ohm_tsd_slam_tpu_torch.registration.icp")
CFG = GridConfig(map_size=8, cellsize=0.04)
BEAMS, RES, PHI0, RMAX = 361, math.radians(0.75), math.radians(-135), 9.0
GEOM = polar2d.SensorPolar2D(size=BEAMS, angular_res=RES, phi_min=PHI0,
                             max_range=RMAX, min_range=0.01,
                             low_reflectivity_range=1.0)
ITERATIONS = 25
DTYPES = [torch.float32, torch.float64]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _same(a, b) -> bool:
    """Equal in every bit (NaN included), or both None."""
    if a is None or b is None:
        return a is None and b is None
    return (a.shape == b.shape and a.dtype == b.dtype
            and a.detach().cpu().numpy().tobytes()
            == b.detach().cpu().numpy().tobytes())


def _check(dev, dtype, model, mmask, scene, smask, payload, gate=None,
           reciprocal=True):
    """The kernel against the twin on the card; returns the kernel's
    outputs on the host."""
    def on(a, t=dtype):
        a = torch.as_tensor(np.asarray(a))
        return a.to(dev, t if a.is_floating_point() else a.dtype)

    args = (on(model), on(mmask), on(scene), on(smask), on(payload))
    if isinstance(gate, float) and gate == gate:
        gates = [gate, torch.tensor(gate, dtype=dtype, device=dev)]
    else:
        gates = [gate]
    for g in gates:
        got = assign_pairs(*args, thresh2=g, use_reciprocal=reciprocal)
        want = assign_pairs_plain(*args, thresh2=g,
                                  use_reciprocal=reciprocal)
        for name, x, y in zip(("idx", "dist2", "pair_mask", "paired"), got,
                              want):
            assert _same(x, y), (name, g, reciprocal)
    return [t.cpu() for t in got]


def _clouds(rng, S, M, lattice=False):
    model = rng.uniform(-5.0, 5.0, (M, 2))
    n = min(S, M) * 3 // 4
    scene = np.concatenate([model[:n] + rng.normal(0, 0.05, (n, 2)),
                            rng.uniform(-5.0, 5.0, (S - n, 2))])
    if lattice:           # coordinates on a 1/8 m lattice: equal distances
        model, scene = np.round(model * 8) / 8, np.round(scene * 8) / 8
    mmask = rng.random(M) < 0.9
    smask = rng.random(S) < 0.9
    return model, mmask, scene, smask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("K", [2, 4])
@pytest.mark.parametrize("reciprocal", [True, False])
@pytest.mark.parametrize("lattice", [False, True])
def test_kernel_equals_twin_on_random_clouds(cuda_device, dtype, K,
                                             reciprocal, lattice):
    rng = np.random.default_rng(7 + K + 2 * lattice)
    model, mmask, scene, smask = _clouds(rng, 700, 700, lattice)
    payload = np.concatenate([model, rng.normal(size=(700, K - 2))], 1)
    for gate in (None, 0.04):
        out = _check(cuda_device, dtype, model, mmask, scene, smask,
                     payload, gate, reciprocal)
        assert int(out[2].sum()) > 100


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S,M", [(1081, 400), (257, 1081), (33, 5),
                                 (1, 1), (300, 5000)])
def test_kernel_equals_twin_when_s_and_m_differ(cuda_device, dtype, S, M):
    # 5000 model points are more than one staged tile (2048 in float32,
    # 1024 in float64)
    rng = np.random.default_rng(S + M)
    model, mmask, scene, smask = _clouds(rng, S, M)
    for reciprocal in (True, False):
        _check(cuda_device, dtype, model, mmask, scene, smask,
               np.concatenate([model, -model], 1), 0.5, reciprocal)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_ties_take_the_first_index(cuda_device, dtype):
    # model points 0, 3 and 6 coincide; scene points 0 and 1 lie at equal
    # distances either side of model point 3, as do 2 and 3 of model point
    # 5, scene 4 sits on model point 6 (equal to 0 and 3)
    model = np.array([[1.0, 1.0], [2.0, 0.0], [0.0, 2.0], [1.0, 1.0],
                      [3.0, 3.0], [-2.0, 1.0], [1.0, 1.0]])
    scene = np.array([[1.25, 1.0], [0.75, 1.0], [-2.0, 1.5], [-2.0, 0.5],
                      [1.0, 1.0], [3.0, 3.0]])
    payload = np.concatenate([model, model[:, ::-1]], 1)
    mmask = np.ones(7, bool)
    smask = np.ones(6, bool)
    for reciprocal in (False, True):
        idx, _, pmask, _ = _check(cuda_device, dtype, model, mmask, scene,
                                  smask, payload, 1.0, reciprocal)
        assert idx.tolist() == [0, 0, 5, 5, 0, 4]
    # the reciprocal rule: column 0 goes to scene 4 (distance 0), column 5
    # to scene 2 (the lesser of two equal distances' scene indices)
    assert pmask.tolist() == [False, False, True, False, True, True]
    mmask[0] = False            # the first of the three now invalid
    idx = _check(cuda_device, dtype, model, mmask, scene, smask, payload)[0]
    assert idx.tolist() == [3, 3, 5, 5, 3, 4]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_masks_and_nan(cuda_device, dtype):
    rng = np.random.default_rng(11)
    model, mmask, scene, smask = _clouds(rng, 200, 150)
    payload = np.concatenate([model, model], 1)
    for gate in (None, 0.3):
        for reciprocal in (True, False):
            # every model point masked: each row +inf, idx 0, no pair
            idx, d2, pm, paired = _check(
                cuda_device, dtype, model, np.zeros(150, bool), scene,
                smask, payload, gate, reciprocal)
            assert not pm.any() and (idx == 0).all()
            assert torch.isinf(d2).all() and not paired.any()
            # every scene point masked
            idx, d2, pm, _ = _check(cuda_device, dtype, model, mmask, scene,
                                    np.zeros(200, bool), payload, gate,
                                    reciprocal)
            assert not pm.any() and torch.isinf(d2).all()
    # NaN coordinates under a true mask: a NaN scene row is NaN in every
    # valid column (idx M - 1 after the twin's clamp); a NaN model point
    # makes every row NaN; NaN under a false mask changes nothing
    bad_scene = scene.copy()
    bad_scene[[3, 17], 0] = np.nan
    smask[[3, 17]] = True
    for reciprocal in (True, False):
        idx, d2, pm, _ = _check(cuda_device, dtype, model, mmask, bad_scene,
                                smask, payload, 0.3, reciprocal)
        assert torch.isnan(d2[[3, 17]]).all() and (idx[[3, 17]] == 149).all()
        assert not pm[[3, 17]].any() and pm.any()
        bad_model = model.copy()
        bad_model[40, 1] = np.nan
        masked = mmask.copy()
        masked[40] = False
        _check(cuda_device, dtype, bad_model, masked, scene, smask, payload,
               0.3, reciprocal)
        masked[40] = True
        _, d2, pm, _ = _check(cuda_device, dtype, bad_model, masked, scene,
                              smask, payload, 0.3, reciprocal)
        assert not pm.any()
    # a NaN gate selects nothing
    _check(cuda_device, dtype, model, mmask, scene, smask, payload,
           float("nan"))


def _room_scans(dev, dtype):
    """Two 1081-beam scans of utils/testing.py's room 2 cm and half a
    degree apart, as ICP's model and scene (each in its own sensor
    frame)."""
    geom = tc.geom_1081()
    out = []
    for xyt in ((8.0, 12.0, 0.3), (8.02, 12.0, 0.3 + math.radians(0.5))):
        ranges = torch.from_numpy(scan_ranges(xyt, 30.0))
        data, mask = polar2d.standard_mask(geom, ranges.to(dev, dtype))
        out += list(polar2d.data_to_cartesian(geom, data, mask))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_equals_twin_on_room_scans(cuda_device, dtype):
    model, mmask, scene, smask = _room_scans(cuda_device, dtype)
    assert model.shape == scene.shape == (1081, 2)
    normals = torch.stack([-model[:, 1], model[:, 0]], 1)
    for K, payload in ((2, model), (4, torch.cat([model, normals], 1))):
        for gate in (None, 0.25 ** 2, 0.01):
            for reciprocal in (True, False):
                out = _check(cuda_device, dtype, model.cpu(), mmask.cpu(),
                             scene.cpu(), smask.cpu(), payload.cpu(), gate,
                             reciprocal)
                assert out[3].shape == (1081, K)
                assert int(out[2].sum()) > 200


def _room(device):
    g = create(CFG, dtype=torch.float32, device=device)
    for xyt in ((5.12, 5.12, 0.2), (5.4, 4.9, -0.3), (5.0, 5.3, 0.6)):
        data, mask = polar2d.standard_mask(GEOM, _ranges(xyt, device))
        g = push(g, GEOM, se2.make(*xyt, device=device), data, mask)
    return g


def _ranges(xyt, device):
    pose = se2.make(*xyt, dtype=torch.float64).numpy()
    r = simulate_scan(pose, GEOM.size, GEOM.angular_res, GEOM.phi_min,
                      GEOM.max_range,
                      segments=rect_walls(1.51, 1.53, 8.47, 8.49),
                      circles=[((7.0, 7.2), 0.5)])
    return torch.from_numpy(r).float().to(device)


def _icp_inputs(device):
    grid = _room(device)
    pose = se2.make(5.12, 5.12, 0.2, device=device)
    model = rf.raycast_fast(grid, GEOM, pose)
    data, mask = polar2d.standard_mask(GEOM, _ranges((5.15, 5.1, 0.21),
                                                     device))
    scene, smask = polar2d.data_to_cartesian(GEOM, data, mask)
    return model, scene, smask, pose


@pytest.mark.cuda
@pytest.mark.parametrize("estimator", ["closed_form", "point_to_line"])
def test_icp_jit_equals_eager_icp(cuda_device, estimator):
    model, scene, smask, pose = _icp_inputs(cuda_device)
    p = IcpParams(iterations=ITERATIONS, dist_max=0.5, dist_min=0.05,
                  estimator=estimator, record_pairs=True, record_T=True)
    args = (model.coords, model.mask, scene, smask, p)
    kw = dict(sensor_pose=pose, model_normals=model.normals)
    got = icp_jit(*args, **kw)
    want = icp(*args, **kw)
    for f in got._fields:
        assert _same(getattr(got, f), getattr(want, f)), f
    assert int(want.pairs) > 100
    # the eager loop on the twin: the same bits
    twin = icp_mod.assign_pairs_fused
    try:
        icp_mod.assign_pairs_fused = assign_pairs_plain
        plain = icp(*args, **kw)
    finally:
        icp_mod.assign_pairs_fused = twin
    for f in got._fields:
        assert _same(getattr(plain, f), getattr(want, f)), f


@pytest.mark.cuda
def test_a_capture_calls_the_wrapper_and_a_replay_does_not(cuda_device):
    model, scene, smask, pose = _icp_inputs(cuda_device)
    p = IcpParams(iterations=ITERATIONS)
    args = (model.coords, model.mask, scene, smask, p)
    icp_jit.clear_cache()
    n0 = assign_pairs.launches
    first = icp_jit(*args, sensor_pose=pose)
    # the warm-up and the capture each run the loop once
    assert assign_pairs.launches == n0 + 2 * ITERATIONS
    again = icp_jit(*args, sensor_pose=pose)
    assert assign_pairs.launches == n0 + 2 * ITERATIONS
    assert all(_same(a, b) for a, b in zip(first, again))


def _replay_kernels(run) -> dict:
    """Device kernels of one run() (a replay) from a torch.profiler trace,
    by name; None where the trace shows no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)      # keep the work off the session's edges
        run()
        torch.cuda.synchronize()
        time.sleep(0.05)
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA]
    if not names:
        return None
    return {"rows": sum("assign_rows_kernel" in n for n in names),
            "pairs": sum("assign_pairs_kernel" in n for n in names),
            "scatter": sum("scatter_gather" in n for n in names)}


@pytest.mark.cuda
def test_a_step_replay_runs_the_kernel_once_an_iteration(cuda_device):
    grid = _room(cuda_device)
    seg = rf.extract_segments_jit(grid)
    params = LocalizeParams(geom=GEOM, icp=IcpParams(iterations=ITERATIONS))
    pose = se2.make(5.12, 5.12, 0.2, device=cuda_device)
    data, mask = polar2d.standard_mask(GEOM, _ranges((5.15, 5.1, 0.21),
                                                     cuda_device))

    def step():
        return localize_step_jit(grid, pose, pose, data, mask, params,
                                 segments=seg)

    twin = icp_mod.assign_pairs_fused
    found = {}
    try:
        for name, fn in (("kernel", twin), ("twin", assign_pairs_plain)):
            icp_mod.assign_pairs_fused = fn
            localize_step_jit.compiled.clear_cache()
            want = localize_step(grid, pose, pose, data, mask, params,
                                 segments=seg)
            assert all(_same(x, y) for x, y in zip(step(), want))
            found[name] = _replay_kernels(step)
    finally:
        icp_mod.assign_pairs_fused = twin
        localize_step_jit.compiled.clear_cache()
    if found["kernel"] is None or found["twin"] is None:
        pytest.skip("the profiler shows no device activity on this card")
    assert found["kernel"]["rows"] == found["kernel"]["pairs"] == ITERATIONS
    assert found["twin"]["rows"] == found["twin"]["pairs"] == 0
    # the twin's reciprocal rule: two scatter_reduce launches an iteration
    assert found["twin"]["scatter"] - found["kernel"]["scatter"] == \
        2 * ITERATIONS, found
