"""The modes GN and AMCL and the differentiable render on the card
(`cuda`-marked: they skip without one; on the card run them with
`python -m pytest --noconftest -m cuda tests/test_torch_modes_cuda.py`).

This file imports torch and numpy only: the card's machine has no JAX.
Asserted:
  * render_ranges' pose and cell gradients on the card equal the CPU
    port's on the same float32 grid within RENDER_TOL of the largest
    magnitude (the card adds the cell cotangent's four taps a beam in no
    fixed order and rounds cos and sin its own way); the forward's hit
    mask is the CPU's but for at most HIT_FLIPS of the beams (a grazing
    beam can flip with the last bit of its direction), which the compared
    weighted sum weighs 0;
  * localize_step_jit in the modes GN and AMCL reads nothing back to the
    host once captured, nor does the eager step in mode GN, which renders
    nothing (torch.cuda.set_sync_debug_mode("error") raises on any sync;
    the eager step in mode AMCL reads the overflow guard's drop count);
  * icp with IcpParams.record_pairs and record_T on, fused and modular, on
    a room pair at 1081 beams, gives what it gives with them off in every
    bit and reads nothing back; its histories have their shapes, the last
    iteration's T is the result's and each recorded mask sums to its pair
    count.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from ohm_tsd_slam_tpu_torch.config import GridConfig, RegMode
from ohm_tsd_slam_tpu_torch.core import se2
from ohm_tsd_slam_tpu_torch.grid import raycast_fast as rf
from ohm_tsd_slam_tpu_torch.grid.push import push
from ohm_tsd_slam_tpu_torch.grid.render import render_ranges
from ohm_tsd_slam_tpu_torch.grid.state import create, from_arrays, to_arrays
from ohm_tsd_slam_tpu_torch.registration.amcl import AmclParams
from ohm_tsd_slam_tpu_torch.registration.gauss_newton import GnParams
from ohm_tsd_slam_tpu_torch.registration.icp import IcpParams, icp
from ohm_tsd_slam_tpu_torch.sensor import polar2d
from ohm_tsd_slam_tpu_torch.slam.localize import (
    LocalizeParams,
    localize_step,
    localize_step_jit,
)
from ohm_tsd_slam_tpu_torch.utils.testing import (
    limit_cpu_threads,
    rect_walls,
    simulate_scan,
)

limit_cpu_threads()

RENDER_TOL = 1e-3
HIT_FLIPS = 0.005
CFG = GridConfig(map_size=8, cellsize=0.04)
GEOM = polar2d.SensorPolar2D(size=361, angular_res=math.radians(0.75),
                             phi_min=math.radians(-135.0), max_range=9.0,
                             min_range=0.01, low_reflectivity_range=1.0)
POSE = (5.12, 5.12, 0.2)
GEOM_1081 = polar2d.SensorPolar2D(size=1081, angular_res=math.radians(0.25),
                                  phi_min=math.radians(-135.0),
                                  max_range=9.0, min_range=0.01,
                                  low_reflectivity_range=1.0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _scan(xyt, geom=GEOM):
    pose = se2.make(*xyt, dtype=torch.float64).numpy()
    return simulate_scan(pose, geom.size, geom.angular_res, geom.phi_min,
                         geom.max_range,
                         segments=rect_walls(1.51, 1.53, 8.47, 8.49),
                         circles=[((7.0, 7.2), 0.5)])


def _room(device, geom=GEOM):
    """A float32 grid of three pushed scans on `device`."""
    g = create(CFG, dtype=torch.float32, device=device)
    for xyt in (POSE, (5.4, 4.9, -0.3), (5.0, 5.3, 0.6)):
        data, mask = polar2d.standard_mask(
            geom, torch.from_numpy(_scan(xyt, geom)).float().to(device))
        g = push(g, geom, se2.make(*xyt, device=device), data, mask)
    return g


def _hit(grid, xyt):
    pose = se2.make(*xyt, device=grid.tsd.device)
    return render_ranges(grid, GEOM, pose)[1].cpu()


def _grads(grid, xyt, w):
    dev = grid.tsd.device
    x = torch.tensor(xyt, dtype=torch.float32, device=dev,
                     requires_grad=True)
    tsd = grid.tsd.clone().requires_grad_(True)
    r, hit, _ = render_ranges(dataclasses.replace(grid, tsd=tsd), GEOM,
                              se2.make(x[0], x[1], x[2], device=dev))
    (w.to(dev) * r).sum().backward()
    return hit.cpu(), x.grad.cpu(), tsd.grad.cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("xyt", [(5.2, 5.05, 0.15), (4.6, 5.6, -1.2)])
def test_render_gradients_on_card_match_cpu(cuda_device, xyt):
    grid = _room(cuda_device)
    cpu = from_arrays(to_arrays(grid), device="cpu")
    w = torch.from_numpy(np.random.default_rng(2).normal(
        size=GEOM.size).astype(np.float32))
    flips = _hit(grid, xyt) != _hit(cpu, xyt)
    assert int(flips.sum()) <= HIT_FLIPS * GEOM.size
    w[flips] = 0.0
    hit, gp, gc = _grads(grid, xyt, w)
    chit, cp, cc = _grads(cpu, xyt, w)
    assert torch.equal(hit != chit, flips) and int(hit.sum()) > 250
    assert float((gp - cp).abs().max()) <= RENDER_TOL * float(
        cp.abs().max())
    assert float((gc - cc).abs().max()) <= RENDER_TOL * float(
        cc.abs().max())
    assert int((gc != 0).sum()) > 500


@pytest.mark.cuda
def test_render_refine_off_is_the_caster_on_card(cuda_device):
    grid = _room(cuda_device)
    seg = rf.extract_segments(grid)
    pose = se2.make(5.2, 5.05, 0.15, device=cuda_device)
    raw, hit, _ = render_ranges(grid, GEOM, pose, refine=False, segments=seg)
    assert torch.equal(raw, rf.raycast_checked(grid, GEOM, pose,
                                               segments=seg).ranges)
    assert int(hit.sum()) > 300


def _step_inputs(device, mode):
    grid = _room(device)
    data, mask = polar2d.standard_mask(
        GEOM, torch.from_numpy(_scan((5.15, 5.1, 0.21))).float().to(device))
    params = LocalizeParams(
        geom=GEOM, icp=IcpParams(iterations=25,
                                 bounds=(0.0, CFG.size_meters, 0.0,
                                         CFG.size_meters)),
        mode=int(mode), gn=GnParams(iterations=30),
        amcl=AmclParams(particles=256, iterations=4))
    return grid, se2.make(*POSE, device=device), data, mask, params


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [RegMode.GN, RegMode.AMCL])
def test_localize_step_reads_nothing_on_card(cuda_device, mode):
    grid, pose, data, mask, params = _step_inputs(cuda_device, mode)
    seg = rf.extract_segments(grid)
    gen = torch.Generator(device=cuda_device)
    args = (grid, pose, pose, data, mask, params)
    gen.manual_seed(3)
    localize_step_jit(*args, generator=gen, segments=seg)   # the capture
    gen.manual_seed(3)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = localize_step_jit(*args, generator=gen, segments=seg)
        if mode == RegMode.GN:
            localize_step(*args, generator=gen, segments=seg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert not bool(res.reg_error)
    assert math.hypot(float(res.pose[0, 2]) - 5.15,
                      float(res.pose[1, 2]) - 5.1) < 2.5 * CFG.cellsize
    if mode == RegMode.GN:
        assert int(res.rays_dropped) == 0


def _bits(t):
    return t.contiguous().cpu().numpy().tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "modular"])
def test_icp_histories_leave_the_result_alone_on_card(cuda_device, fused):
    grid = _room(cuda_device, GEOM_1081)
    pose = se2.make(*POSE, device=cuda_device)
    model = rf.raycast_fast(grid, GEOM_1081, pose)
    data, mask = polar2d.standard_mask(GEOM_1081, torch.from_numpy(
        _scan((5.15, 5.1, 0.21), GEOM_1081)).float().to(cuda_device))
    scene, smask = polar2d.data_to_cartesian(GEOM_1081, data, mask)
    params = IcpParams(iterations=25, bounds=(0.0, CFG.size_meters, 0.0,
                                              CFG.size_meters), fused=fused)
    args = (model.coords, model.mask, scene, smask)
    kwargs = dict(sensor_pose=pose, model_normals=model.normals)
    off = icp(*args, params, **kwargs)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        on = icp(*args, dataclasses.replace(params, record_pairs=True,
                                            record_T=True), **kwargs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for f in ("T", "rms", "pairs", "iterations", "state", "rms_history",
              "pair_history"):
        assert _bits(getattr(off, f)) == _bits(getattr(on, f)), f
    n = int(on.iterations)
    assert 0 < n <= 25 and int(on.pairs) > 500
    assert on.pair_idx_history.shape == on.pair_mask_history.shape == (
        25, GEOM_1081.size)
    assert on.T_history.shape == (25, 3, 3)
    assert _bits(on.T_history[n - 1]) == _bits(on.T)
    assert torch.equal(on.pair_mask_history.sum(1), on.pair_history)
