"""The last compiled entry points and the overflow guard on the card
(`cuda`-marked: they skip without one; on the card run them with
`python -m pytest --noconftest -m cuda tests/test_torch_compiled_entry_cuda.py`).

This file imports torch and numpy only: the card's machine has no JAX.
Asserted, on float32 rooms (tests/test_torch_compiled_cuda.py's):
  * utils/compiled.py::when in a graph: one graph serves both branches,
    each replay equal to the eager call;
  * raycast_checked_jit and localize_step_jit on segment caches of one
    capacity, one grid under it and one over it: one graph each, every
    replay equal in every bit to the eager call (the step: to the eager
    step with the exact march where the cache overflows);
  * raycast_jit, push_jit, push_tree_jit, occupancy_grid_jit and
    grid_to_color_image_jit: each replay equal to the eager call in every
    bit, push_tree_jit's also to push_jit's;
  * render_ranges_jit: ranges, hits and the gradients into the pose and
    the cells of two replays of the forward and backward graphs equal to
    eager autograd's in every bit, with the fast caster and the exact
    march;
  * make_sharded_step in a world of one NCCL rank: the step is compiled
    and each replay equals multi_robot_slam_step with the mesh in every
    bit.
"""

import dataclasses
import os
import socket
import sys

import pytest
import torch

from ohm_tsd_slam_tpu_torch.core import se2
from ohm_tsd_slam_tpu_torch.grid import raycast_fast as rf
from ohm_tsd_slam_tpu_torch.grid.axis_aligned import (
    occupancy_grid,
    occupancy_grid_jit,
)
from ohm_tsd_slam_tpu_torch.grid.color import (
    grid_to_color_image,
    grid_to_color_image_jit,
)
from ohm_tsd_slam_tpu_torch.grid.push import (
    push_jit,
    push_tree,
    push_tree_jit,
)
from ohm_tsd_slam_tpu_torch.grid.raycast import raycast, raycast_jit
from ohm_tsd_slam_tpu_torch.grid.render import (
    render_ranges,
    render_ranges_jit,
)
from ohm_tsd_slam_tpu_torch.grid.state import create
from ohm_tsd_slam_tpu_torch.ops.push_cuda import push_cuda
from ohm_tsd_slam_tpu_torch.registration.icp import IcpParams
from ohm_tsd_slam_tpu_torch.slam.localize import (
    LocalizeParams,
    localize_step,
    localize_step_jit,
)
from ohm_tsd_slam_tpu_torch.utils.compiled import compiled, when
from ohm_tsd_slam_tpu_torch.utils.testing import limit_cpu_threads

# the card's run passes --noconftest: the helpers' file by its folder
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_compiled_cuda import (  # noqa: E402
    CFG,
    GEOM,
    _room,
    _same,
    _scene,
    cuda_device,  # noqa: F401
)

limit_cpu_threads()

FIELDS = ("tsd", "weight", "tile_init", "tile_initw")
POSES = [(5.12 + 0.05 * k, 5.12 - 0.03 * k, 0.2 - 0.1 * k) for k in range(4)]


def _grids(device):
    """A grid of one scan with half its beams masked, and the room of
    three scans: fewer and more segments."""
    xyt = POSES[0]
    data, mask = _scene(device, xyt)
    mask = mask.clone()
    mask[GEOM.size // 2:] = False
    lo = push_cuda(create(CFG, dtype=torch.float32, device=device), GEOM,
                   se2.make(*xyt, device=device), data, mask)
    return lo, _room(device)


def _capacity(lo, hi) -> int:
    """A segment capacity (a multiple of 128) above lo's count, below
    hi's."""
    n_lo = int(rf.extract_segments(lo).count)
    n_hi = int(rf.extract_segments(hi).count)
    cap = 128 * (n_lo // 128 + 1)
    assert n_hi > cap, (n_lo, n_hi)
    return cap


@pytest.mark.cuda
def test_when_one_graph_takes_both_branches(cuda_device):
    def f(x, thr):
        return when(x.sum() > thr, lambda: torch.sin(x) * 2.0 + x.cumsum(0),
                    x + 0.0)

    g = compiled(f)
    x = torch.linspace(0.0, 1.0, 1000, device=cuda_device)
    for thr in (1e9, -1.0, 1e9, -1.0):
        t = torch.tensor(thr, device=cuda_device)
        assert _same(g(x, t), f(x, t))
    assert g.captures == 1


@pytest.mark.cuda
def test_guarded_entry_points_one_graph_both_branches(cuda_device):
    lo, hi = _grids(cuda_device)
    cap = _capacity(lo, hi)
    params = LocalizeParams(geom=GEOM, icp=IcpParams(iterations=20))
    exact = dataclasses.replace(params, fast_raycast=False)
    pose = se2.make(5.2, 5.1, 0.15, device=cuda_device)
    data, mask = _scene(cuda_device, (5.22, 5.1, 0.17))
    checked, step = (rf.raycast_checked_jit.compiled,
                     localize_step_jit.compiled)
    n0 = (checked.captures, step.captures)
    for grid, over in ((lo, False), (hi, True), (lo, False), (hi, True)):
        seg = rf.extract_segments(grid, max_segments=cap)
        assert (int(seg.n_dropped) > 0) == over
        got = rf.raycast_checked_jit(grid, GEOM, pose, segments=seg)
        want = rf.raycast_checked(grid, GEOM, pose, segments=seg)
        assert all(_same(a, b) for a, b in zip(got, want))
        res = localize_step_jit(grid, pose, pose, data, mask, params,
                                segments=seg)
        ref = localize_step(grid, pose, pose, data, mask,
                            exact if over else params, segments=seg)
        for f in res._fields:
            if f not in ("rays_dropped", "segments_swept"):
                assert _same(getattr(res, f), getattr(ref, f)), f
        assert int(res.rays_dropped) == int(seg.n_dropped)
        assert int(res.segments_swept) == int(seg.count)
    assert (checked.captures, step.captures) == (n0[0] + 1, n0[1] + 1)


@pytest.mark.cuda
def test_entry_point_replays_equal_eager(cuda_device):
    grid = _room(cuda_device)
    for xyt in POSES:
        pose = se2.make(*xyt, device=cuda_device)
        data, mask = _scene(cuda_device, xyt)
        assert all(_same(a, b) for a, b in zip(
            raycast_jit(grid, GEOM, pose), raycast(grid, GEOM, pose)))
        a = push_jit(grid, GEOM, pose, data, mask)
        b = push_cuda(grid, GEOM, pose, data, mask)
        t = push_tree_jit(grid, GEOM, pose, data, mask)
        u = push_tree(grid, GEOM, pose, data, mask)
        for f in FIELDS:
            assert _same(getattr(a, f), getattr(b, f)), f
            assert _same(getattr(t, f), getattr(u, f)), f
            assert _same(getattr(t, f), getattr(a, f)), f
        grid = a
        for infl in (False, True):
            got = occupancy_grid_jit(grid, use_inflation=infl)
            want = occupancy_grid(grid, use_inflation=infl)
            assert _same(got.occupancy, want.occupancy)
            assert _same(got.n_surface, want.n_surface)
        assert _same(grid_to_color_image_jit(grid), grid_to_color_image(grid))
    for fn in (raycast_jit, push_jit, push_tree_jit, occupancy_grid_jit,
               grid_to_color_image_jit):
        assert fn.compiled.captures >= 1 and fn.compiled.replays >= 4


@pytest.mark.cuda
@pytest.mark.parametrize("use_fast", [False, True])
def test_render_ranges_jit_backward_replays(cuda_device, use_fast):
    grid = _room(cuda_device)
    w = torch.linspace(0.5, 1.5, GEOM.size, device=cuda_device)

    def run(fn, xyt):
        x = torch.tensor(xyt, device=cuda_device, requires_grad=True)
        tsd = grid.tsd.clone().requires_grad_(True)
        g = dataclasses.replace(grid, tsd=tsd)
        ranges, hit, _ = fn(g, GEOM, se2.make(x[0], x[1], x[2],
                                              device=cuda_device),
                            use_fast=use_fast)
        (w * ranges).sum().backward()
        return ranges.detach(), hit, x.grad, tsd.grad

    forward, backward = render_ranges_jit.compiled
    for xyt in POSES[:3]:
        got, want = run(render_ranges_jit, xyt), run(render_ranges, xyt)
        assert all(_same(a, b) for a, b in zip(got, want))
        assert int(got[1].sum()) > GEOM.size // 2
    assert forward.replays >= 3 and backward.replays >= 3


@pytest.mark.cuda
def test_nccl_world_of_one_compiles_the_sharded_step(cuda_device):
    import torch.distributed as dist

    from ohm_tsd_slam_tpu_torch.parallel import (
        make_mesh,
        make_sharded_step,
        multi_robot_slam_step,
    )

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh("cuda")
        params = LocalizeParams(geom=GEOM, icp=IcpParams(iterations=20))
        grid = _room(cuda_device)
        poses = torch.stack([se2.make(*xyt, device=cuda_device)
                             for xyt in POSES[:2]])
        step, place = make_sharded_step(mesh, params)
        assert step.compiled is not None
        for k in range(3):
            scans = [_scene(cuda_device, (x + 0.02 * k, y, t))
                     for x, y, t in POSES[:2]]
            data = torch.stack([d for d, _ in scans])
            mask = torch.stack([m for _, m in scans])
            g, p, d, m = place(grid, poses, data, mask)
            got = step(g, p, d, m, seed=k)
            want = multi_robot_slam_step(g, p, d, m, params, seed=k,
                                         mesh=mesh)
            for f in FIELDS:
                assert _same(getattr(got.grid, f), getattr(want.grid, f))
            for f in ("poses", "reg_error", "pose_grad", "rms",
                      "rays_dropped"):
                assert _same(getattr(got, f), getattr(want, f)), f
            grid, poses = got.grid, got.poses
        assert step.compiled.captures == 1
    finally:
        dist.destroy_process_group()
