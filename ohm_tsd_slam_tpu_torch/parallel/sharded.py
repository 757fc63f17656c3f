"""The multi-robot SLAM step, on one card or over a device mesh (port of
ohm_tsd_slam_tpu/parallel/sharded.py).

One full cycle for R robots sharing one grid: every robot's model scan is
rendered, each robot is registered in its mode (the doRegistration
dispatch of ThreadLocalize.cpp:513-591, as slam/localize.py::
localize_step), every robot's scan is fused into the grid in turn
(serialized grid writes, as ThreadMapping does for the shared grid), and
the differentiable map-residual pose gradient is taken per robot.

On one card the robots' renders are one pose batch
(grid/raycast_fast.py::raycast_fast_batch: kernels C, D and D's rounds
launch once for all robots).  Over a mesh (parallel/mesh.py) the grid's
rows are split over "sp" and the robots over "dp": each rank renders,
registers and differentiates its robots through the shard-local paths
(parallel/shard_raycast.py, shard_matchers.py; EXP and PDF read no grid
and run as on one card), the results are gathered over "dp", and every
rank fuses all robots' scans into its own rows with the push kernel: the
reference's OpenMP over partitions (TsdGrid.cpp:228-232) maps to "sp",
its N localizer threads (SlamNode.cpp:101-122) to "dp".
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ohm_tsd_slam_tpu_torch.config import RegMode
from ohm_tsd_slam_tpu_torch.core import se2
from ohm_tsd_slam_tpu_torch.grid.dispatch import best_push
from ohm_tsd_slam_tpu_torch.grid.interpolate import interpolate_bilinear_safe
from ohm_tsd_slam_tpu_torch.grid.raycast import RaycastResult, raycast
from ohm_tsd_slam_tpu_torch.grid.raycast_fast import (
    extract_segments,
    raycast_fast_batch,
)
from ohm_tsd_slam_tpu_torch.grid.state import TsdGrid
from ohm_tsd_slam_tpu_torch.parallel.mesh import (
    all_gather,
    axis_index,
    float_pack,
    float_unpack,
    grid_sharding,
    robot_sharding,
    shard_rows,
)
from ohm_tsd_slam_tpu_torch.parallel.shard_matchers import (
    sharded_match_amcl,
    sharded_match_gauss_newton,
    sharded_match_tsd,
)
from ohm_tsd_slam_tpu_torch.parallel.shard_raycast import (
    sharded_pose_gradient,
    sharded_raycast,
)
from ohm_tsd_slam_tpu_torch.registration.amcl import match_amcl
from ohm_tsd_slam_tpu_torch.registration.gauss_newton import (
    match_gauss_newton,
)
from ohm_tsd_slam_tpu_torch.registration.icp import icp
from ohm_tsd_slam_tpu_torch.registration.ransac import (
    match_normal,
    match_pdf,
    match_tsd,
)
from ohm_tsd_slam_tpu_torch.sensor.polar2d import (
    SensorPolar2D,
    data_to_cartesian,
)
from ohm_tsd_slam_tpu_torch.slam.localize import (
    LocalizeParams,
    is_registration_error,
)
from ohm_tsd_slam_tpu_torch.utils.compiled import compiled, when

_SEED_MIX = 1_000_003
_GRID_FIELDS = ("tsd", "weight", "tile_init", "tile_initw")


class SlamStepResult(NamedTuple):
    grid: TsdGrid
    poses: torch.Tensor        # [R, 3, 3] updated poses
    reg_error: torch.Tensor    # [R] bool
    pose_grad: torch.Tensor    # [R, 3] d(residual)/d(x, y, theta)
    rms: torch.Tensor          # [R]
    # the fast caster's drop count summed over the robots, each robot
    # counting the extraction's drops (int64; 0 = clean).  On one card,
    # when nonzero the step rendered every robot with the exact march, so
    # no beam was lost; over a mesh there is no such fallback (it would
    # gather the grid) and the count is all.
    rays_dropped: Optional[torch.Tensor] = None


def map_residual_loss(grid: TsdGrid, geom: SensorPolar2D,
                      pose: torch.Tensor, data: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """Mean squared TSD value at the world positions of the scan points:
    the objective TSD_PDFMatching evaluates (TSD_PDFMatching.cpp:223-251)
    made differentiable; zero when every point lies on the stored
    surface."""
    scene, valid = data_to_cartesian(geom, data, mask)
    world = se2.transform_points(pose, scene)
    tsd, interp_ok = interpolate_bilinear_safe(grid, world)
    ok = valid & interp_ok
    sq = torch.where(ok, tsd * tsd, 0.0)
    return sq.sum() / ok.sum().clamp(min=1)


def pose_gradient(grid: TsdGrid, geom: SensorPolar2D, pose: torch.Tensor,
                  data: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """d(map residual)/d(x, y, theta) of the pose perturbed on the right
    by se2.make(x, y, theta), at zero, by autograd through the bilinear
    taps (the differentiable-localization direction)."""
    with torch.enable_grad():
        params = torch.zeros(3, dtype=pose.dtype, device=pose.device,
                             requires_grad=True)
        delta = se2.make(params[0], params[1], params[2], dtype=pose.dtype,
                         device=pose.device)
        loss = map_residual_loss(grid, geom, pose @ delta, data, mask)
        (grad,) = torch.autograd.grad(loss, params)
    return grad


def _robot_generators(seed: int, robots: range, device) -> list:
    """One draw stream a robot, seeded from (seed, robot): the same on
    every rank that registers the robot."""
    gens = []
    for r in robots:
        gen = torch.Generator(device=device)
        gen.manual_seed((seed * _SEED_MIX + r) % (1 << 63))
        gens.append(gen)
    return gens


def _exact_models(grid: TsdGrid, geom: SensorPolar2D,
                  poses: torch.Tensor) -> RaycastResult:
    """Every robot's model scan by the exact march, stacked as
    raycast_fast_batch stacks them (one n_dropped, 0)."""
    exact = [raycast(grid, geom, poses[r]) for r in range(poses.shape[0])]
    stacked = [torch.stack(f) for f in zip(*exact)]
    return RaycastResult(*stacked[:-1], exact[0].n_dropped)


def _model(models: RaycastResult, r: int) -> RaycastResult:
    return RaycastResult(*(f[r] if f.dim() else f for f in models))


def _gather_robots(mesh: DeviceMesh, parts: Sequence[torch.Tensor],
                   dtype) -> list:
    """Each part [R, ...] of this rank's robots as [dp * R, ...] of every
    robot, in robot order, on every rank: one collective over "dp" of the
    parts packed as `dtype` rows (exact: a robot's row has one writer)."""
    rows = float_pack(parts, dtype, lead=1)
    rows = all_gather(rows, mesh, "dp").reshape(-1, rows.shape[1])
    return float_unpack(rows, parts, lead=1)


def multi_robot_slam_step(grid: TsdGrid, poses: torch.Tensor,
                          data: torch.Tensor, mask: torch.Tensor,
                          params: LocalizeParams, seed: int = 0,
                          inject: Optional[Sequence] = None,
                          mesh: Optional[DeviceMesh] = None
                          ) -> SlamStepResult:
    """One full SLAM cycle for R robots sharing one grid, on the grid's
    device (ohm_tsd_slam_tpu/parallel/sharded.py::multi_robot_slam_step).

    Args:
      grid: the shared TSD grid; with a mesh, this rank's row block
        (mesh.grid_sharding).
      poses: [R, 3, 3] sensor poses; with a mesh, this rank's "dp" slice
        of the robots (mesh.robot_sharding), as are data and mask.
      data, mask: [R, B] masked scans (the same scan geometry for every
        robot, as in configs/double-laser.yaml).
      params: static localization parameters; every registration mode
        runs: ICP, the RANSAC seeds EXP, PDF and TSD before ICP, AMCL
        before ICP, and direct Gauss-Newton (GN renders nothing).
      seed: the stochastic modes draw from one torch.Generator a robot,
        on the grid's device, seeded from (seed, robot); callers should
        pass a fresh seed each step, as the JAX package's callers pass a
        fresh key.  Every rank of a mesh passes the same seed.
      inject: per robot (this rank's, with a mesh), the matcher's draws
        given (a RansacInject in the modes EXP, PDF, TSD; an AmclInject in
        mode AMCL), for the parity tests.
      mesh: the device mesh of the row-sharded step (see the module
        docstring); None on one card.

    On one card the render is one raycast_fast_batch for all robots (the
    grid's segments extracted inline, once for all robots), guarded once
    for the whole batch (utils/compiled.py::when on the summed drop
    count): when anything was dropped every robot is rendered again with
    the exact march (as the JAX package re-renders the whole batch under
    one lax.cond).  Eagerly the guard reads the count once; in a graph it
    is a conditional node.  Over a mesh each robot is rendered by
    sharded_raycast (no fallback; the drops are counted), the results of
    every robot are gathered over "dp" in one collective, and the result
    holds this rank's row block and every robot's pose, error, gradient
    and rms.  The fuse keeps the old grid where a robot's registration
    failed, with torch.where on the card (no host read)."""
    R = poses.shape[0]
    first = 0 if mesh is None else axis_index(mesh, "dp") * R
    generators = _robot_generators(seed, range(first, first + R),
                                   grid.tsd.device)
    return _slam_step(grid, poses, data, mask, params, generators, inject,
                      mesh)


def _slam_step(grid: TsdGrid, poses: torch.Tensor, data: torch.Tensor,
               mask: torch.Tensor, params: LocalizeParams,
               generators: list, inject: Optional[Sequence],
               mesh: Optional[DeviceMesh]) -> SlamStepResult:
    """multi_robot_slam_step on the robots' draw streams `generators`."""
    geom = params.geom
    R = poses.shape[0]
    mode = params.mode
    dtype, dev = grid.tsd.dtype, grid.tsd.device
    poses = poses.to(dtype)
    inject = list(inject) if inject is not None else [None] * R
    # the grid readers: their row-sharded counterparts take the mesh first
    readers = (match_gauss_newton, match_tsd, match_amcl, pose_gradient)
    if mesh is not None:
        readers = tuple(partial(f, mesh) for f in (
            sharded_match_gauss_newton, sharded_match_tsd,
            sharded_match_amcl, sharded_pose_gradient))
    gauss_newton, tsd_match, amcl_match, gradient = readers

    rays_dropped = torch.zeros((), dtype=torch.int64, device=dev)
    models = None
    if mode != int(RegMode.GN):
        if mesh is not None:
            renders = [sharded_raycast(mesh, grid, geom, poses[r])
                       for r in range(R)]
            models = RaycastResult(*(torch.stack(f) for f in zip(*renders)))
        else:
            # the overflow guard, once for the whole batch: every robot is
            # rendered again with the exact march when any overflowed
            # (its models' n_dropped 0), as the JAX package re-renders
            # the batch under one lax.cond
            # (the extraction's drops count once a robot, as each robot's
            # render in the JAX package loses them)
            seg = extract_segments(grid)
            models = raycast_fast_batch(grid, geom, poses, segments=seg)
            rays_dropped = models.n_dropped + (R - 1) * seg.n_dropped
            models = when(rays_dropped > 0,
                          partial(_exact_models, grid, geom, poses),
                          models._replace(
                              n_dropped=torch.zeros_like(rays_dropped)))

    new_poses, errs, grads, rms = [], [], [], []
    for r in range(R):
        pose = poses[r]
        scene, smask = data_to_cartesian(geom, data[r], mask[r])
        gen, inj = generators[r], inject[r]
        if models is None:
            # direct scan-to-map Gauss-Newton: no render, no pairing
            gn = gauss_newton(grid, pose, scene, smask, params.gn)
            T = gn.T
            err = is_registration_error(T, params.trns_max, params.rot_max)
            err = err | (gn.matches < params.gn.min_matches)
            res_rms = gn.rms
        else:
            model = _model(models, r)
            # pre-registration seed by mode (ThreadLocalize.cpp:530-568)
            if mode == int(RegMode.EXP):
                T_init = match_normal(gen, model.coords, model.mask, scene,
                                      smask, params.ransac, inject=inj)
            elif mode == int(RegMode.PDF):
                T_init = match_pdf(gen, model.coords, model.mask, scene,
                                   smask, params.ransac, params.beam,
                                   inject=inj)
            elif mode == int(RegMode.TSD):
                T_init = tsd_match(gen, grid, pose, model.coords, model.mask,
                                   scene, smask, params.ransac, inject=inj)
            elif mode == int(RegMode.AMCL):
                T_init = amcl_match(gen, grid, pose, scene, smask,
                                    params.amcl, inject=inj)
            else:
                T_init = torch.eye(3, dtype=dtype, device=dev)
            res = icp(model.coords, model.mask, scene, smask, params.icp,
                      T_init=T_init, sensor_pose=pose,
                      model_normals=model.normals)
            T = res.T
            err = is_registration_error(T, params.trns_max, params.rot_max)
            err = err | (model.mask.sum() == 0)
            res_rms = res.rms
        new_pose = torch.where(err, pose, pose @ T)
        new_poses.append(new_pose)
        errs.append(err)
        grads.append(gradient(grid, geom, new_pose, data[r], mask[r]))
        rms.append(res_rms)
    new_poses, errs = torch.stack(new_poses), torch.stack(errs)
    grads, rms = torch.stack(grads), torch.stack(rms)

    ty0 = 0
    if mesh is not None:
        # every robot's results and scan on every rank, in robot order
        dropped = (torch.zeros(R, dtype=torch.int64, device=dev)
                   if models is None else models.n_dropped)
        new_poses, errs, grads, rms, dropped, data, mask = _gather_robots(
            mesh, (new_poses, errs, grads, rms, dropped, data, mask), dtype)
        rays_dropped = dropped.sum()
        ty0 = shard_rows(mesh, grid)[0] // grid.tile_dim

    # fuse every robot's scan in turn; a failed robot's push is discarded
    push_fn = best_push(grid)
    g = grid
    for r in range(new_poses.shape[0]):
        g2 = push_fn(g, geom, new_poses[r], data[r], mask[r], ty0=ty0)
        g = dataclasses.replace(g, **{
            f: torch.where(errs[r], getattr(g, f), getattr(g2, f))
            for f in _GRID_FIELDS})

    return SlamStepResult(grid=g, poses=new_poses, reg_error=errs,
                          pose_grad=grads, rms=rms,
                          rays_dropped=rays_dropped)


def make_sharded_step(mesh: DeviceMesh, params: LocalizeParams):
    """The multi-robot step over `mesh` (the JAX package's jitted step
    with explicit shardings): returns (step, place).  place(grid, poses,
    data, mask) cuts this rank's row block of the whole grid and its "dp"
    slice of the robots; step(grid, poses, data, mask, seed=0,
    inject=None) runs multi_robot_slam_step on them with the mesh, and
    its result's grid stays this rank's row block.

    When the mesh's process group is NCCL the step is compiled
    (utils/compiled.py: a CUDA graph a key, its collectives captured with
    it, replayed with one launch a call; `step.compiled` holds it).  The
    seed is no part of the key: the robots' draw streams are made from it
    outside the graph and handed in.  Gloo's collectives run on the host
    and cannot be captured, so on gloo the step runs eagerly (the tensors
    stay on their device) and `step.compiled` is None."""
    def sharded_step(grid, poses, data, mask, generators, inject):
        return _slam_step(grid, poses, data, mask, params, generators,
                          inject, mesh)

    graph = (compiled(sharded_step, name="sharded_step")
             if dist.get_backend() == dist.Backend.NCCL else None)

    def step(grid, poses, data, mask, seed: int = 0, inject=None):
        R = poses.shape[0]
        first = axis_index(mesh, "dp") * R
        generators = _robot_generators(seed, range(first, first + R),
                                       grid.tsd.device)
        return (graph or sharded_step)(grid, poses, data, mask, generators,
                                       inject)

    step.compiled = graph

    def place(grid, poses, data, mask):
        return (grid_sharding(mesh, grid), robot_sharding(mesh, poses),
                robot_sharding(mesh, data), robot_sharding(mesh, mask))

    return step, place
