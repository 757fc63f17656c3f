"""Rank processes for the port's mesh tests (tests/test_torch_mesh.py,
test_torch_shard_raycast.py, test_torch_shard_matchers.py,
test_torch_sharded_step.py, test_torch_push_tree.py, and on the card
test_torch_paths_cuda.py).

`run_world(job, inputs, shape, tmp_path)` starts one process a rank with
torchrun's environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK,
LOCAL_RANK) on gloo and the CPU, as tests/test_distributed.py starts the
JAX package's processes, and returns each rank's results.  A rank runs
this file as a script: it imports only the port (never jax), joins the
world through parallel/distributed.py::initialize, builds the (sp, dp)
mesh, runs JOBS[job] on the inputs' npz and writes its results to
rank<r>.npz.  The parent compares them with the JAX package's functions
and the port's one-card functions.  With device_type="cuda" the ranks
join on the card (one rank on NCCL; several share the card on gloo) and
run the card's job, which asserts its checks itself.

Inputs and results are flat dicts of numpy arrays; a grid travels as its
`to_arrays` fields under a prefix, parameters as a JSON string.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID_FIELDS = ("tsd", "weight", "tile_init", "tile_initw", "cell_size",
               "max_truncation", "max_weight", "tile_dim")


def grid_arrays(d: dict, prefix: str = "grid_") -> dict:
    """A grid's to_arrays dict (or a JAX grid's fields) as npz entries."""
    return {prefix + f: np.asarray(d[f]) for f in GRID_FIELDS}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_world(job: str, inputs: dict, shape, tmp_path,
              timeout: float = 300.0, device_type: str = "cpu") -> list:
    """Run `job` on a world of sp * dp rank processes on `device_type`
    (gloo, but NCCL for one rank on the card); `shape` is (sp, dp), or
    "auto" for make_mesh over 4 ranks.  Returns the ranks' result dicts in
    rank order; raises with a rank's output if it failed."""
    n = 4 if shape == "auto" else shape[0] * shape[1]
    mesh_arg = "auto" if shape == "auto" else f"{shape[0]}x{shape[1]}"
    os.makedirs(tmp_path, exist_ok=True)
    inp = os.path.join(tmp_path, f"{job}-{mesh_arg}-in.npz")
    np.savez(inp, **inputs)
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env.update(MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(n), PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = []
    for r in range(n):
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), job, inp,
             str(tmp_path), mesh_arg, device_type],
            env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} of {job} on {mesh_arg} failed "
                               f"({p.returncode}):\n{out[-6000:]}")
    return [dict(np.load(os.path.join(tmp_path, f"{job}-{mesh_arg}-rank{r}"
                                      ".npz"))) for r in range(n)]


# ----------------------------------------------------------------------------
# rank side: imports the port only
# ----------------------------------------------------------------------------

def _grid(inp, prefix="grid_"):
    from ohm_tsd_slam_tpu_torch.grid.state import from_arrays

    return from_arrays({f: inp[prefix + f] for f in GRID_FIELDS})


def _geom(p: dict):
    from ohm_tsd_slam_tpu_torch.sensor.polar2d import SensorPolar2D

    return SensorPolar2D(**p["geom"])


def _t(a):
    import torch

    return torch.from_numpy(np.array(a))


def _count():
    """parallel/mesh.py::CollectiveCount: the all_reduce calls (the mesh's
    only collective) and their bytes while active."""
    from ohm_tsd_slam_tpu_torch.parallel.mesh import CollectiveCount

    return CollectiveCount()


def job_mesh(mesh, inp, p):
    """Placement, its raises, the collectives' building blocks and
    broadcast_scan."""
    import dataclasses

    import torch

    from ohm_tsd_slam_tpu_torch.parallel import (
        grid_sharding,
        replicated,
        robot_sharding,
    )
    from ohm_tsd_slam_tpu_torch.parallel.distributed import (
        broadcast_scan,
        local_device,
    )
    from ohm_tsd_slam_tpu_torch.parallel.mesh import (
        all_gather,
        axis_index,
        axis_size,
        psum,
        shard_rows,
    )
    from ohm_tsd_slam_tpu_torch.parallel.shard_raycast import _halo_exchange

    grid = _grid(inp)
    shard = grid_sharding(mesh, grid)
    robots = _t(inp["robots"])
    out = {f"shard_{f}": getattr(shard, f).numpy()
           for f in ("tsd", "weight", "tile_init", "tile_initw")}
    out["rows"] = np.array(shard_rows(mesh, shard))
    out["coords"] = np.array([axis_index(mesh, "sp"), axis_index(mesh, "dp"),
                              axis_size(mesh, "sp"), axis_size(mesh, "dp")])
    out["robots"] = robot_sharding(mesh, robots).numpy()
    out["replicated"] = replicated(mesh, robots).numpy()
    raised = []
    for fn in (lambda: grid_sharding(mesh, dataclasses.replace(
                   grid, tsd=grid.tsd[:p["odd_rows"]])),
               lambda: robot_sharding(mesh, robots[:p["odd_robots"]])):
        try:
            fn()
            raised.append(False)
        except ValueError:
            raised.append(True)
    out["raised"] = np.array(raised)
    out["halo"] = _halo_exchange(shard.tsd, mesh, "sp", 3).numpy()
    out["gather"] = all_gather(shard.tsd[:2], mesh, "sp").numpy()
    # the differentiable sum: the gradient of a loss every rank holds is
    # each rank's own part (not n times it)
    x = torch.full((), 1.0 + axis_index(mesh, "sp"), dtype=torch.float64,
                   requires_grad=True)
    y = psum(x * x, mesh, "sp")
    (g,) = torch.autograd.grad(y, x)
    out["psum"] = np.array([float(y), float(g)])
    scan = [inp["scan"] * (1.0 + torch.distributed.get_rank()),
            inp["scan_mask"] ^ bool(torch.distributed.get_rank() % 2)]
    got = broadcast_scan(mesh, scan, local_device("cpu"))
    out["bcast"] = got[0].numpy()
    out["bcast_mask"] = got[1].numpy()
    out["bcast_dtypes"] = np.array([str(t.dtype) for t in got])
    return out


def job_raycast(mesh, inp, p):
    """sharded_raycast for each query pose, sharded_map_residual and
    sharded_pose_gradient for each scan, the push into the rank's row
    block, and the collectives a render takes."""
    from ohm_tsd_slam_tpu_torch.grid.push import push
    from ohm_tsd_slam_tpu_torch.parallel import grid_sharding
    from ohm_tsd_slam_tpu_torch.parallel.mesh import shard_rows
    from ohm_tsd_slam_tpu_torch.parallel.shard_raycast import (
        sharded_map_residual,
        sharded_pose_gradient,
        sharded_raycast,
    )

    geom = _geom(p)
    shard = grid_sharding(mesh, _grid(inp))
    out = {}
    for i, pose in enumerate(inp["qposes"]):
        with _count() as cc:
            res = sharded_raycast(mesh, shard, geom, _t(pose))
        for f in ("coords", "normals", "mask", "ranges", "n_dropped"):
            out[f"ray{i}_{f}"] = getattr(res, f).numpy()
        out[f"ray{i}_collectives"] = np.array([cc.calls, cc.bytes])
    for i, (pose, d, m) in enumerate(zip(inp["gposes"], inp["gdata"],
                                         inp["gmask"])):
        out[f"loss{i}"] = sharded_map_residual(
            mesh, shard, geom, _t(pose), _t(d), _t(m)).detach().numpy()
        with _count() as cc:
            out[f"grad{i}"] = sharded_pose_gradient(
                mesh, shard, geom, _t(pose), _t(d), _t(m)).numpy()
        out[f"grad{i}_collectives"] = np.array([cc.calls, cc.bytes])
    y0, h, _ = shard_rows(mesh, shard)
    pushed = push(shard, geom, _t(inp["push_pose"]), _t(inp["push_data"]),
                  _t(inp["push_mask"]), ty0=y0 // shard.tile_dim)
    for f in ("tsd", "weight", "tile_init", "tile_initw"):
        out[f"push_{f}"] = getattr(pushed, f).numpy()
    return out


def _inject_list(inp, key: str, n: int, cls):
    fields = cls._fields
    if f"{key}0_{fields[0]}" not in inp:
        return None
    return [cls(*(_t(inp[f"{key}{r}_{f}"]) for f in fields))
            for r in range(n)]


def job_matchers(mesh, inp, p):
    """sharded_match_tsd, sharded_match_amcl (the JAX package's draws
    injected) and sharded_match_gauss_newton."""
    from ohm_tsd_slam_tpu_torch.parallel import grid_sharding
    from ohm_tsd_slam_tpu_torch.parallel.shard_matchers import (
        sharded_match_amcl,
        sharded_match_gauss_newton,
        sharded_match_tsd,
    )
    from ohm_tsd_slam_tpu_torch.registration.amcl import (
        AmclInject,
        AmclParams,
    )
    from ohm_tsd_slam_tpu_torch.registration.gauss_newton import GnParams
    from ohm_tsd_slam_tpu_torch.registration.ransac import (
        RansacInject,
        RansacParams,
    )

    shard = grid_sharding(mesh, _grid(inp))
    pose, scene, smask = (_t(inp[k]) for k in ("pose", "scene", "smask"))
    out = {}
    with _count() as cc:
        out["tsd_T"] = sharded_match_tsd(
            mesh, None, shard, pose, _t(inp["model"]), _t(inp["model_mask"]),
            scene, smask, RansacParams(**p["ransac"]),
            inject=_inject_list(inp, "tsd", 1, RansacInject)[0]).numpy()
    out["tsd_collectives"] = np.array([cc.calls, cc.bytes])
    with _count() as cc:
        out["amcl_T"] = sharded_match_amcl(
            mesh, None, shard, pose, scene, smask, AmclParams(**p["amcl"]),
            inject=_inject_list(inp, "amcl", 1, AmclInject)[0]).numpy()
    out["amcl_collectives"] = np.array([cc.calls, cc.bytes])
    with _count() as cc:
        gn = sharded_match_gauss_newton(mesh, shard, _t(inp["gn_pose"]),
                                        scene, smask, GnParams(**p["gn"]))
    out["gn_collectives"] = np.array([cc.calls, cc.bytes])
    for f in gn._fields:
        out[f"gn_{f}"] = getattr(gn, f).numpy()
    return out


def step_params(p: dict, mode: int):
    """The port's LocalizeParams from the JSON parameters."""
    from ohm_tsd_slam_tpu_torch.registration import amcl, ransac
    from ohm_tsd_slam_tpu_torch.registration.icp import IcpParams
    from ohm_tsd_slam_tpu_torch.slam.localize import LocalizeParams

    return LocalizeParams(
        geom=_geom(p), icp=IcpParams(iterations=p["icp_iterations"],
                                     bounds=tuple(p["bounds"])),
        mode=mode, ransac=ransac.RansacParams(**p["ransac"]),
        amcl=amcl.AmclParams(**p["amcl"]))


def job_step(mesh, inp, p):
    """make_sharded_step in each mode of p["modes"], every robot's draws
    injected where the mode draws."""
    from ohm_tsd_slam_tpu_torch.parallel import make_sharded_step
    from ohm_tsd_slam_tpu_torch.parallel.mesh import (
        axis_index,
        axis_size,
    )
    from ohm_tsd_slam_tpu_torch.registration.amcl import AmclInject
    from ohm_tsd_slam_tpu_torch.registration.ransac import RansacInject

    grid = _grid(inp)
    poses, data, mask = (_t(inp[k]) for k in ("poses", "data", "mask"))
    R = poses.shape[0]
    k = R // axis_size(mesh, "dp")
    mine = slice(axis_index(mesh, "dp") * k, (axis_index(mesh, "dp") + 1) * k)
    out = {}
    for name, mode in p["modes"].items():
        step, place = make_sharded_step(mesh, step_params(p, mode))
        inject = (_inject_list(inp, "tsd", R, RansacInject)
                  if name == "tsd" else
                  _inject_list(inp, "amcl", R, AmclInject)
                  if name == "amcl" else None)
        g, ps, d, m = place(grid, poses, data, mask)
        with _count() as cc:
            res = step(g, ps, d, m,
                       inject=None if inject is None else inject[mine])
        out[f"{name}_collectives"] = np.array([cc.calls, cc.bytes])
        for f in ("poses", "reg_error", "pose_grad", "rms", "rays_dropped"):
            out[f"{name}_{f}"] = getattr(res, f).numpy()
        for f in ("tsd", "weight", "tile_init", "tile_initw"):
            out[f"{name}_grid_{f}"] = getattr(res.grid, f).numpy()
    return out


def job_tiles(mesh, inp, p):
    """tile_sharding of a [TY, TX] array, grid_sharding's tile rows of a
    grid holding it, and whether an uneven split raises."""
    from ohm_tsd_slam_tpu_torch.config import GridConfig
    from ohm_tsd_slam_tpu_torch.grid.state import create
    from ohm_tsd_slam_tpu_torch.parallel.mesh import (
        grid_sharding,
        tile_sharding,
    )

    tiles = _t(inp["tiles"])
    grid = create(GridConfig(map_size=7, cellsize=0.05), device="cpu")
    grid = dataclasses.replace(grid, tile_initw=tiles,
                               tile_init=tiles > 1.5)
    try:
        tile_sharding(mesh, tiles[:-1])
        raised = False
    except ValueError:
        raised = True
    return {"tiles": tile_sharding(mesh, tiles).numpy(),
            "from_grid": grid_sharding(mesh, grid).tile_initw.numpy(),
            "tile_init": tile_sharding(mesh, tiles).numpy(),
            "init_rows": grid_sharding(mesh, grid).tile_init.numpy(),
            "init_want": tile_sharding(mesh, tiles > 1.5).numpy(),
            "raised": np.array(raised)}


def job_card(mesh, inp, p):
    """On the card, configs/double-laser.yaml's two robots at the real
    size (tests/torch_card.py::multi_robot_setup): the push into the
    rank's row block equal in every bit to those rows of the whole grid's
    push, and within compare_push of the plain push into the block; the
    sharded render of each robot against the one-card caster (coordinates
    within MULTI_TOL where both hit, at most 0.5% of the beams' hits
    flipped), kernels A, B and C on the row block and D on the halo'd
    block against their twins at every launch; STEPS_MULTI eager ICP
    steps of the sharded step within 2.5 cells, the first within
    MULTI_TOL of the one-card step, with their launches; one TSD and one
    GN step; where make_sharded_step compiles (NCCL), its replays equal
    the eager step in every bit."""
    import functools

    import torch
    import torch_card as tc

    from ohm_tsd_slam_tpu_torch.config import from_flat_params
    from ohm_tsd_slam_tpu_torch.core import se2
    from ohm_tsd_slam_tpu_torch.grid import raycast_fast as rf
    from ohm_tsd_slam_tpu_torch.grid.push import push
    from ohm_tsd_slam_tpu_torch.ops.kernel_check import KernelCheck, PushCheck
    from ohm_tsd_slam_tpu_torch.parallel import (
        grid_sharding,
        make_sharded_step,
        multi_robot_slam_step,
        robot_sharding,
        sharded,
    )
    from ohm_tsd_slam_tpu_torch.parallel.distributed import local_device
    from ohm_tsd_slam_tpu_torch.parallel.mesh import axis_size, shard_rows
    from ohm_tsd_slam_tpu_torch.parallel.shard_raycast import (
        sharded_raycast,
    )
    from ohm_tsd_slam_tpu_torch.registration.ransac import RansacParams
    from ohm_tsd_slam_tpu_torch.utils.testing import SINGLE_LASER

    dev = local_device("cuda")
    push_check = PushCheck()
    cfg, geom, params, gts, grid0, poses0 = tc.multi_robot_setup(
        dev, push_check)
    R, steps = poses0.shape[0], tc.STEPS_MULTI
    limit = 2.5 * cfg.grid.cellsize

    # the push into the row block against the whole grid's push
    shard0 = grid_sharding(mesh, grid0)
    y0, h, _ = shard_rows(mesh, shard0)
    ty0 = y0 // shard0.tile_dim
    data1, mask1 = tc.multi_robot_inputs(gts, 1, dev)
    pose1 = se2.make(*gts[0][1], device=dev)
    whole = push_check(grid0, geom, pose1, data1[0], mask1[0])
    mine = push_check(shard0, geom, pose1, data1[0], mask1[0], ty0=ty0)
    tiles = slice(ty0, ty0 + shard0.tiles_y)
    for f, rows in (("tsd", slice(y0, y0 + h)), ("weight", slice(y0, y0 + h)),
                    ("tile_init", tiles), ("tile_initw", tiles)):
        assert tc.bits_equal(getattr(mine, f), getattr(whole, f)[rows]), f
    tc.compare_push(push(shard0, geom, pose1, data1[0], mask1[0], ty0=ty0),
                    mine)

    # the sharded render of each robot against the one-card caster
    check = KernelCheck()
    for r in range(R):
        pose = se2.make(*gts[r][1], device=dev)
        got = sharded_raycast(mesh, shard0, geom, pose,
                              kernels=check.kernels)
        ref = rf.raycast_fast(grid0, geom, pose)
        both = got.mask & ref.mask
        gap = (got.coords - ref.coords).abs()[both]
        assert int(got.n_dropped) == 0 and int(got.mask.sum()) > geom.size // 2
        assert int((got.mask != ref.mask).sum()) <= 0.005 * geom.size
        assert not gap.numel() or float(gap.max()) <= tc.MULTI_TOL
    for name in ("segment_layers", "pack_rows", "segment_min",
                 "window_replay"):
        assert check.stats[name]["calls"] > 0, check.stats
        assert check.stats[name]["max_abs_err"] == 0.0, check.stats

    # the eager steps, every push checked and every launch counted; the
    # first against the one-card step
    ref1 = multi_robot_slam_step(grid0, poses0, data1, mask1, params)
    best_push = sharded.best_push
    sharded.best_push = lambda grid: push_check
    step, place = make_sharded_step(mesh, params)
    eager = functools.partial(multi_robot_slam_step, params=params,
                              mesh=mesh)
    g, p, _, _ = place(grid0, poses0, data1, mask1)
    tc.reset_counts()
    for k in range(1, steps + 1):
        data, mask = tc.multi_robot_inputs(gts, k, dev)
        res = eager(g, p, robot_sharding(mesh, data),
                    robot_sharding(mesh, mask), seed=k)
        assert int(res.rays_dropped) == 0, k
        assert not bool(res.reg_error.any()), (k, res.reg_error)
        if k == 1:
            assert float((res.poses - ref1.poses)[:, :2, 2].abs().max()
                         ) < tc.MULTI_TOL
        g, p = res.grid, robot_sharding(mesh, res.poses)
        poses = res.poses.cpu()
        for r, gt in enumerate(gts):
            assert math.hypot(float(poses[r, 0, 2]) - gt[k][0],
                              float(poses[r, 1, 2]) - gt[k][1]) < limit
    la = tc.read_counts()
    renders = steps * R // axis_size(mesh, "dp")
    assert la["segment_layers"] == la["pack_rows"] == renders, la
    assert la["segment_min"] == la["window_replay"] == rf.ROUNDS * renders
    assert la["push"] == R * steps, la
    assert la["window_rounds"] == la["compact_channels"] == 0, la

    # one step each in the modes TSD and GN from the last state
    data, mask = tc.multi_robot_inputs(gts, steps, dev)
    d, m = robot_sharding(mesh, data), robot_sharding(mesh, mask)
    for mode in (3, 4):
        mparams = dataclasses.replace(
            params, mode=mode, ransac=RansacParams.from_config(
                from_flat_params(SINGLE_LASER).robots[0].registration.ransac,
                geom.angular_res))
        mstep, _ = make_sharded_step(mesh, mparams)
        res = multi_robot_slam_step(g, p, d, m, mparams, seed=7, mesh=mesh)
        if mstep.compiled is not None:
            # the step's graph, the push kernel unchecked inside it (the
            # check reads the card), against the eager step
            sharded.best_push = best_push
            try:
                assert tc.step_results_equal(mstep(g, p, d, m, seed=7),
                                             res), mode
            finally:
                sharded.best_push = lambda grid: push_check
        assert not bool(res.reg_error.any()), (mode, res.reg_error)
        assert bool(torch.isfinite(res.poses).all()), mode
        moved = robot_sharding(mesh, res.poses) - p
        assert float(moved[:, :2, 2].abs().max()) < limit, mode
    sharded.best_push = best_push

    # the step as make_sharded_step returns it: a graph on NCCL, each
    # replay against the eager step in every bit; eager on gloo
    if step.compiled is not None:
        g, p, _, _ = place(grid0, poses0, data1, mask1)
        for k in range(1, 6):
            data, mask = tc.multi_robot_inputs(gts, k, dev)
            d, m = robot_sharding(mesh, data), robot_sharding(mesh, mask)
            got = step(g, p, d, m, seed=k)
            assert tc.step_results_equal(got, eager(g, p, d, m, seed=k)), k
            g, p = got.grid, robot_sharding(mesh, got.poses)
        assert step.compiled.captures == 1
    return {"icp_steps": np.array(steps),
            "compiled": np.array(step.compiled is not None)}


JOBS = {"mesh": job_mesh, "raycast": job_raycast, "matchers": job_matchers,
        "step": job_step, "tiles": job_tiles, "card": job_card}


def main(argv) -> int:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from ohm_tsd_slam_tpu_torch.parallel import make_mesh
    from ohm_tsd_slam_tpu_torch.parallel.distributed import initialize
    from ohm_tsd_slam_tpu_torch.utils.testing import limit_cpu_threads

    job, inp_path, out_dir, mesh_arg, device_type = argv[1:6]
    limit_cpu_threads()
    # NCCL takes one rank a card: ranks sharing the card take gloo
    one_card_rank = device_type == "cuda" and os.environ["WORLD_SIZE"] == "1"
    backend = "nccl" if one_card_rank else "gloo"
    assert initialize(backend=backend, device_type=device_type), \
        "initialize() did not join the world"
    try:
        if mesh_arg == "auto":
            mesh = make_mesh(device_type)
        else:
            sp, dp = (int(x) for x in mesh_arg.split("x"))
            mesh = DeviceMesh(device_type,
                              torch.arange(sp * dp).reshape(sp, dp),
                              mesh_dim_names=("sp", "dp"))
        inp = dict(np.load(inp_path))
        params = json.loads(str(inp.pop("params", "{}")))
        out = JOBS[job](mesh, inp, params)
        np.savez(os.path.join(out_dir, f"{job}-{mesh_arg}-rank"
                              f"{dist.get_rank()}.npz"), **out)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    sys.exit(main(sys.argv))
