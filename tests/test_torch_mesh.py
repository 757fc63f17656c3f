"""The port's mesh and multi-process wiring (ohm_tsd_slam_tpu_torch/
parallel/mesh.py, distributed.py) against the JAX package's
(ohm_tsd_slam_tpu/parallel/mesh.py, distributed.py), on the CPU.

`_factor2` and `initialize` without an environment run here.  The rest
runs in real gloo worlds of rank processes (tests/torch_mesh_worker.py,
one world a mesh shape, once for the module): (sp, dp) = (2, 1), (4, 1)
and make_mesh over 4 ranks, which is (2, 2) as the JAX package's
make_mesh makes it.  Each rank's slices are held against the shards
jax.device_put gives the device at the same mesh position under
grid_sharding and robot_sharding, bit for bit; the raises, the halo
exchange and gather built from all_reduce, the differentiable sum's
gradient (each rank's own part, not n times it) and broadcast_scan are
held against their definitions."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from ohm_tsd_slam_tpu.parallel import mesh as jmesh
from ohm_tsd_slam_tpu_torch.config import GridConfig
from ohm_tsd_slam_tpu_torch.grid.state import create, to_arrays
from ohm_tsd_slam_tpu_torch.parallel import distributed
from ohm_tsd_slam_tpu_torch.parallel.mesh import _factor2
from ohm_tsd_slam_tpu_torch.utils.testing import limit_cpu_threads
from torch_mesh_worker import grid_arrays, run_world

limit_cpu_threads()

SHAPES = [(2, 1), (4, 1), "auto"]
ROBOTS = 4


def _ids(shape):
    return "make_mesh4" if shape == "auto" else f"{shape[0]}x{shape[1]}"


@pytest.mark.parametrize("n", range(1, 13))
def test_factor2_matches_jax(n):
    a, b = _factor2(n)
    assert (a, b) == jmesh._factor2(n)
    assert a * b == n and a <= b


def test_initialize_without_a_world_does_nothing(monkeypatch):
    import torch.distributed as dist

    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize() is False
    assert distributed.initialize(world_size=4) is False
    assert not dist.is_initialized()
    # without a card the rank's device is the CPU only when asked for
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device_type="cpu"'):
        distributed.local_device()
    assert distributed.local_device("cpu") == torch.device("cpu")


def test_mesh_entry_points_need_the_cpu_named(monkeypatch):
    """make_mesh() and initialize() go to the card unless "cpu" is named,
    and raise without one (before any group forms)."""
    import torch.distributed as dist

    from ohm_tsd_slam_tpu_torch.parallel import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device_type="cpu"'):
        make_mesh()
    with pytest.raises(RuntimeError, match='device_type="cpu"'):
        distributed.initialize(init_method="tcp://localhost:1",
                               world_size=1, rank=0)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="device_type"):
        distributed.local_device("tpu")


@pytest.mark.parametrize("lead", [0, 1])
def test_float_pack_round_trip(lead):
    """float_pack then float_unpack gives every part back in its dtype and
    shape, bit for bit, with `lead` shared dims kept (the robot axis of
    the step's gather)."""
    import torch

    from ohm_tsd_slam_tpu_torch.parallel.mesh import float_pack, float_unpack

    g = torch.Generator().manual_seed(3)
    parts = [torch.randn(3, 3, 3, generator=g, dtype=torch.float32),
             torch.rand(3, generator=g) < 0.5,
             torch.randint(0, 1 << 20, (3,), generator=g),
             torch.tensor([-0.0, 0.0, 1.5])]
    if not lead:        # a scalar, as the matchers' sums
        parts.append(torch.tensor(2.5, dtype=torch.float64))
    flat = float_pack(parts, torch.float64, lead)
    assert flat.shape == ((3, 9 + 1 + 1 + 1) if lead else (37,))
    for got, want in zip(float_unpack(flat, parts, lead), parts):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.numpy().tobytes() == want.numpy().tobytes()


def _grid():
    """A map_size 7 grid (128 x 128 cells, 4 x 4 tiles) with distinct
    values, NaN cells, -0.0 and +0.0 cells (a collective must keep a
    signed zero) and some tiles initialised."""
    rng = np.random.default_rng(0)
    d = to_arrays(create(GridConfig(map_size=7, cellsize=0.05),
                             device="cpu"))
    d["tsd"] = rng.uniform(-1, 1, d["tsd"].shape).astype(np.float32)
    d["tsd"][rng.random(d["tsd"].shape) < 0.2] = np.nan
    d["tsd"][:, 3::7] = -0.0
    d["tsd"][:, 5::11] = 0.0
    d["weight"] = rng.uniform(0, 5, d["weight"].shape).astype(np.float32)
    d["tile_init"] = rng.random(d["tile_init"].shape) < 0.5
    d["tile_initw"] = rng.uniform(0, 3, d["tile_initw"].shape
                                  ).astype(np.float32)
    return d


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    import json

    grid = _grid()
    rng = np.random.default_rng(1)
    inputs = grid_arrays(grid)
    inputs.update(
        robots=rng.normal(size=(ROBOTS, 3, 3)),
        scan=rng.uniform(0, 9, 181), scan_mask=rng.random(181) < 0.7,
        # a block height and a robot count that do not always split
        params=np.array(json.dumps({"odd_rows": 64, "odd_robots": 3})))
    tmp = tmp_path_factory.mktemp("mesh")
    return grid, inputs, {shape: run_world("mesh", inputs, shape, tmp)
                          for shape in SHAPES}


def _jax_mesh(shape):
    devices = jax.devices()
    if shape == "auto":
        return jmesh.make_mesh(devices[:4])
    return Mesh(np.array(devices[:shape[0] * shape[1]]).reshape(shape),
                ("sp", "dp"))


def _shard_at(arr, sharding, device):
    """The shard of `arr` that jax.device_put places on `device`."""
    placed = jax.device_put(arr, sharding)
    return next(np.asarray(s.data) for s in placed.addressable_shards
                if s.device == device)


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_rank_layout_matches_jax_mesh(worlds, shape):
    """Rank r sits at (r // dp, r % dp), as JAX lays out its devices."""
    jm = _jax_mesh(shape)
    sp, dp = jm.devices.shape
    for r, res in enumerate(worlds[2][shape]):
        assert res["coords"].tolist() == [r // dp, r % dp, sp, dp]


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_grid_sharding_matches_jax(worlds, shape):
    grid, _, ranks = worlds
    jm = _jax_mesh(shape)
    sp, dp = jm.devices.shape
    gs = jmesh.grid_sharding(jm)
    for r, res in enumerate(ranks[shape]):
        dev = jm.devices[r // dp, r % dp]
        for f in ("tsd", "weight", "tile_init", "tile_initw"):
            want = _shard_at(grid[f], gs, dev)
            assert res[f"shard_{f}"].tobytes() == want.tobytes(), (r, f)
        h = grid["tsd"].shape[0] // sp
        assert res["rows"].tolist() == [(r // dp) * h, h, h * sp]


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_robot_sharding_and_replicated_match_jax(worlds, shape):
    _, inputs, ranks = worlds
    jm = _jax_mesh(shape)
    dp = jm.devices.shape[1]
    for r, res in enumerate(ranks[shape]):
        dev = jm.devices[r // dp, r % dp]
        want = _shard_at(inputs["robots"], jmesh.robot_sharding(jm), dev)
        np.testing.assert_array_equal(res["robots"], want)
        np.testing.assert_array_equal(
            res["replicated"],
            _shard_at(inputs["robots"], jmesh.replicated(jm), dev))


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_placement_raises_on_uneven_splits(worlds, shape):
    """64 rows split into whole 32-cell tiles over sp = 2 but not over
    sp = 4; 3 robots do not split over dp = 2 (they do over dp = 1)."""
    sp, dp = _jax_mesh(shape).devices.shape
    for res in worlds[2][shape]:
        assert res["raised"].tolist() == [sp == 4, dp == 2]


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_halo_exchange_matches_the_whole_grid(worlds, shape):
    """Three rows of each neighbour block, NaN beyond the grid's edges:
    the rows of the whole grid around the rank's block, NaN for NaN."""
    grid, _, ranks = worlds
    sp, dp = _jax_mesh(shape).devices.shape
    tsd = grid["tsd"]
    nan = np.full((3, tsd.shape[1]), np.nan, np.float32)
    padded = np.concatenate([nan, tsd, nan])
    h = tsd.shape[0] // sp
    for r, res in enumerate(ranks[shape]):
        y0 = (r // dp) * h
        assert res["halo"].tobytes() == padded[y0:y0 + h + 6].tobytes(), r


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_all_gather_in_axis_order(worlds, shape):
    grid, _, ranks = worlds
    sp, _ = _jax_mesh(shape).devices.shape
    h = grid["tsd"].shape[0] // sp
    want = np.stack([grid["tsd"][i * h:i * h + 2] for i in range(sp)])
    for res in ranks[shape]:
        assert res["gather"].tobytes() == want.tobytes()


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_psum_gradient_is_each_ranks_part(worlds, shape):
    """y = sum over sp of x_i^2 with x_i = 1 + i: every rank holds y, and
    its gradient is 2 x_i (torch.distributed.nn's all_reduce would give
    sp times that)."""
    sp, dp = _jax_mesh(shape).devices.shape
    y = sum((1.0 + i) ** 2 for i in range(sp))
    for r, res in enumerate(worlds[2][shape]):
        x = 1.0 + r // dp
        assert res["psum"].tolist() == [y, 2.0 * x]


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_broadcast_scan_gives_rank0s_arrays(worlds, shape):
    _, inputs, ranks = worlds
    for res in ranks[shape]:
        np.testing.assert_array_equal(res["bcast"], inputs["scan"])
        np.testing.assert_array_equal(res["bcast_mask"], inputs["scan_mask"])
        assert res["bcast_dtypes"].tolist() == ["torch.float64",
                                                "torch.bool"]
