"""The CUDA push kernel (ohm_tsd_slam_tpu_torch/csrc/push.cu) and its
wrapper and dispatcher.

On the CPU: the dispatcher and the wrapper take the plain push and never
count a launch, and importing the wrapper needs no compiler.  Tests marked
`cuda` need the card and skip without one; on a machine with a card they
run with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_push_kernel.py

(--noconftest: the suite's conftest imports jax, which this file does not
need).  This file imports torch only.
"""

import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ohm_tsd_slam_tpu_torch.config import GridConfig
from ohm_tsd_slam_tpu_torch.core import se2
from ohm_tsd_slam_tpu_torch.grid.dispatch import best_push
from ohm_tsd_slam_tpu_torch.grid.push import branch_gate, push, push_tree
from ohm_tsd_slam_tpu_torch.grid.state import create, to_arrays
from ohm_tsd_slam_tpu_torch.ops.kernel_check import PushCheck
from ohm_tsd_slam_tpu_torch.ops.push_cuda import push_cuda
from ohm_tsd_slam_tpu_torch.sensor import polar2d
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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = GridConfig(map_size=8, cellsize=0.04)       # 256^2, 32x32 tiles
CFG_NARROW = GridConfig(map_size=6, cellsize=0.16)  # 64^2, 2x2 tiles
GEOM = polar2d.SensorPolar2D(size=541, angular_res=math.radians(0.5),
                             phi_min=math.radians(-135.0), max_range=8.0,
                             min_range=0.01, low_reflectivity_range=1.0)
POSES = [(5.0, 5.0, 0.4), (5.3, 5.1, 0.5), (4.8, 5.2, 0.3)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    return torch.device("cuda")


def _scan(xyt, dtype, device):
    pose = se2.make(*xyt, dtype=torch.float64).numpy()
    r = simulate_scan(pose, GEOM.size, GEOM.angular_res, GEOM.phi_min,
                      GEOM.max_range, segments=rect_walls(1.0, 1.0, 9.0, 9.0),
                      circles=[((7.0, 7.2), 0.5)])
    data, mask = polar2d.standard_mask(
        GEOM, torch.as_tensor(r, dtype=dtype, device=device))
    return se2.make(*xyt, dtype=dtype, device=device), data, mask


def _compare(g_ref, g_ker):
    """The tolerances tests/test_push_pallas.py holds the Pallas kernel
    to: atan2f and torch.atan2 can move a cell whose bearing sits on a bin
    edge into the neighbouring beam, so under 5e-4 of the cells may differ
    in NaN pattern or by more than 1e-3."""
    a, b = to_arrays(g_ref), to_arrays(g_ker)
    nan_mism = np.isnan(a["tsd"]) != np.isnan(b["tsd"])
    assert nan_mism.mean() < 5e-4, nan_mism.sum()
    fin = ~np.isnan(a["tsd"]) & ~np.isnan(b["tsd"])
    d = np.abs(a["tsd"][fin] - b["tsd"][fin])
    if d.size:
        assert (d > 1e-3).mean() < 5e-4, (d > 1e-3).sum()
        assert np.median(d) < 1e-5
    np.testing.assert_allclose(a["weight"], b["weight"], atol=1e-2)
    np.testing.assert_array_equal(a["tile_init"], b["tile_init"])
    np.testing.assert_array_equal(a["tile_initw"], b["tile_initw"])


def test_cpu_dispatch_takes_plain_push():
    grid = create(CFG, dtype=torch.float32, device="cpu")
    assert best_push(grid) is push
    before = push_cuda.launches
    pose, data, mask = _scan(POSES[0], torch.float32, "cpu")
    want = push(grid, GEOM, pose, data, mask)
    got = push_cuda(grid, GEOM, pose, data, mask)   # CPU tensor: plain push
    assert push_cuda.launches == before
    got, want = to_arrays(got), to_arrays(want)
    for f in ("tsd", "weight", "tile_init", "tile_initw"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def test_cull_output_is_the_kernels_alone():
    """`cull` is written by the kernel; a CPU grid has none to write it."""
    grid = create(CFG, dtype=torch.float32, device="cpu")
    pose, data, mask = _scan(POSES[0], torch.float32, "cpu")
    with pytest.raises(ValueError, match="cull"):
        push_cuda(grid, GEOM, pose, data, mask,
                  cull=torch.empty((grid.tiles_y, grid.tiles_x, 3)))


def test_import_needs_no_compiler(tmp_path):
    env = dict(os.environ, PATH=str(tmp_path),
               CUDA_HOME=str(tmp_path / "none"))
    code = ("import ohm_tsd_slam_tpu_torch.ops.push_cuda as m, "
            "ohm_tsd_slam_tpu_torch.ops._build as b\n"
            "try:\n    b.find_nvcc()\nexcept RuntimeError as e:\n"
            "    print('no nvcc:', e)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("no nvcc:")


@pytest.mark.cuda
def test_cuda_float64_grid_raises(cuda_device):
    grid = create(CFG, dtype=torch.float64, device=cuda_device)
    pose, data, mask = _scan(POSES[0], torch.float64, cuda_device)
    assert best_push(grid) is push_cuda
    with pytest.raises(TypeError, match="float32"):
        push_cuda(grid, GEOM, pose, data, mask)


@pytest.mark.cuda
def test_kernel_matches_plain_push(cuda_device):
    g_ref = g_ker = create(CFG, dtype=torch.float32, device=cuda_device)
    before = push_cuda.launches
    for xyt in POSES:
        pose, data, mask = _scan(xyt, torch.float32, cuda_device)
        g_ref = push(g_ref, GEOM, pose, data, mask)
        g_ker = push_cuda(g_ker, GEOM, pose, data, mask)
        torch.cuda.synchronize()
    assert push_cuda.launches == before + len(POSES)
    _compare(g_ref, g_ker)
    assert np.isfinite(to_arrays(g_ker)["tsd"]).sum() > 1000


@pytest.mark.cuda
def test_kernel_matches_plain_push_on_the_room(cuda_device):
    """At the upstream configs' size (1024^2 cells of 0.025 m, 1081
    beams): three scans of the room into one grid through PushCheck, the
    grid against the plain push's within compare_push's bounds (the
    largest tsd gap within PUSH_TOL); a sensor outside the grid and an
    all-masked scan, which touch no tile."""
    geom = tc.geom_1081()
    grid0 = create(GridConfig(map_size=10, cellsize=0.025),
                   device=cuda_device)
    check = PushCheck()
    g_ref = g_ker = grid0
    for xyt in [(12.8, 12.8, 0.0), (13.1, 12.9, 0.3), (12.4, 13.2, -0.4)]:
        data, mask = polar2d.standard_mask(geom, torch.as_tensor(
            scan_ranges(xyt, geom.max_range), dtype=torch.float32,
            device=cuda_device))
        pose = se2.make(*xyt, device=cuda_device)
        g_ref = push(g_ref, geom, pose, data, mask)
        g_ker = check(g_ker, geom, pose, data, mask)
    assert tc.compare_push(g_ref, g_ker)["finite_cells"] > 100_000
    inf = torch.full((geom.size,), math.inf, device=cuda_device)
    none = torch.zeros(geom.size, dtype=torch.bool, device=cuda_device)
    for xyt in [(60.0, 60.0, 0.0), (12.8, 12.8, 0.0)]:
        pose = se2.make(*xyt, device=cuda_device)
        g_k = check(grid0, geom, pose, inf, none)
        tc.compare_push(push(grid0, geom, pose, inf, none), g_k)
        assert not bool(g_k.tile_init.any())


@pytest.mark.cuda
@pytest.mark.parametrize("xyt", [(50.0, 50.0, 0.0), (5.0, 5.0, 0.0)],
                         ids=["sensor_outside", "all_masked"])
def test_kernel_edge_cases(cuda_device, xyt):
    grid = create(CFG, dtype=torch.float32, device=cuda_device)
    pose = se2.make(*xyt, dtype=torch.float32, device=cuda_device)
    data = torch.full((GEOM.size,), math.inf, device=cuda_device)
    mask = torch.zeros(GEOM.size, dtype=torch.bool, device=cuda_device)
    g_ker = push_cuda(grid, GEOM, pose, data, mask)
    torch.cuda.synchronize()
    _compare(push(grid, GEOM, pose, data, mask), g_ker)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [CFG, CFG_NARROW], ids=["256", "64"])
def test_cull_matches_tile_cull(cuda_device, cfg):
    """The kernel's per-tile decisions (touch, empty_inc, part_weight) and
    its tile_init / tile_initw against grid/push.py::tile_cull and
    next_tile_initw, equal on every tile of every push (PushCheck raises
    otherwise); the old grid is not written; one launch a push and the
    pushed cells within the bounds of `_compare`."""
    check = PushCheck()
    g_ref = g_ker = create(cfg, dtype=torch.float32, device=cuda_device)
    before = push_cuda.launches
    for xyt in POSES + [(5.6, 4.7, 1.0), (50.0, 50.0, 0.0)]:
        pose, data, mask = _scan(xyt, torch.float32, cuda_device)
        old = {f: getattr(g_ker, f).clone()
               for f in ("tsd", "weight", "tile_init", "tile_initw")}
        g_new = check(g_ker, GEOM, pose, data, mask)
        g_ref = push(g_ref, GEOM, pose, data, mask)
        torch.cuda.synchronize()
        for f, t in old.items():
            assert torch.equal(torch.nan_to_num(getattr(g_ker, f), nan=-9.0),
                               torch.nan_to_num(t, nan=-9.0)), f
            assert getattr(g_new, f).data_ptr() != getattr(g_ker, f).data_ptr()
        g_ker = g_new
    assert push_cuda.launches == before + 5
    st = check.stats
    assert st["calls"] == 5 and st["touched"] > 0, st
    assert st["tiles"] == 5 * g_ker.tile_init.numel(), st
    assert st["touch_flips"] == st["empty_inc_flips"] == 0, st
    assert st["part_weight_max_abs_err"] == 0.0, st
    _compare(g_ref, g_ker)


@pytest.mark.cuda
def test_all_masked_scan_touches_no_tile(cuda_device):
    grid = create(CFG, dtype=torch.float32, device=cuda_device)
    pose = se2.make(5.0, 5.0, 0.0, dtype=torch.float32, device=cuda_device)
    data = torch.full((GEOM.size,), 3.0, device=cuda_device)
    mask = torch.zeros(GEOM.size, dtype=torch.bool, device=cuda_device)
    check = PushCheck()
    out = check(grid, GEOM, pose, data, mask)
    torch.cuda.synchronize()
    assert check.stats["touched"] == check.stats["emptied"] == 0
    assert not bool(out.tile_init.any())
    assert bool(torch.isnan(out.tsd).all()) and not bool(out.weight.any())


def _row_block(grid, ty0, tiles):
    """Tile rows [ty0, ty0 + tiles) of `grid` as a grid of its own (the
    rank's block of parallel/mesh.py::grid_sharding)."""
    import dataclasses

    p = grid.tile_dim
    rows = slice(ty0 * p, (ty0 + tiles) * p)
    return dataclasses.replace(
        grid, tsd=grid.tsd[rows].clone(), weight=grid.weight[rows].clone(),
        tile_init=grid.tile_init[ty0:ty0 + tiles].clone(),
        tile_initw=grid.tile_initw[ty0:ty0 + tiles].clone())


def _assert_rows_equal(block, whole, ty0):
    """The block's arrays equal the whole grid's rows in every bit."""
    p, tiles = whole.tile_dim, block.tiles_y
    for f, rows in (("tsd", p), ("weight", p), ("tile_init", 1),
                    ("tile_initw", 1)):
        want = getattr(whole, f)[ty0 * rows:(ty0 + tiles) * rows]
        got = getattr(block, f)
        assert got.cpu().numpy().tobytes() == want.cpu().numpy().tobytes(), f


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("ty0,tiles", [(0, 2), (3, 2), (6, 2), (2, 1)])
def test_plain_push_on_a_row_block(dtype, ty0, tiles):
    """A row block pushed with its first tile row `ty0` is the whole
    grid's push's rows, in every bit: the culls, the cells, the tiles."""
    grid = create(CFG, dtype=dtype, device="cpu")
    for xyt in POSES[:2]:
        pose, data, mask = _scan(xyt, dtype, "cpu")
        grid = push(grid, GEOM, pose, data, mask)
    pose, data, mask = _scan(POSES[2], dtype, "cpu")
    whole = push(grid, GEOM, pose, data, mask)
    block = push(_row_block(grid, ty0, tiles), GEOM, pose, data, mask,
                 ty0=ty0)
    _assert_rows_equal(block, whole, ty0)
    assert block.tiles_y == tiles


@pytest.mark.cuda
@pytest.mark.parametrize("ty0,tiles", [(0, 4), (4, 4), (3, 2), (7, 1)])
def test_kernel_on_a_row_block(cuda_device, ty0, tiles):
    """The kernel on a row block with its first tile row `ty0` equals the
    kernel's whole-grid push in those rows in every bit, and its cull
    equals tile_cull's on the block (PushCheck raises otherwise)."""
    check = PushCheck()
    grid = create(CFG, dtype=torch.float32, device=cuda_device)
    for xyt in POSES[:2]:
        pose, data, mask = _scan(xyt, torch.float32, cuda_device)
        grid = check(grid, GEOM, pose, data, mask)
    pose, data, mask = _scan(POSES[2], torch.float32, cuda_device)
    whole = check(grid, GEOM, pose, data, mask)
    block = check(_row_block(grid, ty0, tiles), GEOM, pose, data, mask,
                  ty0=ty0)
    torch.cuda.synchronize()
    _assert_rows_equal(block, whole, ty0)
    assert check.stats["touched"] > 0


def _assert_same_bits(a, b):
    for f in ("tsd", "weight", "tile_init", "tile_initw"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.cpu().numpy().tobytes() == y.cpu().numpy().tobytes(), f


SHORT = polar2d.SensorPolar2D(size=541, angular_res=math.radians(0.5),
                              phi_min=math.radians(-135.0), max_range=0.5,
                              min_range=0.01, low_reflectivity_range=1.0)
CFG_BIG = GridConfig(map_size=9, cellsize=0.05)    # 512^2, 16x16 tiles


@pytest.mark.cuda
@pytest.mark.parametrize("gate_kind", ["branch", "random", "short_range"])
def test_kernel_with_a_gate_matches_its_twin(cuda_device, gate_kind):
    """The kernel with a gate: its cull equals tile_cull & gate on every
    tile (PushCheck raises otherwise), one launch a push; with
    branch_gate's gate the grid equals the ungated kernel's in every bit
    (the gate is conservative), with a random one it differs."""
    check = PushCheck()
    rng = np.random.default_rng(5)
    if gate_kind == "short_range":
        cfg, geom = CFG_BIG, SHORT
        scans = [(se2.make(12.8, 12.8, 0.0, device=cuda_device),
                  torch.full((SHORT.size,), 0.3, device=cuda_device),
                  torch.ones(SHORT.size, dtype=torch.bool,
                             device=cuda_device))]
    else:
        cfg, geom = CFG, GEOM
        scans = [_scan(xyt, torch.float32, cuda_device) for xyt in POSES]
    g = g_flat = create(cfg, dtype=torch.float32, device=cuda_device)
    before = push_cuda.launches
    for pose, data, mask in scans:
        if gate_kind == "random":
            gate = torch.from_numpy(rng.random(g.tile_init.shape) < 0.6
                                    ).to(cuda_device)
        else:
            gate = branch_gate(g, geom, pose)
        g = check(g, geom, pose, data, mask, tile_gate=gate)
        g_flat = push_cuda(g_flat, geom, pose, data, mask)
    torch.cuda.synchronize()
    st = check.stats
    assert push_cuda.launches == before + 2 * len(scans)
    assert st["gated_calls"] == len(scans), st
    assert st["touch_flips"] == st["empty_inc_flips"] == 0, st
    if gate_kind == "random":
        assert not torch.equal(g.tile_init, g_flat.tile_init)
    else:
        _assert_same_bits(g, g_flat)
    if gate_kind == "short_range":
        assert st["pruned"] > 0 and st["touched"] > 0, st


@pytest.mark.cuda
def test_push_tree_launches_the_kernel(cuda_device):
    """push_tree on a card grid is one launch of the kernel with the gate,
    equal to the ungated launch in every bit; the wrapper refuses a gate
    that is not a bool tile array."""
    pose, data, mask = _scan(POSES[0], torch.float32, cuda_device)
    grid = create(CFG, dtype=torch.float32, device=cuda_device)
    before = push_cuda.launches
    out = push_tree(grid, GEOM, pose, data, mask)
    assert push_cuda.launches == before + 1
    _assert_same_bits(out, push_cuda(grid, GEOM, pose, data, mask))
    with pytest.raises(TypeError, match="tile_gate"):
        push_cuda(grid, GEOM, pose, data, mask,
                  tile_gate=torch.ones(grid.tile_init.shape,
                                       device=cuda_device))

