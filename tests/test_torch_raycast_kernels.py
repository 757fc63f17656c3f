"""The fast caster's CUDA kernels (ohm_tsd_slam_tpu_torch/csrc/
segment_layers.cu, pack_rows.cu, segment_min.cu, window_replay.cu,
compact_channels.cu) against their plain twins, through
ops/kernel_check.py.

On the CPU the wrappers run the twins, so the check compares a twin with
itself and exercises only its own code; importing the wrappers needs no
compiler.  Tests marked `cuda` need the card and skip without one; on a
machine with a card they run with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_raycast_kernels.py

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

import ohm_tsd_slam_tpu_torch.grid.raycast_fast as rf
from ohm_tsd_slam_tpu_torch.config import GridConfig
from ohm_tsd_slam_tpu_torch.core import se2
from ohm_tsd_slam_tpu_torch.grid.push import push
from ohm_tsd_slam_tpu_torch.grid.raycast import raycast
from ohm_tsd_slam_tpu_torch.grid.state import create, from_arrays
from ohm_tsd_slam_tpu_torch.ops.kernel_check import KernelCheck
from ohm_tsd_slam_tpu_torch.sensor import polar2d
from ohm_tsd_slam_tpu_torch.utils.testing import (
    field_arrays,
    noise_field,
    rect_walls,
    simulate_scan,
    sliver_field,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = GridConfig(map_size=8, cellsize=0.04)       # 256^2, 32x32 tiles
GEOM = polar2d.SensorPolar2D(size=541, angular_res=math.radians(0.5),
                             phi_min=math.radians(-135.0), max_range=8.0,
                             min_range=0.01, low_reflectivity_range=1.0)
POSES = [(5.0, 5.0, 0.4), (5.3, 5.1, 0.5), (4.8, 5.2, 0.3)]
MODULES = ("segment_layers_cuda", "pack_rows_cuda", "segment_min_cuda",
           "window_replay_cuda", "compact_channels_cuda")
CFG_NARROW = GridConfig(map_size=6, cellsize=0.16)  # 64^2: general route


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    return torch.device("cuda")


def _room(device, cfg=CFG):
    g = create(cfg, dtype=torch.float32, device=device)
    for xyt in POSES:
        pose = se2.make(*xyt, dtype=torch.float64).numpy()
        r = simulate_scan(pose, GEOM.size, GEOM.angular_res, GEOM.phi_min,
                          GEOM.max_range,
                          segments=rect_walls(1.0, 1.0, 9.0, 9.0),
                          circles=[((7.0, 7.2), 0.5)])
        data, mask = polar2d.standard_mask(
            GEOM, torch.as_tensor(r, dtype=torch.float32, device=device))
        g = push(g, GEOM, se2.make(*xyt, device=device), data, mask)
    return g


def _field(name, device):
    f = {"sliver": lambda: sliver_field(256, 100, 140),
         "noise": lambda: noise_field(256, seed=1)}[name]()
    return from_arrays(field_arrays(f.astype(np.float32), 0.04),
                       device=device)


def _check(grid, xyt, max_segments=None):
    """The caster under the check, and the exact march's result."""
    check = KernelCheck()
    seg = rf.extract_segments(grid, max_segments, kernels=check.kernels)
    pose = se2.make(*xyt, device=grid.tsd.device)
    res = rf.raycast_fast(grid, GEOM, pose, segments=seg,
                          kernels=check.kernels)
    return check, seg, res, raycast(grid, GEOM, pose)


def _assert_agrees_with_exact(res, exact):
    """tests/test_raycast_fast.py's bound: over 98% of beams agree."""
    m, me = res.mask, exact.mask
    assert (m == me).float().mean() > 0.98
    both = m & me
    gap = (res.coords[both] - exact.coords[both]).abs()
    assert not gap.numel() or gap.max() < 1e-4


@pytest.mark.parametrize("cfg,extraction", [
    (CFG, ("segment_layers", "pack_rows")),
    (CFG_NARROW, ("compact_channels",))], ids=["fused", "general"])
def test_cpu_check_runs_the_twins(cfg, extraction):
    """On the CPU every member of the check is a twin against itself; the
    grid's width chooses the extraction's kernels (A and B, or E)."""
    grid = _room("cpu", cfg)
    check, _, res, exact = _check(grid, POSES[0])
    ran = {name for name, st in check.stats.items() if st["calls"]}
    assert ran == {"segment_min", "window_replay", "window_rounds",
                   *extraction}
    for name, st in check.stats.items():
        assert st["max_abs_err"] == 0.0, (name, st)
    assert check.stats["segment_min"]["calls"] == 2          # K=1, K=3
    assert check.stats["window_replay"]["calls"] == 1        # round 1
    assert check.stats["window_rounds"]["calls"] == 1        # rounds 2..4
    assert int(res.n_dropped) == 0 and res.mask.sum() > 300
    _assert_agrees_with_exact(res, exact)


def test_import_needs_no_compiler(tmp_path):
    env = dict(os.environ, PATH=str(tmp_path),
               CUDA_HOME=str(tmp_path / "none"))
    code = "".join(f"import ohm_tsd_slam_tpu_torch.ops.{m}\n"
                   for m in MODULES + ("kernel_check",))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.cuda
def test_kernels_match_twins_on_a_room(cuda_device):
    grid = _room(cuda_device)
    for xyt in POSES + [(50.0, 50.0, 0.0)]:
        check, _, res, exact = _check(grid, xyt)
        torch.cuda.synchronize()
        ran = {name for name, st in check.stats.items() if st["calls"]}
        assert ran == set(check.stats) - {"compact_channels"}  # 256 wide
        assert int(res.n_dropped) == 0
        _assert_agrees_with_exact(res, exact)
    assert not res.mask.any()                    # the sensor outside


@pytest.mark.cuda
def test_general_extraction_on_a_narrow_grid(cuda_device):
    """A float32 grid 64 cells wide on the card: kernel E behind the dense
    layers, equal to its twin, launched once, A and B not at all."""
    from ohm_tsd_slam_tpu_torch.ops.compact_channels_cuda import (
        compact_channels,
    )
    from ohm_tsd_slam_tpu_torch.ops.segment_layers_cuda import segment_layers

    grid = _room(cuda_device, CFG_NARROW)
    before = compact_channels.launches, segment_layers.launches
    check, seg, res, exact = _check(grid, POSES[0])
    torch.cuda.synchronize()
    assert compact_channels.launches == before[0] + 1
    assert segment_layers.launches == before[1]
    assert check.stats["compact_channels"] == {"calls": 1,
                                               "max_abs_err": 0.0}
    assert int(seg.count) > 50 and int(res.n_dropped) == 0
    _assert_agrees_with_exact(res, exact)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["sparse", "overflow", "empty", "full",
                                  "special", "float_mask"])
def test_compact_channels_kernel_matches_twin(cuda_device, case):
    """Kernel E against grid/compact.py::pack_channels_rows in every bit:
    order, zeros after the last set lane, the count of all set lanes past
    the capacity, NaN and Inf at set and unset lanes, a float 0/1 mask,
    n = 16384."""
    from ohm_tsd_slam_tpu_torch.grid.compact import pack_channels_rows
    from ohm_tsd_slam_tpu_torch.ops.compact_channels_cuda import (
        compact_channels,
    )

    rng = np.random.default_rng(4)
    n, size = 16384, 256
    density = {"sparse": 0.01, "overflow": 0.3, "empty": 0.0, "full": 1.0,
               "special": 0.02, "float_mask": 0.01}[case]
    mask = rng.random(n) < density
    chans = [rng.normal(size=n).astype(np.float32) for _ in range(4)]
    if case == "special":
        for c, v in zip(chans, (np.nan, np.inf, -np.inf, np.nan)):
            c[rng.choice(n, 400, replace=False)] = v
    m = torch.from_numpy(mask).to(cuda_device)
    if case == "float_mask":
        m = m.float()
    cs = tuple(torch.from_numpy(c).to(cuda_device) for c in chans)
    got, cnt = compact_channels(m, cs, size)
    want, wcnt = pack_channels_rows(m, cs, size)
    torch.cuda.synchronize()
    assert int(cnt) == int(wcnt) == int(mask.sum())
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    with pytest.raises(TypeError, match="float32"):
        compact_channels(m, tuple(c.double() for c in cs), size)
    with pytest.raises(ValueError, match="multiples"):
        compact_channels(m[:100], tuple(c[:100] for c in cs), size)


@pytest.mark.cuda
def test_kernels_match_twins_in_the_rounds(cuda_device):
    """The sliver field: beams that step over it resolve in the later
    rounds, so kernel D runs on the compacted slots with events there."""
    grid = _field("sliver", cuda_device)
    check, _, res, exact = _check(grid, (2.0, 5.12, 0.3))
    torch.cuda.synchronize()
    assert check.stats["window_replay"]["calls"] == 1
    assert check.stats["window_rounds"]["calls"] == 1
    new_hits = [f["new_hits"] for n, _, f in check.log
                if n == "window_rounds"]
    assert new_hits[0] > 10                      # hits found in the rounds
    assert torch.equal(res.mask, exact.mask)
    x = se2.transform_points(se2.make(2.0, 5.12, 0.3, device=cuda_device),
                             res.coords)[:, 0]
    assert int((res.mask & (x > 5.0)).sum()) > 10            # the wall


@pytest.mark.cuda
def test_kernels_count_an_overflow(cuda_device):
    """Noise: more segments than the capacity; B counts the drops."""
    grid = _field("noise", cuda_device)
    check, seg, res, _ = _check(grid, (5.0, 5.0, 0.0), max_segments=4096)
    torch.cuda.synchronize()
    assert int(seg.n_dropped) > 0 and int(res.n_dropped) > 0
    assert check.stats["pack_rows"]["max_abs_err"] == 0.0


@pytest.mark.cuda
def test_empty_grid(cuda_device):
    grid = create(CFG, dtype=torch.float32, device=cuda_device)
    _, seg, res, _ = _check(grid, POSES[0])
    assert int(seg.count) == 0 and not res.mask.any()


def test_flag_change_names_a_new_library(monkeypatch):
    """A library is keyed on its nvcc flags: after a change of flags the
    kernel is built anew, never loaded from a library built without."""
    from ohm_tsd_slam_tpu_torch.ops import _build

    before = {n: _build.lib_path(n)
              for n in ("push", "compact_channels", *_build.KERNEL_FLAGS)}
    assert len(set(before.values())) == len(before)
    monkeypatch.setitem(_build.KERNEL_FLAGS, "segment_min",
                        ["-fmad=true"])
    assert _build.lib_path("segment_min") != before["segment_min"]
    assert _build.lib_path("window_replay") == before["window_replay"]
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-G"])
    assert _build.lib_path("push") != before["push"]
    assert _build.lib_path("window_replay") != before["window_replay"]


@pytest.mark.cuda
def test_float64_cuda_grid_raises(cuda_device):
    """The kernels are float32 only, and a CUDA grid never reaches a twin:
    the fast caster raises on a float64 grid on the card."""
    grid = create(CFG, dtype=torch.float64, device=cuda_device)
    pose = se2.make(*POSES[0], dtype=torch.float64, device=cuda_device)
    with pytest.raises(TypeError, match="float32"):
        rf.raycast_fast(grid, GEOM, pose)
    with pytest.raises(TypeError, match="float32"):
        rf.extract_segments(grid)
