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
    fence_segments,
    field_arrays,
    limit_cpu_threads,
    noise_field,
    rect_walls,
    simulate_scan,
    sliver_field,
)

limit_cpu_threads()

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
    assert check.stats["segment_min"]["calls"] == 1          # K=ROUNDS
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


def _pose_batch(xyt, n, device):
    """n poses spread about xyt as bench.py spreads its 128: xyt composed
    with (d, -d, 2d) for d in linspace(-0.05, 0.05, n)."""
    base = se2.make(*xyt, device=device)
    return torch.stack([base @ se2.make(d, -d, 2.0 * d, device=device)
                        for d in np.linspace(-0.05, 0.05, n).tolist()])


@pytest.mark.cuda
def test_pose_batch_kernels_match_twins(cuda_device):
    """raycast_fast_batch at P = 128 (138,368 beams: the rounds take the
    cooperative launch): C, D and D's rounds launched once each and equal
    to their twins, and every pose's rows equal, bit for bit, to its own
    raycast_fast."""
    from ohm_tsd_slam_tpu_torch.ops.segment_min_cuda import segment_min
    from ohm_tsd_slam_tpu_torch.ops.window_replay_cuda import (
        window_replay,
        window_rounds,
    )

    grid = _room(cuda_device)
    geom = polar2d.SensorPolar2D(size=1081, angular_res=math.radians(0.25),
                                 phi_min=math.radians(-135.0), max_range=8.0,
                                 min_range=0.01)
    poses = _pose_batch(POSES[0], 128, cuda_device)
    check = KernelCheck()
    seg = rf.extract_segments(grid, kernels=check.kernels)
    before = (segment_min.launches, window_replay.launches,
              window_rounds.launches)
    batch = rf.raycast_fast_batch(grid, geom, poses, segments=seg,
                                  kernels=check.kernels)
    torch.cuda.synchronize()
    assert (segment_min.launches, window_replay.launches,
            window_rounds.launches) == tuple(n + 1 for n in before)
    for name in ("segment_min", "window_replay", "window_rounds"):
        assert check.stats[name] == {"calls": 1, "max_abs_err": 0.0}, name
    assert int(batch.n_dropped) == 0
    assert int(batch.mask.sum()) > 128 * 900
    for p in range(poses.shape[0]):
        single = rf.raycast_fast(grid, geom, poses[p], segments=seg)
        for name in ("coords", "normals", "mask", "ranges"):
            assert torch.equal(getattr(batch, name)[p],
                               getattr(single, name)), (p, name)


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


def _halo_block(tsd, y0, h, halo):
    """Rows [y0 - halo, y0 + h + halo) of the field, NaN past the grid, as
    parallel/shard_raycast.py::_halo_exchange builds a rank's block."""
    H, W = tsd.shape
    pad = torch.full((halo, W), math.nan, dtype=tsd.dtype, device=tsd.device)
    below = tsd[y0 - halo:y0] if y0 > 0 else pad
    above = tsd[y0 + h:y0 + h + halo] if y0 + h < H else pad
    return torch.cat([below, tsd[y0:y0 + h], above])


@pytest.mark.cuda
@pytest.mark.parametrize("rank", [0, 1, 3])
def test_window_replay_on_a_row_block_matches_twin(cuda_device, rank):
    """Kernel D on a rank's halo'd block of the room (sp = 4, row0 = y0 -
    HALO, the owned beams active) against its twin at max_abs_err 0; the
    whole grid as the block of one rank (NaN rows past both edges, row0 =
    -HALO) replays as the whole grid with row0 = 0, and row0 = 0 as the
    call without it, in every bit."""
    from ohm_tsd_slam_tpu_torch.ops.window_replay_cuda import window_replay
    from ohm_tsd_slam_tpu_torch.parallel.shard_raycast import (
        HALO,
        _field_grid,
    )

    grid = _room(cuda_device)
    s = grid.cell_size
    geom = polar2d.SensorPolar2D(size=1081, angular_res=math.radians(0.25),
                                 phi_min=math.radians(-135.0), max_range=8.0,
                                 min_range=0.01)
    pose = se2.make(*POSES[1], device=cuda_device)
    ray, tr, idx_min, idx_max, feasible = rf.beam_geometry(grid, geom, pose)
    seg = rf.extract_segments(grid)
    lo = (torch.floor(idx_min) - 1.0).clamp(min=0.0)
    t_1 = rf.segment_min_plain(seg.pack, seg.count, ray, lo,
                               torch.ceil(idx_max) + 1.0, lo,
                               tr - seg.origin)[:, 0]
    has = torch.isfinite(t_1) & feasible
    k = torch.where(has, t_1, 0.0)
    H = grid.tsd.shape[0]
    h = H // 4
    y0 = rank * h
    row_c = (tr[1] + k * ray[:, 1]) / s - 0.5
    owner = has & (row_c >= y0) & (row_c < y0 + h)
    check = KernelCheck()
    block = _field_grid(_halo_block(grid.tsd, y0, h, HALO), s)
    out = check.kernels.window_replay(block, k, ray, idx_min, idx_max, owner,
                                      tr, row0=y0 - HALO)
    torch.cuda.synchronize()
    assert check.stats["window_replay"] == {"calls": 1, "max_abs_err": 0.0}
    assert int((out[:, 0] > 0).sum()) > 50
    assert not out[~owner].any()

    def bits(t):
        return t.view(torch.int32)

    whole = window_replay(grid, k, ray, idx_min, idx_max, has, tr)
    assert torch.equal(bits(whole), bits(window_replay(
        grid, k, ray, idx_min, idx_max, has, tr, row0=0)))
    world1 = _field_grid(_halo_block(grid.tsd, 0, H, HALO), s)
    assert torch.equal(bits(whole), bits(window_replay(
        world1, k, ray, idx_min, idx_max, has, tr, row0=-HALO)))


@pytest.mark.cuda
@pytest.mark.parametrize("mask_kind", ["bool", "float", "bool_offset"])
@pytest.mark.parametrize("n", [16384, 32768, 32896, 4194304])
def test_compact_channels_one_and_many_tiles(cuda_device, n, mask_kind):
    """Kernel E's one-tile path (up to 32,768 lanes: no ticket, no status
    word) and its look-back over tiles (32,896 lanes: a second tile of one
    row; 4 Mi lanes: 128 tiles) against its twin in every bit, with a
    capacity below the count (drops counted), NaN and Inf channels at set
    and unset lanes, a bool mask, a float mask and a bool mask off 16
    bytes (the wrapper copies it: the kernel reads 16 bytes at a time)."""
    from ohm_tsd_slam_tpu_torch.grid.compact import pack_channels_rows
    from ohm_tsd_slam_tpu_torch.ops.compact_channels_cuda import (
        compact_channels,
    )

    rng = np.random.default_rng(n)
    mask = rng.random(n) < 0.05
    size = max(128, (int(mask.sum()) * 3 // 4) // 128 * 128)
    assert size < mask.sum()
    chans = [rng.normal(size=n).astype(np.float32) for _ in range(4)]
    for c, v in zip(chans, (np.nan, np.inf, -np.inf, np.nan)):
        c[rng.choice(n, n // 50, replace=False)] = v
    m = torch.from_numpy(mask).to(cuda_device)
    if mask_kind == "float":
        m = m.float()
    if mask_kind == "bool_offset":
        m = torch.cat([m[:1], m])[1:]
        assert m.data_ptr() % 16 != 0
    cs = tuple(torch.from_numpy(c).to(cuda_device) for c in chans)
    before = compact_channels.launches
    got, cnt = compact_channels(m, cs, size)
    want, wcnt = pack_channels_rows(m, cs, size)
    torch.cuda.synchronize()
    assert compact_channels.launches == before + 1
    assert int(cnt) == int(wcnt) == int(mask.sum())
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


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


def _sweep_inputs(grid, n_beams=1081):
    """Kernel C's arguments as the caster gives them, for `n_beams` beams
    from POSES[0]: (pack, count, ray, lo, hi, t_after, tr_pack)."""
    geom = polar2d.SensorPolar2D(
        size=n_beams, angular_res=math.radians(270.0) / n_beams,
        phi_min=math.radians(-135.0), max_range=8.0, min_range=0.01)
    seg = rf.extract_segments(grid)
    pose = se2.make(*POSES[0], device=grid.tsd.device)
    ray, tr, idx_min, idx_max, _ = rf.beam_geometry(grid, geom, pose)
    lo = (torch.floor(idx_min) - 1.0).clamp(min=0.0)
    hi = torch.ceil(idx_max) + 1.0
    return (seg.pack, seg.count, ray, lo, hi, lo,
            (tr - seg.origin).contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [1, 3, 4])
@pytest.mark.parametrize("case", ["room", "full_pack", "no_segments",
                                  "all_resolved", "fence"])
def test_segment_min_kernel_matches_twin(cuda_device, case, levels):
    """Kernel C, one launch for every level, against its twin in every
    value: a room; the noise field's full pack (32768 segments); a count
    of 0; every beam resolved (t_after = +inf); a fence of 4096 segments
    that the forward beams cross one and all (more candidates than a beam
    keeps in shared memory, so its later levels compute every pair anew)
    and the slanted beams in part."""
    from ohm_tsd_slam_tpu_torch.ops.segment_min_cuda import segment_min

    grid = (_field("noise", cuda_device) if case == "full_pack"
            else _room(cuda_device))
    pack, count, ray, lo, hi, t_after, tr = _sweep_inputs(grid)
    if case == "fence":
        x, y = (float(v) for v in tr)
        p0, p1 = (torch.as_tensor(p, dtype=torch.float32, device=cuda_device)
                  for p in fence_segments(4096, x + 0.5, y))
        pack, count = rf.pack_segments(
            p0, p1, torch.ones(4096, dtype=torch.bool, device=cuda_device))
    if case == "full_pack":
        assert int(count) == rf.MAX_SEGMENTS
    elif case == "no_segments":
        count = torch.zeros_like(count)
    elif case == "all_resolved":
        t_after = torch.full_like(lo, math.inf)
    args = (pack, count, ray, lo, hi, t_after, tr, levels, rf.COVER)
    before = segment_min.launches
    got = segment_min(*args)
    torch.cuda.synchronize()
    assert segment_min.launches == before + 1
    want = rf.segment_min_plain(*args)
    assert got.shape == want.shape == (ray.shape[0], levels)
    assert torch.equal(got, want)                 # max_abs_err 0
    if case in ("room", "full_pack", "fence"):
        assert int(torch.isfinite(got[:, 0]).sum()) > 300
    else:
        assert not torch.isfinite(got).any()
    with pytest.raises(TypeError, match="float32"):
        segment_min(pack.double(), *args[1:])


def test_fence_overflows_a_beams_candidates():
    """The premise of the fence case above, from the twin on the CPU: the
    forward beams find a candidate in every level, spaced by COVER, among
    4096 crossings, and the slanted ones cross a part or none."""
    pack, count, ray, lo, hi, t_after, tr = _sweep_inputs(
        _room(torch.device("cpu")), n_beams=91)
    p0, p1 = (torch.as_tensor(p, dtype=ray.dtype)
              for p in fence_segments(4096, float(tr[0]) + 0.5, float(tr[1])))
    pack, count = rf.pack_segments(p0, p1, torch.ones(4096, dtype=torch.bool))
    assert int(count) == 4096
    # a beam crosses the fence where a sweep from the start finds a candidate
    crossed = torch.isfinite(rf.segment_min_plain(
        pack, count, ray, lo, hi, t_after, tr, 1, 0.0))[:, 0]
    ex, p0x = pack[0:1], pack[2:3]
    t_far = rf.segment_min_plain(pack, count, ray, lo, hi,
                                 torch.full_like(lo, 1e9), tr)
    assert not torch.isfinite(t_far).any()
    lev = rf.segment_min_plain(pack, count, ray, lo, hi, t_after, tr,
                               rf.ROUNDS, rf.COVER)
    full = torch.isfinite(lev).all(1)
    assert 10 < int(full.sum()) < 91 and int((~crossed).sum()) > 10
    assert bool((lev[full].diff(dim=1) >= rf.COVER).all())
    assert ex.abs().max() == 0.0 and float(p0x.max() - p0x.min()) > 4.0


def test_pack_rows_launch_rejects_an_odd_capacity():
    """The status words lie behind the pack on 8 bytes: `launch` names the
    constraint before it reaches the kernel (the wrapper's capacities,
    multiples of 128, always meet it)."""
    from ohm_tsd_slam_tpu_torch.ops import pack_rows_cuda

    grid = _room(torch.device("cpu"))
    buf = torch.empty((7, 129))
    with pytest.raises(ValueError, match="even capacity"):
        pack_rows_cuda.launch(grid, None, None, buf, None)
    assert pack_rows_cuda.empty_pack("cpu", 2048, 256).shape[1] % 2 == 0


def _layers(grid):
    from ohm_tsd_slam_tpu_torch.ops.segment_layers_cuda import segment_layers

    return segment_layers(grid)


@pytest.mark.cuda
@pytest.mark.parametrize("cells,field,size", [
    (1024, "room", 32768), (2048, "room", 32768), (2048, "noise", 32768),
    (1024, "noise", 4096), (1024, "empty", 32768), (256, "room", 128)],
    ids=["1024", "2048", "2048_overflow", "1024_overflow", "empty",
         "small_pack_large_scratch"])
def test_pack_rows_kernel_matches_twin(cuda_device, cells, field, size):
    """Kernel B (the prefix by look-back inside the pack kernel) against
    its twin bit for bit: at 128 tiles, at 512 tiles (more than are
    resident at once), on fields whose segments overflow the pack (the
    counts equal), on an empty field, and with a pack smaller than the
    prefix's scratch; 200 launches on one input give the same bits."""
    from ohm_tsd_slam_tpu_torch.ops.pack_rows_cuda import pack_rows

    rng = np.random.default_rng(11)
    if field == "noise":
        f = noise_field(cells, seed=5)
    elif field == "empty":
        f = np.full((cells, cells), np.nan)
    else:
        # walls and scattered blobs: segments all over the row axis
        f = sliver_field(cells, cells // 3, cells // 2)
        for _ in range(40):
            y, x = rng.integers(8, cells - 8, 2)
            f[y - 2:y + 3, x - 2:x + 3] = -0.2
    grid = from_arrays(field_arrays(f.astype(np.float32), 0.025),
                       device=cuda_device)
    mask, row_cnt = _layers(grid)
    want, want_total = rf.pack_rows_plain(grid, mask, size)
    before = pack_rows.launches
    got, total = pack_rows(grid, mask, row_cnt, size)
    torch.cuda.synchronize()
    assert pack_rows.launches == before + 1
    assert int(total) == int(want_total) == int(mask.sum())
    assert got.shape == want.shape == (5, size + 128)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if field == "empty":
        assert int(total) == 0
    elif "noise" in field or size == 128:
        assert int(total) > size + 128               # dropped, and counted
    else:
        assert 100 < int(total) <= size
    for _ in range(200):
        again, again_total = pack_rows(grid, mask, row_cnt, size)
        assert torch.equal(again.view(torch.int32), got.view(torch.int32))
        assert int(again_total) == int(total)


@pytest.mark.cuda
def test_compact_channels_kernel_at_many_tiles(cuda_device):
    """Kernel E with the shared prefix at 4 Mi lanes (128 tiles) and 16 Mi
    lanes (512 tiles), 200 launches each: every bit equal to the twin."""
    from ohm_tsd_slam_tpu_torch.grid.compact import pack_channels_rows
    from ohm_tsd_slam_tpu_torch.ops.compact_channels_cuda import (
        compact_channels,
    )

    rng = np.random.default_rng(12)
    for n in (1 << 22, 1 << 24):
        m = torch.from_numpy(rng.random(n) < 0.001).to(cuda_device)
        cs = tuple(torch.from_numpy(rng.normal(size=n).astype(np.float32))
                   .to(cuda_device) for _ in range(2))
        want, wcnt = pack_channels_rows(m, cs, 32768)
        for _ in range(200):
            got, cnt = compact_channels(m, cs, 32768)
            assert int(cnt) == int(wcnt)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_empty_grid(cuda_device):
    grid = create(CFG, dtype=torch.float32, device=cuda_device)
    _, seg, res, _ = _check(grid, POSES[0])
    assert int(seg.count) == 0 and not res.mask.any()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["push", "window_replay", "segment_min",
                                  "pack_rows", "compact_channels",
                                  "assign_pairs", "nearest_model"])
def test_kernel_has_no_stack_frame_or_spill(cuda_device, name):
    """ptxas's report of csrc/<name>.cu built with its flags: no kernel of
    it indexes a local array at run time or spills."""
    from ohm_tsd_slam_tpu_torch.ops import _build

    frames = [line for line in _build.resource_usage(name)
              if "stack frame" in line]
    assert frames and all(f.startswith("0 bytes stack frame, 0 bytes spill "
                                       "stores") for f in frames), frames


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
