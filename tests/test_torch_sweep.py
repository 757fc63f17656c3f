"""The port's fast caster sweeps the candidates once a scan
(ohm_tsd_slam_tpu_torch/grid/raycast_fast.py::_core: kernel C at K=ROUNDS
from the march's start), where the JAX package sweeps twice (K=1 for every
beam, then K=ROUNDS-1 from `max(lo, t_1 + COVER)` for the beams round 1
left unresolved).  These tests hold the one sweep against the two-call
pattern, kept here as `_core_two_sweeps`, on the twins on the CPU: every
output equal in every value.  Inputs are made from numpy with a seed
(simulated scans, synthetic fields).  The whole caster is held against JAX
in tests/test_torch_raycast_fast.py.  This file imports torch only.
"""

import math

import numpy as np
import pytest
import torch

import ohm_tsd_slam_tpu_torch.grid.raycast_fast as rf
from ohm_tsd_slam_tpu_torch.config import GridConfig
from ohm_tsd_slam_tpu_torch.core import se2
from ohm_tsd_slam_tpu_torch.grid.compact import pack_channels_rows
from ohm_tsd_slam_tpu_torch.grid.push import push
from ohm_tsd_slam_tpu_torch.grid.state import create, from_arrays
from ohm_tsd_slam_tpu_torch.sensor import polar2d
from ohm_tsd_slam_tpu_torch.utils.testing import (
    field_arrays,
    limit_cpu_threads,
    rect_walls,
    simulate_scan,
    sliver_field,
)

limit_cpu_threads()

TWINS = rf.CasterKernels(
    rf.segment_layers_plain,
    lambda g, m, rows, size: rf.pack_rows_plain(g, m, size),
    rf.segment_min_plain, rf.window_replay_plain, pack_channels_rows,
    rf.window_rounds_plain)
DTYPES = [torch.float64, torch.float32]
DTYPE_IDS = ["float64", "float32"]
SCENES = {"room": (5.0, 5.0, 0.4), "sliver": (2.0, 5.12, 0.3)}


def _geom(n_beams):
    return polar2d.SensorPolar2D(
        size=n_beams, angular_res=math.radians(270.0) / n_beams,
        phi_min=math.radians(-135.0), max_range=9.0, min_range=0.01)


def _grid(scene, dtype):
    """room: three simulated scans of a walled room with a pillar, pushed
    into a 256^2 grid.  sliver: three slivers thinner than a march step in
    front of a wall, so that a beam can step over one after the other and
    rounds 2, 3 and 4 all find work."""
    if scene == "sliver":
        f = sliver_field(256, 100, 140, rows=(112, 144))
        f[112:144, 115] = -0.2
        f[112:144, 128] = -0.2
        np_dtype = np.float32 if dtype == torch.float32 else np.float64
        return from_arrays(field_arrays(f.astype(np_dtype), 0.04))
    geom = polar2d.SensorPolar2D(
        size=541, angular_res=math.radians(0.5),
        phi_min=math.radians(-135.0), max_range=8.0, min_range=0.01,
        low_reflectivity_range=1.0)
    g = create(GridConfig(map_size=8, cellsize=0.04), dtype=dtype,
               device="cpu")
    for xyt in [(5.0, 5.0, 0.4), (5.3, 5.1, 0.5), (4.8, 5.2, 0.3)]:
        r = simulate_scan(se2.make(*xyt, dtype=torch.float64).numpy(),
                          geom.size, geom.angular_res, geom.phi_min,
                          geom.max_range,
                          segments=rect_walls(1.0, 1.0, 9.0, 9.0),
                          circles=[((7.0, 7.2), 0.5)])
        data, mask = polar2d.standard_mask(geom,
                                           torch.as_tensor(r, dtype=dtype))
        g = push(g, geom, se2.make(*xyt, dtype=dtype), data, mask)
    return g


def _core_two_sweeps(grid, segments, ray, tr, idx_min, idx_max, feasible,
                     n_dropped, ks):
    """The call pattern of the JAX package's TPU path, which _core ran
    before it swept once: C at K=1, D for every beam, C at K=ROUNDS-1 from
    t_after for the unresolved beams, D's rounds."""
    N = ray.shape[0]
    lo = (torch.floor(idx_min) - 1.0).clamp(min=0.0)
    hi = torch.ceil(idx_max) + 1.0
    tr_pack = tr - segments.origin
    t_1 = ks.segment_min(segments.pack, segments.count, ray, lo, hi, lo,
                         tr_pack)[:, 0]
    has = torch.isfinite(t_1) & feasible
    k_1 = torch.where(has, t_1, 0.0)
    S = ks.window_replay(grid, k_1, ray, idx_min, idx_max, has, tr)
    resolved = (S[:, 1] > 0.0) | ~has
    S[:, 1] = resolved.to(S.dtype)
    t_after = torch.where(resolved, math.inf,
                          torch.maximum(lo, k_1 + rf.COVER))
    lev = ks.segment_min(segments.pack, segments.count, ray, lo, hi,
                         t_after, tr_pack, levels=rf.ROUNDS - 1,
                         cover=rf.COVER)
    S, dropped = ks.window_rounds(grid, S, lev, ray, idx_min, idx_max, tr,
                                  rf.unresolved_cap(N))
    hit = S[:, 0] > 0.0
    coords_w = S[:, 2:4] + ray * (S[:, 4:5] - 1.0)
    return (coords_w, S[:, 5:7], hit, S[:, 7] > 0.0, n_dropped + dropped,
            resolved, t_after, lev)


def _inputs(scene, dtype, n_beams):
    grid = _grid(scene, dtype)
    seg = rf.extract_segments(grid, kernels=TWINS)
    pose = se2.make(*SCENES[scene], dtype=dtype)
    beams = rf.beam_geometry(grid, _geom(n_beams), pose)
    return grid, seg, beams


def _assert_same(got, want):
    """coords, normals, hit, n_ok and n_dropped equal in every value (NaN
    where the other has NaN)."""
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("n_beams", [1081, 1300, 361])
@pytest.mark.parametrize("scene", list(SCENES))
def test_one_sweep_equals_two_sweeps(scene, n_beams, dtype):
    grid, seg, beams = _inputs(scene, dtype, n_beams)
    zero = torch.zeros((), dtype=torch.int64)
    calls = []
    ks = TWINS._replace(segment_min=lambda *a, **k: calls.append(
        k.get("levels", 1)) or rf.segment_min_plain(*a, **k))
    got = rf._core(grid, seg, *beams, zero, ks)
    assert calls == [rf.ROUNDS]                  # one sweep, every level
    want = _core_two_sweeps(grid, seg, *beams, zero, TWINS)
    _assert_same(got, want[:5])
    assert int(got[4]) == 0 and int(got[2].sum()) > n_beams // 4
    needing = int(torch.isfinite(want[7][:, 0]).sum())
    if scene == "sliver":
        # beams step over the slivers: the later rounds have work (108
        # of 1081 beams need round 2)
        assert needing > n_beams // 30, needing


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_one_sweep_equals_two_sweeps_at_capacity(monkeypatch, dtype):
    """More needing beams than replays a round: the rows and the drop
    count are those of the two-call pattern."""
    monkeypatch.setattr(rf, "unresolved_cap", lambda n: 4)
    grid, seg, beams = _inputs("sliver", dtype, 1081)
    zero = torch.zeros((), dtype=torch.int64)
    got = rf._core(grid, seg, *beams, zero, TWINS)
    want = _core_two_sweeps(grid, seg, *beams, zero, TWINS)
    _assert_same(got, want[:5])
    assert int(got[4]) > 100                     # 108 need round 2, 4 replay


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("scene", list(SCENES))
def test_later_levels_are_the_second_sweep(scene, dtype):
    """Levels 1.. of one K=ROUNDS sweep from the march's start equal the
    K=ROUNDS-1 sweep from t_after on every unresolved beam; on a resolved
    beam the second sweep finds nothing and the rounds read nothing."""
    grid, seg, beams = _inputs(scene, dtype, 1081)
    ray, tr, idx_min, idx_max, _ = beams
    zero = torch.zeros((), dtype=torch.int64)
    *_, resolved, t_after, lev3 = _core_two_sweeps(grid, seg, *beams, zero,
                                                   TWINS)
    lo = (torch.floor(idx_min) - 1.0).clamp(min=0.0)
    hi = torch.ceil(idx_max) + 1.0
    lev4 = rf.segment_min_plain(seg.pack, seg.count, ray, lo, hi, lo,
                                tr - seg.origin, levels=rf.ROUNDS,
                                cover=rf.COVER)
    open_ = ~resolved
    np.testing.assert_array_equal(lev4[open_, 1:].numpy(),
                                  lev3[open_].numpy())
    assert not torch.isfinite(lev3[resolved]).any()
    assert torch.isinf(t_after[resolved]).all()
    # an unresolved beam's second sweep starts COVER past its candidate
    np.testing.assert_array_equal(t_after[open_].numpy(),
                                  (lev4[open_, 0] + rf.COVER).numpy())
    if scene == "sliver":
        assert int(open_.sum()) > 30
        assert int(torch.isfinite(lev4[open_, 1]).sum()) > 30


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_one_round_sweeps_one_level(monkeypatch, dtype):
    """ROUNDS = 1: one level, no rounds call."""
    monkeypatch.setattr(rf, "ROUNDS", 1)
    grid, seg, beams = _inputs("room", dtype, 361)
    levels = []
    ks = TWINS._replace(
        segment_min=lambda *a, **k: levels.append(k["levels"])
        or rf.segment_min_plain(*a, **k), window_rounds=None)
    out = rf._core(grid, seg, *beams, torch.zeros((), dtype=torch.int64), ks)
    assert levels == [1] and int(out[2].sum()) > 100
