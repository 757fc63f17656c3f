"""Rounds 2..ROUNDS of the port's fast caster: grid/raycast_fast.py::
window_rounds_plain (the twin of the rounds entry point of
ohm_tsd_slam_tpu_torch/csrc/window_replay.cu) and, on a card, the two
entry points of that source against their twins.

On the CPU the twin is held against two references on inputs made from a
numpy seed: the loop as the caster ran it inline before it had the entry
point (`_inline_rounds`: compaction to `cap` slots, a replay of the slots,
a scatter back), and a dense formulation with no compaction
(`_dense_rounds`).  Cases: the round capacity reached or not, a round in
which no beam needs a replay, 1081 beams and more than 1024, and a pose
batch of 8 scans folded into the beam axis with a [P, 2] translation table
(8648 beams: on the card more than the one-block kernel takes, so the
cooperative launch), within the capacity and far beyond it.  Tests marked
`cuda` need the card and skip without one; on a machine with a card they
run with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_window_rounds.py

(--noconftest: the suite's conftest imports jax, which this file does not
need).  This file imports torch only.
"""

import math

import numpy as np
import pytest
import torch

import ohm_tsd_slam_tpu_torch.grid.raycast_fast as rf
from ohm_tsd_slam_tpu_torch.core import se2
from ohm_tsd_slam_tpu_torch.grid.compact import compact_mask
from ohm_tsd_slam_tpu_torch.grid.state import from_arrays
from ohm_tsd_slam_tpu_torch.ops.window_replay_cuda import (
    MAX_CAP,
    ONE_BLOCK_BEAMS,
    check_cap,
    window_replay,
    window_rounds,
    window_rounds_blocks,
)
from ohm_tsd_slam_tpu_torch.sensor import polar2d
from ohm_tsd_slam_tpu_torch.utils.testing import (
    field_arrays,
    limit_cpu_threads,
    sliver_field,
)

limit_cpu_threads()

XYT = (2.0, 5.12, 0.3)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    return torch.device("cuda")


def _grid(dtype, device="cpu"):
    """Three slivers thinner than a march step in front of a wall: a beam
    can step over one after the other, so rounds 2, 3 and 4 all find
    work."""
    f = sliver_field(256, 100, 140, rows=(112, 144))
    f[112:144, 115] = -0.2
    f[112:144, 128] = -0.2
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    return from_arrays(field_arrays(f.astype(np_dtype), 0.04), device=device)


def _round_one(grid, n_beams, poses=1):
    """The caster up to the rounds, on the twins: (S, lev, ray, idx_min,
    idx_max, tr) as grid/raycast_fast.py::_core hands them on; with
    `poses` > 1 a pose batch (XYT and poses a little behind it) folded into
    the beam axis, tr the [poses, 2] table."""
    dtype, dev = grid.tsd.dtype, grid.tsd.device
    geom = polar2d.SensorPolar2D(
        size=n_beams, angular_res=math.radians(270.0) / n_beams,
        phi_min=math.radians(-135.0), max_range=9.0, min_range=0.01)
    twins = rf.CasterKernels(
        rf.segment_layers_plain,
        lambda g, m, rows, size: rf.pack_rows_plain(g, m, size),
        rf.segment_min_plain, rf.window_replay_plain, None, None)
    seg = rf.extract_segments(grid, kernels=twins)
    if poses == 1:
        pose = se2.make(*XYT, dtype=dtype, device=dev)
        ray, tr, idx_min, idx_max, feasible = rf.beam_geometry(grid, geom,
                                                               pose)
    else:
        batch = torch.stack([
            se2.make(XYT[0] - 0.05 * p, XYT[1] + 0.01 * p, XYT[2] - 0.02 * p,
                     dtype=dtype, device=dev) for p in range(poses)])
        ray, tr, idx_min, idx_max, feasible = (
            x.reshape(-1, *x.shape[2:]) if x.dim() > 1 and i != 1 else x
            for i, x in enumerate(rf.beam_geometry_batch(grid, geom, batch)))
    lo = (torch.floor(idx_min) - 1.0).clamp(min=0.0)
    hi = torch.ceil(idx_max) + 1.0
    tr_pack = tr - seg.origin
    t_1 = rf.segment_min_plain(seg.pack, seg.count, ray, lo, hi, lo,
                               tr_pack)[:, 0]
    has = torch.isfinite(t_1) & feasible
    k_1 = torch.where(has, t_1, 0.0)
    S = rf.window_replay_plain(grid, k_1, ray, idx_min, idx_max, has, tr)
    resolved = (S[:, 1] > 0.0) | ~has
    S[:, 1] = resolved.to(dtype)
    t_after = torch.where(resolved, math.inf,
                          torch.maximum(lo, k_1 + rf.COVER))
    lev = rf.segment_min_plain(seg.pack, seg.count, ray, lo, hi, t_after,
                               tr_pack, levels=rf.ROUNDS - 1, cover=rf.COVER)
    return S, lev, ray, idx_min, idx_max, tr.contiguous()


def _case(name, dtype, device="cpu"):
    """(grid, S, lev, ray, idx_min, idx_max, tr, cap) of a named case."""
    n_beams = {"n1081": 1081, "n1081_overflow": 1081, "none_needed": 1081,
               "n1300": 1300, "n1300_random_overflow": 1300,
               "n361": 361, "batch8": 1081,
               "batch8_random_overflow": 1081}[name]
    poses = 8 if name.startswith("batch") else 1
    grid = _grid(dtype, device)
    S, lev, ray, idx_min, idx_max, tr = _round_one(grid, n_beams, poses)
    cap = rf.unresolved_cap(n_beams * poses)
    if name == "n1081_overflow":
        cap = 4
    elif name == "batch8":
        # the slivers make each scan need ~90 replays a round, more than
        # unresolved_cap(8648) = 256 for eight: a capacity the rounds fit
        cap = 1024
    elif name == "none_needed":
        lev = torch.full_like(lev, math.inf)
    elif name.endswith("random_overflow"):
        # needing beams all over the beam axis, far more than the capacity
        # in every round: the rank must count every lower beam
        rng = np.random.default_rng(7)
        cap = 16
        S[:, 1] = torch.from_numpy(rng.random(S.shape[0]) < 0.5).to(S)
        steps = torch.from_numpy(
            rng.uniform(20.0, 90.0, lev.shape)).to(lev)
        lev = torch.where(torch.from_numpy(
            rng.random(lev.shape) < 0.2).to(lev.device), steps, math.inf)
    return grid, S, lev, ray, idx_min, idx_max, tr, cap


def _inline_rounds(grid, S, lev, ray, idx_min, idx_max, tr, cap):
    """The rounds as the caster's core ran them inline (each slot with its
    beam's translation)."""
    n_dropped = torch.zeros((), dtype=torch.int64, device=S.device)
    origins = rf.beam_origins(tr, S.shape[0])
    for r in range(lev.shape[1]):
        t_r = lev[:, r]
        need = torch.isfinite(t_r) & ~(S[:, 1] > 0.0)
        n_dropped = n_dropped + (need.sum() - cap).clamp(min=0)
        idx_u, uvalid = compact_mask(need, cap)
        k_u = torch.where(uvalid, t_r[idx_u], 0.0)
        rows = rf.window_replay_plain(
            grid, k_u, ray[idx_u], idx_min[idx_u], idx_max[idx_u], uvalid,
            origins if origins.dim() == 1 else origins[idx_u])
        take = (rows[:, 1] > 0.0) & uvalid
        ext = torch.cat([S, S.new_zeros((1, 8))])
        S = ext.index_copy(0, torch.where(take, idx_u, S.shape[0]),
                           rows)[:S.shape[0]]
        S[:, 1] = torch.maximum(S[:, 1], (~need).to(S.dtype))
    return S, n_dropped


def _dense_rounds(grid, S, lev, ray, idx_min, idx_max, tr, cap):
    """The same semantics with no compaction: every beam is replayed, and
    the first `cap` needing beams by beam index take their new row."""
    dropped = 0
    needing = []
    for r in range(lev.shape[1]):
        need = torch.isfinite(lev[:, r]) & ~(S[:, 1] > 0.0)
        needing.append(int(need.sum()))
        dropped += max(needing[-1] - cap, 0)
        sel = need & (torch.cumsum(need, 0) <= cap)
        rows = rf.window_replay_plain(
            grid, torch.where(sel, lev[:, r], 0.0), ray, idx_min, idx_max,
            sel, tr)
        S = torch.where((sel & (rows[:, 1] > 0.0))[:, None], rows, S)
        S[:, 1] = torch.maximum(S[:, 1], (~need).to(S.dtype))
    return S, dropped, needing


def _assert_rows_equal(got, want):
    """Equal in every value; NaN where the other has NaN."""
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


CASES = ["n1081", "n1081_overflow", "none_needed", "n1300",
         "n1300_random_overflow", "n361", "batch8", "batch8_random_overflow"]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("case", CASES)
def test_rounds_twin_matches_inline_loop(case, dtype):
    grid, S, lev, *beams, cap = _case(case, dtype)
    S_in = S.clone()
    got, dropped = rf.window_rounds_plain(grid, S, lev, *beams, cap)
    _assert_rows_equal(S, S_in)                  # the argument is kept
    assert dropped.dtype == torch.int64 and dropped.ndim == 0
    want, want_dropped = _inline_rounds(grid, S_in.clone(), lev, *beams, cap)
    dense, dense_dropped, needing = _dense_rounds(grid, S_in.clone(), lev,
                                                  *beams, cap)
    _assert_rows_equal(got, want)
    _assert_rows_equal(got, dense)
    assert int(dropped) == int(want_dropped) == dense_dropped

    hits_before = int((S_in[:, 0] > 0).sum())
    hits = int((got[:, 0] > 0).sum())
    if case == "none_needed":
        assert needing == [0] * (rf.ROUNDS - 1) and int(dropped) == 0
        assert bool((got[:, 1] > 0).all())       # every beam is resolved
        _assert_rows_equal(got[:, [0, 2, 3, 4, 5, 6, 7]],
                           S_in[:, [0, 2, 3, 4, 5, 6, 7]])
    elif case.endswith("overflow"):
        assert needing[0] > cap and int(dropped) >= needing[0] - cap
    else:
        # each later round finds work, all of it within the capacity, and
        # the rounds find hits round 1 could not
        assert all(0 < n <= cap for n in needing), needing
        assert int(dropped) == 0 and hits > hits_before + 10


def test_wrappers_run_the_twins_on_the_cpu():
    """A CPU grid goes to the twins and counts no launch."""
    grid, S, lev, *beams, cap = _case("n361", torch.float32)
    before = window_replay.launches, window_rounds.launches
    got, dropped = window_rounds(grid, S.clone(), lev, *beams, cap)
    want, want_dropped = rf.window_rounds_plain(grid, S, lev, *beams, cap)
    _assert_rows_equal(got, want)
    assert int(dropped) == int(want_dropped)
    assert (window_replay.launches, window_rounds.launches) == before


def test_rounds_capacity_check_follows_the_launch():
    """One block lists a round's beams in shared memory, so its capacity
    stops at MAX_CAP; a cooperative launch lists them in a scratch tensor,
    so the caster's capacity for a batch of 728 scans of 1081 beams, past
    MAX_CAP, passes its check there."""
    assert window_rounds_blocks(1081) == window_rounds_blocks(
        ONE_BLOCK_BEAMS) == 1                    # no card asked
    cap = rf.unresolved_cap(728 * 1081)
    assert cap > MAX_CAP
    check_cap(cap, blocks=132)
    check_cap(MAX_CAP, blocks=1)
    for bad, blocks in ((cap, 1), (0, 1), (0, 132)):
        with pytest.raises(ValueError, match="cap"):
            check_cap(bad, blocks)


@pytest.mark.cuda
@pytest.mark.parametrize("n_beams", [1081, 1300, 3])
def test_replay_kernel_matches_twin(cuda_device, n_beams):
    """Round 1, eight lanes a beam, on beam counts that fill a warp, leave
    one partly empty and leave a block nearly empty: every value equal."""
    grid = _grid(torch.float32, cuda_device)
    _, lev, ray, idx_min, idx_max, tr = _round_one(grid, max(n_beams, 361))
    n = n_beams
    k = lev[:n, 0].clone()
    active = torch.isfinite(k)
    k = torch.where(active, k, 0.0)
    args = (grid, k, ray[:n].contiguous(), idx_min[:n].contiguous(),
            idx_max[:n].contiguous(), active, tr)
    before = window_replay.launches
    got = window_replay(*args)
    torch.cuda.synchronize()
    assert window_replay.launches == before + 1
    _assert_rows_equal(got, rf.window_replay_plain(*args))
    if n > 100:
        assert int((got[:, 1] > 0).sum()) > 5


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_rounds_kernel_matches_twin(cuda_device, case):
    """One launch for rounds 2..ROUNDS against the twin: rows equal in
    every value, the drop count equal; the capacity reached, a round with
    no needing beam, more beams than the block has threads."""
    grid, S, lev, *beams, cap = _case(case, torch.float32, cuda_device)
    want, want_dropped = rf.window_rounds_plain(grid, S, lev, *beams, cap)
    before = window_rounds.launches
    got, dropped = window_rounds(grid, S, lev, *beams, cap)
    torch.cuda.synchronize()
    assert window_rounds.launches == before + 1
    assert got.data_ptr() == S.data_ptr()            # updated in place
    _assert_rows_equal(got, want)
    assert dropped.dtype == torch.int64
    assert int(dropped) == int(want_dropped)
    if case.endswith("overflow"):
        assert int(dropped) > 0


@pytest.mark.cuda
def test_rounds_kernel_refuses_what_it_cannot_take(cuda_device):
    grid, S, lev, *beams, cap = _case("n361", torch.float32, cuda_device)
    with pytest.raises(ValueError, match="cap"):
        window_rounds(grid, S, lev, *beams, 1 << 20)
    with pytest.raises(TypeError, match="float32"):
        window_rounds(grid, S.double(), lev, *beams, cap)
    with pytest.raises(ValueError, match="contiguous"):
        window_rounds(grid, torch.cat([S, S], 1)[:, :8], lev, *beams, cap)
