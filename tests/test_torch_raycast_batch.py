"""The port's pose-batched caster (ohm_tsd_slam_tpu_torch/grid/raycast_fast.py
::raycast_fast_batch) against the JAX package's, and against its own single
renders, in float64 on the CPU.

The batch folds P poses into the beam axis of kernels C, D and D's rounds
with a [P, 2] table of sensor translations; on the CPU the wrappers run
their twins.  Tolerances: against JAX `raycast_fast_batch` on the grid and
the four poses of tests/test_raycast_fast.py (the batch test there) masks
equal and coordinates and normals within 1e-9 m, with and without a cached
extraction; against the port's own `raycast_fast` of each pose every value
equal (a beam's arithmetic does not depend on the batch); the twins with a
[P, 2] table equal to the same twins run pose by pose.  The rounds' drop
order with a pose table (the first `cap` needing beams in beam order) is in
tests/test_torch_window_rounds.py."""

import dataclasses
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ohm_tsd_slam_tpu.grid.raycast_fast as jrf
from ohm_tsd_slam_tpu.core import se2 as jse2
from ohm_tsd_slam_tpu.grid.state import TsdGrid as JTsdGrid
from ohm_tsd_slam_tpu.sensor import polar2d as jpolar
import ohm_tsd_slam_tpu_torch.grid.raycast_fast as rf
from ohm_tsd_slam_tpu_torch.config import GridConfig
from ohm_tsd_slam_tpu_torch.core import se2
from ohm_tsd_slam_tpu_torch.grid.push import push
from ohm_tsd_slam_tpu_torch.grid.raycast import (
    beam_geometry,
    beam_geometry_batch,
)
from ohm_tsd_slam_tpu_torch.grid.state import create, to_arrays
from ohm_tsd_slam_tpu_torch.sensor import polar2d as tpolar
from ohm_tsd_slam_tpu_torch.utils.testing import (
    limit_cpu_threads,
    rect_walls,
    simulate_scan,
)

limit_cpu_threads()

F64 = torch.float64
TOL = 1e-9
# tests/test_raycast_fast.py's grid, geometry and batch
GRID = dict(map_size=8, cellsize=0.04)
GEOM = dict(size=361, angular_res=math.radians(0.75),
            phi_min=math.radians(-135.0), max_range=9.0,
            min_range=0.01, low_reflectivity_range=1.0)
PUSH_POSES = [(5.12, 5.12, 0.2), (5.3, 5.2, 0.5)]
BATCH = [(5.0 + 0.02 * i, 5.0 - 0.01 * i, 0.9 + 0.05 * i) for i in range(4)]
FIELDS = ("tsd", "weight", "tile_init", "tile_initw")


def _scan(xyt):
    pose = se2.make(*xyt, dtype=F64).numpy()
    return simulate_scan(pose, GEOM["size"], GEOM["angular_res"],
                         GEOM["phi_min"], GEOM["max_range"],
                         segments=rect_walls(1.5, 1.5, 8.5, 8.5),
                         circles=[((7.0, 7.2), 0.5), ((3.0, 7.5), 0.35)])


@functools.lru_cache(maxsize=None)
def _scene():
    """The two pushes of tests/test_raycast_fast.py by the port, in both
    packages' grids."""
    geom = tpolar.SensorPolar2D(**GEOM)
    g = create(GridConfig(**GRID), dtype=F64, device="cpu")
    for xyt in PUSH_POSES:
        d, m = tpolar.standard_mask(geom, torch.from_numpy(_scan(xyt)))
        g = push(g, geom, se2.make(*xyt, dtype=F64), d, m)
    d = to_arrays(g)
    jg = JTsdGrid(**{f: jnp.asarray(d[f]) for f in FIELDS},
                  cell_size=d["cell_size"],
                  max_truncation=d["max_truncation"],
                  max_weight=d["max_weight"], tile_dim=d["tile_dim"])
    return g, jg, geom


def _poses(batch=BATCH):
    return torch.stack([se2.make(*xyt, dtype=F64) for xyt in batch])


def _counting_twins(calls):
    """The twins as the caster's kernels, each counting its calls."""
    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)
        return call

    return rf.CasterKernels(
        counted("segment_layers", rf.segment_layers_plain),
        counted("pack_rows",
                lambda g, m, rows, size: rf.pack_rows_plain(g, m, size)),
        counted("segment_min", rf.segment_min_plain),
        counted("window_replay", rf.window_replay_plain),
        counted("compact_channels", None),
        counted("window_rounds", rf.window_rounds_plain))


@pytest.mark.parametrize("cached", [False, True], ids=["inline", "cached"])
def test_batch_matches_jax(cached):
    g, jg, geom = _scene()
    jgeom = jpolar.SensorPolar2D(**GEOM)
    poses = _poses()
    jposes = jnp.stack([jse2.make(*xyt, dtype=jnp.float64) for xyt in BATCH])
    seg = rf.extract_segments(g) if cached else None
    jseg = jrf.extract_segments(jg) if cached else None
    got = rf.raycast_fast_batch(g, geom, poses, segments=seg)
    want = jrf.raycast_fast_batch(jg, jgeom, jposes, segments=jseg)
    assert int(got.n_dropped) == int(want.n_dropped) == 0
    m = np.asarray(want.mask)
    np.testing.assert_array_equal(got.mask.numpy(), m)
    assert m.sum(1).min() > 250                       # real hits per pose
    for name in ("coords", "normals", "ranges"):
        np.testing.assert_allclose(getattr(got, name).numpy()[m],
                                   np.asarray(getattr(want, name))[m],
                                   rtol=0, atol=TOL, err_msg=name)
        assert not getattr(got, name).numpy()[~m].any(), name


def test_batch_equals_the_ports_singles():
    """Every field of each pose's rows equal to raycast_fast of that pose,
    and the beam geometry equal to beam_geometry's."""
    g, _, geom = _scene()
    poses = _poses(BATCH + [(50.0, 50.0, 0.0)])      # one pose off the grid
    seg = rf.extract_segments(g)
    batch = rf.raycast_fast_batch(g, geom, poses, segments=seg)
    geo = beam_geometry_batch(g, geom, poses)
    assert int(batch.n_dropped) == 0
    for p in range(poses.shape[0]):
        single = rf.raycast_fast(g, geom, poses[p], segments=seg)
        for name in ("coords", "normals", "mask", "ranges"):
            assert torch.equal(getattr(batch, name)[p],
                               getattr(single, name)), (p, name)
        for got, want in zip(geo, beam_geometry(g, geom, poses[p])):
            assert torch.equal(got[p], want), p
    assert not batch.mask[-1].any()


def test_one_pose_is_raycast_fast():
    """P = 1 gives raycast_fast's result with the same kernel calls."""
    g, _, geom = _scene()
    pose = se2.make(*BATCH[1], dtype=F64)
    calls_b, calls_s = {}, {}
    batch = rf.raycast_fast_batch(g, geom, pose[None],
                                  kernels=_counting_twins(calls_b))
    single = rf.raycast_fast(g, geom, pose, kernels=_counting_twins(calls_s))
    assert calls_b == calls_s == {"segment_layers": 1, "pack_rows": 1,
                                  "segment_min": 1, "window_replay": 1,
                                  "window_rounds": 1}
    for name in ("coords", "normals", "mask", "ranges"):
        assert torch.equal(getattr(batch, name)[0], getattr(single, name))
    assert int(batch.n_dropped) == int(single.n_dropped) == 0


def test_batch_calls_each_kernel_once_and_counts_a_stale_cache():
    g, _, geom = _scene()
    poses = _poses()
    calls = {}
    seg = rf.extract_segments(g)
    rf.raycast_fast_batch(g, geom, poses, segments=seg,
                          kernels=_counting_twins(calls))
    assert calls == {"segment_min": 1, "window_replay": 1,
                     "window_rounds": 1}
    g2 = dataclasses.replace(g, tsd=g.tsd.clone())
    res = rf.raycast_fast_batch(g2, geom, poses, segments=seg)
    assert int(res.n_dropped) == poses.shape[0] * geom.size


def _beam_inputs(g, geom, poses, seg):
    """The caster's inputs to C and D for a pose batch, flattened."""
    ray, tr, idx_min, idx_max, feasible = beam_geometry_batch(g, geom, poses)
    N = ray.shape[0] * ray.shape[1]
    ray, idx_min, idx_max, feasible = (ray.reshape(N, 2), idx_min.reshape(N),
                                       idx_max.reshape(N), feasible.reshape(N))
    lo = (torch.floor(idx_min) - 1.0).clamp(min=0.0)
    hi = torch.ceil(idx_max) + 1.0
    return ray, tr, idx_min, idx_max, feasible, lo, hi


def test_twins_with_a_pose_table_equal_the_twins_per_pose():
    """segment_min_plain, window_replay_plain and window_rounds_plain with
    a [P, 2] table against the same twins run on each pose's beams with
    its one translation: every value equal."""
    g, _, geom = _scene()
    poses = _poses()
    P, B = poses.shape[0], geom.size
    seg = rf.extract_segments(g)
    ray, tr, idx_min, idx_max, feasible, lo, hi = _beam_inputs(g, geom,
                                                               poses, seg)
    tr_pack = tr - seg.origin
    lev = rf.segment_min_plain(seg.pack, seg.count, ray, lo, hi, lo, tr_pack,
                               levels=rf.ROUNDS, cover=rf.COVER)
    has = torch.isfinite(lev[:, 0]) & feasible
    k_1 = torch.where(has, lev[:, 0], 0.0)
    S = rf.window_replay_plain(g, k_1, ray, idx_min, idx_max, has, tr)
    S[:, 1] = ((S[:, 1] > 0.0) | ~has).to(S.dtype)
    cap = rf.unresolved_cap(B)
    S_r, dropped = rf.window_rounds_plain(g, S, lev[:, 1:], ray, idx_min,
                                          idx_max, tr, cap)
    assert int(dropped) == 0
    assert int((S_r[:, 0] > 0).sum()) > 250 * P
    for p in range(P):
        rows = slice(p * B, (p + 1) * B)
        args = (ray[rows], lo[rows], hi[rows])
        lev_p = rf.segment_min_plain(seg.pack, seg.count, args[0], args[1],
                                     args[2], args[1], tr_pack[p],
                                     levels=rf.ROUNDS, cover=rf.COVER)
        assert torch.equal(lev_p, lev[rows]), p
        S_p = rf.window_replay_plain(g, k_1[rows], ray[rows], idx_min[rows],
                                     idx_max[rows], has[rows], tr[p])
        S_p[:, 1] = ((S_p[:, 1] > 0.0) | ~has[rows]).to(S_p.dtype)
        np.testing.assert_array_equal(S_p.numpy(), S[rows].numpy())
        S_pr, _ = rf.window_rounds_plain(g, S_p, lev_p[:, 1:], ray[rows],
                                         idx_min[rows], idx_max[rows], tr[p],
                                         cap)
        np.testing.assert_array_equal(S_pr.numpy(), S_r[rows].numpy())


def test_a_table_that_does_not_split_the_beams_raises():
    with pytest.raises(ValueError, match="split"):
        rf.beam_origins(torch.zeros(3, 2, dtype=F64), 361 * 2)
