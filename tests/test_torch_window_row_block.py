"""Kernel D's twin on a row block of the grid (ohm_tsd_slam_tpu_torch/
grid/raycast_fast.py::window_replay_plain with `row0`), as the row-sharded
render (parallel/shard_raycast.py) runs it on a rank's halo'd block, on
the CPU in float64.

The block is cut from a grid the port pushed, HALO rows below and above
a rank's rows, NaN beyond the grid, as `_halo_exchange` builds it; the
beams are the rank's owned ones (the candidate's row in its rows).  The
replay on the block equals the whole grid's in every bit on the beams
whose window and normal taps lie inside the block, and matches the JAX
package's replay on the block (ohm_tsd_slam_tpu/parallel/
shard_raycast.py::_local_window_events and _local_normals, which shift
the coordinates into the block) at 1e-12 on every owned beam."""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ohm_tsd_slam_tpu.parallel import shard_raycast as jsr
import ohm_tsd_slam_tpu_torch.grid.raycast_fast as rf
from ohm_tsd_slam_tpu_torch.config import GridConfig
from ohm_tsd_slam_tpu_torch.core import se2
from ohm_tsd_slam_tpu_torch.grid.push import push
from ohm_tsd_slam_tpu_torch.grid.state import create
from ohm_tsd_slam_tpu_torch.parallel.shard_raycast import HALO, _field_grid
from ohm_tsd_slam_tpu_torch.sensor import polar2d
from ohm_tsd_slam_tpu_torch.utils.testing import (
    limit_cpu_threads,
    rect_walls,
    simulate_scan,
)

limit_cpu_threads()

GEOM = polar2d.SensorPolar2D(size=541, angular_res=math.radians(0.5),
                             phi_min=math.radians(-135.0), max_range=9.0,
                             min_range=0.01, low_reflectivity_range=1.0)
# walls off the lines of cell centres (0.04 m cells: centres at 0.02 +
# 0.04 i), so no tap rounds into the next cell in either package
WALLS = rect_walls(1.51, 1.53, 8.47, 8.49)
PUSH_POSES = [(5.11, 5.13, 0.2), (5.31, 4.93, 1.9)]
QUERY_POSES = [(5.13, 5.07, 0.25), (4.61, 5.43, -1.3)]
SP = 4                                          # ranks over 256 rows


@functools.lru_cache(maxsize=None)
def _grid():
    g = create(GridConfig(map_size=8, cellsize=0.04), dtype=torch.float64,
               device="cpu")
    for xyt in PUSH_POSES:
        pose = se2.make(*xyt, dtype=torch.float64)
        r = simulate_scan(pose.numpy(), GEOM.size, GEOM.angular_res,
                          GEOM.phi_min, GEOM.max_range, segments=WALLS)
        d, m = polar2d.standard_mask(GEOM, torch.from_numpy(r))
        g = push(g, GEOM, pose, d, m)
    return g


def _halo_block(tsd, rank):
    """Rank `rank`'s rows and HALO rows each side (NaN past the grid), and
    the block's first world row."""
    H, W = tsd.shape
    h = H // SP
    y0 = rank * h
    nan = torch.full((HALO, W), math.nan, dtype=tsd.dtype)
    below = tsd[y0 - HALO:y0] if y0 > 0 else nan
    above = tsd[y0 + h:y0 + h + HALO] if y0 + h < H else nan
    return torch.cat([below, tsd[y0:y0 + h], above]), y0 - HALO, y0, h


def _owned(grid, xyt, y0, h):
    """The beam geometry, each beam's first candidate, and the beams whose
    candidate lies in rows [y0, y0 + h) (the rank's own)."""
    pose = se2.make(*xyt, dtype=torch.float64)
    ray, tr, idx_min, idx_max, feasible = rf.beam_geometry(grid, GEOM, pose)
    seg = rf.extract_segments(grid)
    lo = (torch.floor(idx_min) - 1.0).clamp(min=0.0)
    t_1 = rf.segment_min_plain(seg.pack, seg.count, ray, lo,
                               torch.ceil(idx_max) + 1.0, lo,
                               tr - seg.origin)[:, 0]
    has = torch.isfinite(t_1) & feasible
    k = torch.where(has, t_1, 0.0)
    row_c = (tr[1] + k * ray[:, 1]) / grid.cell_size - 0.5
    owner = has & (row_c >= y0) & (row_c < y0 + h)
    return ray, tr, idx_min, idx_max, k, owner


@pytest.mark.parametrize("xyt", QUERY_POSES)
@pytest.mark.parametrize("rank", [0, 1, SP - 1])
def test_block_replay_equals_whole_grid(rank, xyt):
    """On the beams whose samples and normal taps lie inside the block,
    every column equals the whole grid's replay bit for bit (the same
    world coordinates, the same cells); row0 = 0 on the whole grid is the
    call without it."""
    grid = _grid()
    block, row0, y0, h = _halo_block(grid.tsd, rank)
    ray, tr, idx_min, idx_max, k, owner = _owned(grid, xyt, y0, h)
    args = (k, ray, idx_min, idx_max, owner, tr)
    whole = rf.window_replay_plain(grid, *args)
    assert torch.equal(whole.view(torch.int64), rf.window_replay_plain(
        grid, *args, row0=0).view(torch.int64))
    got = rf.window_replay_plain(_field_grid(block, grid.cell_size), *args,
                                 row0=row0)
    # rows the window's samples and the normal's taps can read: the
    # samples' cells, a cell about them for the crossing's +-s taps
    s = grid.cell_size
    t = rf.window_start(k, idx_min)[:, None] + torch.arange(rf.WINDOW)
    y = tr[1] + t * ray[:, 1:2]
    lo_row = torch.floor((y.amin(1) - s) / s - 0.5)
    hi_row = torch.floor((y.amax(1) + s) / s - 0.5) + 1
    inside = owner & (lo_row >= row0) & (hi_row < row0 + block.shape[0])
    assert int(inside.sum()) > 40, int(inside.sum())
    np.testing.assert_array_equal(got[inside].numpy(),
                                  whole[inside].numpy())
    assert int((got[inside, 0] > 0).sum()) > 30
    assert not got[~owner].any()                  # inactive rows are zero


@pytest.mark.parametrize("xyt", QUERY_POSES)
@pytest.mark.parametrize("rank", [0, 1, SP - 1])
def test_block_replay_matches_jax_local_replay(rank, xyt):
    """Every owned beam against the JAX package's replay on the same
    block: events and flags equal, positions, sub-cell interpolation and
    normals within 1e-12; the sharded render's n_ok (the four taps and a
    nonzero normal) equal to JAX's."""
    grid = _grid()
    s = grid.cell_size
    block, row0, y0, h = _halo_block(grid.tsd, rank)
    ray, tr, idx_min, idx_max, k, owner = _owned(grid, xyt, y0, h)
    out = rf.window_replay_plain(_field_grid(block, s), k, ray, idx_min,
                                 idx_max, owner, tr, row0=row0)

    j = lambda t: jnp.asarray(t.numpy())              # noqa: E731
    hit, any_ev, pos, interp = jsr._local_window_events(
        j(block), s, row0 * s, j(tr), j(ray), j(idx_min), j(idx_max), j(k),
        j(owner))
    coords = pos + j(ray) * (interp[:, None] - 1.0)
    nrm, n_ok = jsr._local_normals(j(block), s, row0 * s, coords)
    m = owner.numpy()
    assert m.sum() > 60
    np.testing.assert_array_equal(out[m, 1].numpy() > 0,
                                  np.asarray(any_ev)[m])
    np.testing.assert_array_equal(out[m, 0].numpy() > 0, np.asarray(hit)[m])
    ev = m & np.asarray(any_ev)
    assert ev.sum() > 40
    np.testing.assert_allclose(out[ev, 2:4].numpy(), np.asarray(pos)[ev],
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(out[ev, 4].numpy(), np.asarray(interp)[ev],
                               rtol=0, atol=1e-12)
    ok = (out[:, 7] > 0) & (out[:, 5:7] != 0).any(1)
    np.testing.assert_array_equal(ok.numpy()[ev], np.asarray(n_ok)[ev])
    nm = ev & ok.numpy()
    assert nm.sum() > 40
    np.testing.assert_allclose(out[nm, 5:7].numpy(), np.asarray(nrm)[nm],
                               rtol=0, atol=1e-12)
