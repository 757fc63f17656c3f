"""Maps larger than a room: the segment capacity that follows the grid and
the per-scan reach cull before kernel C (grid/raycast_fast.py::
segment_capacity, reach_cull; slam/localize.py applies the cull).

On the CPU, on the twins, in float32 and float64:
  * the capacity is MAX_SEGMENTS up to a 1024^2 grid and grows with the
    cells beyond it;
  * on a 10.24 m map scanned with a 3 m laser, with a capacity forced so
    that the old fixed one overflows, the culled pack renders every beam
    as the whole pack does (the candidate levels, the hits, the drop
    count, in every bit) and as the exact march does, with hits at the
    edge of the laser's reach; a radius below the reach does not;
  * the cull is in the step only where it can pay, and the step reports
    what kernel C swept;
  * the node on a short seeded stream of the benchmark's double-laser
    deployment (map_size 8, lasers cut to 6 m and 5 m so that the cull
    runs, the capacity forced small) equals the benchmark's plain
    reference (slambench/reference/), the check's numbers all 0.
On the card (`cuda`): the cull and kernel C equal their twins in every
bit at S > 32768 on a 4096^2 grid.
"""

import math
import types

import numpy as np
import pytest
import torch

import ohm_tsd_slam_tpu_torch.grid.raycast_fast as rf
from ohm_tsd_slam_tpu_torch.config import GridConfig
from ohm_tsd_slam_tpu_torch.core import se2
from ohm_tsd_slam_tpu_torch.grid.push import push
from ohm_tsd_slam_tpu_torch.grid.raycast import raycast
from ohm_tsd_slam_tpu_torch.grid.state import create, from_arrays
from ohm_tsd_slam_tpu_torch.registration.icp import IcpParams
from ohm_tsd_slam_tpu_torch.sensor import polar2d as tpolar
from ohm_tsd_slam_tpu_torch.slam.localize import LocalizeParams, localize_step
from ohm_tsd_slam_tpu_torch.utils.testing import (
    field_arrays,
    limit_cpu_threads,
    rect_walls,
    simulate_scan,
)

limit_cpu_threads()

GRID = GridConfig(map_size=8, cellsize=0.04)          # 10.24 m
BEAMS = dict(size=361, angular_res=math.radians(0.75),
             phi_min=math.radians(-135.0), min_range=0.01,
             low_reflectivity_range=1.0)
# a site of walls, boxes and pillars over the whole map
WALLS = (rect_walls(0.4, 0.4, 9.8, 9.8) + rect_walls(2.0, 2.0, 3.0, 2.6)
         + rect_walls(6.5, 7.0, 7.5, 7.8) + rect_walls(7.2, 2.2, 7.8, 3.4)
         + [((4.0, 8.8), (5.5, 8.8)), ((1.5, 5.0), (1.5, 6.5))])
PILLARS = [((c % 4) * 2.1 + 1.6, (c // 4) * 2.3 + 1.3) for c in range(16)]
CIRCLES = [(p, 0.12) for p in PILLARS
           if all(math.hypot(p[0] - q[0], p[1] - q[1]) > 0.6
                  for q in ((6.82, 5.12), (5.12, 5.12), (3.0, 4.0),
                            (7.5, 5.5), (2.2, 7.8)))]
PUSH_POSES = [(5.12, 5.12, 0.2), (3.0, 4.0, 2.0), (7.5, 5.5, -1.0),
              (2.2, 7.8, -0.6)]
# 2.98 m from the east wall's inner face straight ahead of a 3 m laser
QUERY = (6.82, 5.12, 0.0)
REACH = 3.0


def _geom(max_range):
    return tpolar.SensorPolar2D(max_range=max_range, **BEAMS)


def _site(dtype):
    geom = _geom(9.0)
    g = create(GRID, dtype=dtype, device="cpu")
    for xyt in PUSH_POSES:
        pose = se2.make(*xyt, dtype=torch.float64)
        r = simulate_scan(pose.numpy(), geom.size, geom.angular_res,
                          geom.phi_min, geom.max_range, segments=WALLS,
                          circles=CIRCLES)
        d, m = tpolar.standard_mask(geom, torch.as_tensor(r, dtype=dtype))
        g = push(g, geom, se2.make(*xyt, dtype=dtype), d, m)
    return g


@pytest.fixture(scope="module", params=["float32", "float64"])
def site(request):
    return _site(getattr(torch, request.param))


def _levels(grid, segments, geom, pose):
    """Kernel C's twin: the ROUNDS candidate levels of every beam, as the
    caster's `_core` sweeps them."""
    ray, tr, idx_min, idx_max, _ = rf.beam_geometry(grid, geom, pose)
    lo = (torch.floor(idx_min) - 1.0).clamp(min=0.0)
    hi = torch.ceil(idx_max) + 1.0
    return rf.segment_min_plain(segments.pack, segments.count, ray, lo, hi,
                                lo, tr - segments.origin, levels=rf.ROUNDS,
                                cover=rf.COVER)


def _same(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


# ------------------------------------------------------------ the capacity

def test_capacity_is_max_segments_up_to_1024_and_grows_with_the_cells():
    def cap(w, h=None):
        return rf.segment_capacity(types.SimpleNamespace(
            cells_x=w, cells_y=w if h is None else h))

    for size in (64, 128, 256, 512, 1024):
        assert cap(size) == rf.MAX_SEGMENTS == 32768
    assert cap(2048) == 4 * rf.MAX_SEGMENTS
    assert cap(4096) == 16 * rf.MAX_SEGMENTS == 524288
    assert cap(1025) == 2 * rf.MAX_SEGMENTS     # every block of cells begun
    assert cap(2048, 1024) == 2 * rf.MAX_SEGMENTS
    assert rf.MAX_CROSSINGS == rf.MAX_SEGMENTS
    g = create(GRID, dtype=torch.float32, device="cpu")
    assert rf.segment_capacity(g) == rf.MAX_SEGMENTS
    assert rf.extract_segments(g).pack.shape[1] == rf.MAX_SEGMENTS


def test_the_cull_pays_only_beyond_twice_the_reach():
    room = create(GridConfig(map_size=10, cellsize=0.025), dtype=torch.float32,
                  device="meta")
    site = create(GridConfig(map_size=12, cellsize=0.025),
                  dtype=torch.float32, device="meta")
    for max_range in (20.0, 30.0):      # the double laser's two lasers
        assert not rf.reach_cull_pays(room, _geom(max_range))
        assert rf.reach_cull_pays(site, _geom(max_range))
    g = create(GRID, dtype=torch.float32, device="meta")
    assert rf.reach_cull_pays(g, _geom(REACH))
    assert not rf.reach_cull_pays(g, _geom(5.0))
    assert rf.reach_radius(g, _geom(REACH)) == pytest.approx(
        REACH + (rf.BACKOFF + 4.0) * 0.04)


# ------------------------------------------------------------ the reach cull

def test_the_cull_is_exact_where_the_old_capacity_overflows(site,
                                                            monkeypatch):
    grid = site
    f64 = grid.tsd.dtype == torch.float64
    monkeypatch.setattr(rf, "MAX_SEGMENTS", 128)
    monkeypatch.setattr(rf, "CAPACITY_CELLS", 1 << 12)
    assert int(rf.extract_segments(grid, max_segments=128).n_dropped) > 0
    seg = rf.extract_segments(grid)
    assert seg.pack.shape[1] == rf.segment_capacity(grid) == 2048
    assert int(seg.n_dropped) == 0 and int(seg.count) > 128

    geom = _geom(REACH)
    pose = se2.make(*QUERY, dtype=grid.tsd.dtype)
    culled = rf.reach_cull(seg, pose, rf.reach_radius(grid, geom))
    assert 0 < int(culled.count) < int(seg.count) // 2
    assert culled.pack.shape == (8, seg.pack.shape[1] + 128)
    # the kept columns are the whole pack's, in its order
    tr = se2.translation(pose) - seg.origin
    n = int(seg.count)
    dx, dy = seg.pack[2, :n] - tr[0], seg.pack[3, :n] - tr[1]
    r2 = torch.full((), rf.reach_radius(grid, geom) ** 2, dtype=dx.dtype)
    kept = torch.nonzero(dx * dx + dy * dy <= r2)[:, 0]
    assert torch.equal(culled.pack[:7, :int(culled.count)],
                       seg.pack[:7, kept])

    # every candidate level equal, and so every hit and drop count
    assert _same(_levels(grid, culled, geom, pose),
                 _levels(grid, seg, geom, pose))
    got = rf.raycast_fast(grid, geom, pose, segments=culled)
    whole = rf.raycast_fast(grid, geom, pose, segments=seg)
    for f in got._fields:
        assert _same(getattr(got, f), getattr(whole, f)), f
    assert int(got.n_dropped) == 0

    exact = raycast(grid, geom, pose)
    mask = got.mask
    assert torch.equal(mask, exact.mask) and int(mask.sum()) > 50
    np.testing.assert_allclose(got.coords[mask].numpy(),
                               exact.coords[mask].numpy(), rtol=0,
                               atol=1e-9 if f64 else 1e-4)
    # hits at the edge of the laser's reach are among them
    assert float(got.ranges[mask].max()) > REACH - 0.05

    # a radius short of the reach loses those hits: the margin is needed
    short = rf.reach_cull(seg, pose, REACH - 0.3)
    cut = rf.raycast_fast(grid, geom, pose, segments=short)
    assert int(cut.mask.sum()) < int(mask.sum())


def test_the_step_culls_where_it_pays_and_reports_the_sweep(site):
    grid = site
    dt = grid.tsd.dtype
    seg = rf.extract_segments(grid)
    pose = se2.make(*QUERY, dtype=dt)
    geom = _geom(REACH)
    r = simulate_scan(se2.make(*QUERY, dtype=torch.float64).numpy(),
                      geom.size, geom.angular_res, geom.phi_min,
                      geom.max_range, segments=WALLS, circles=CIRCLES)
    data, mask = tpolar.standard_mask(geom, torch.as_tensor(r, dtype=dt))
    out = {}
    for max_range in (REACH, 5.0):
        g = _geom(max_range)
        params = LocalizeParams(geom=g, icp=IcpParams(iterations=10))
        out[max_range] = localize_step(grid, pose, pose, data, mask, params,
                                       segments=seg)
    culled = rf.reach_cull(seg, pose, rf.reach_radius(grid, geom))
    assert int(out[REACH].segments_swept) == int(culled.count)
    assert int(out[5.0].segments_swept) == int(seg.count)
    assert out[REACH].segments_swept.dtype == torch.int64
    assert int(out[REACH].rays_dropped) == 0


# ------------------------------------------------------------ the node

def test_the_node_equals_the_reference_with_the_cull_on(monkeypatch):
    """The benchmark's double-laser deployment at the CPU's size, with
    lasers short enough for the cull to run on the 25.6 m map and the
    capacity rule forced to grow at 256^2 cells: the check's numbers are
    all 0 (tests of slambench/ hold the same for the deployments as
    shipped), nothing overflowed, and the step swept fewer segments than
    the map holds."""
    from ohm_tsd_slam_tpu_torch.utils import spans
    from slambench import check
    from slambench.tests import tiny

    monkeypatch.setattr(rf, "MAX_SEGMENTS", 128)
    monkeypatch.setattr(rf, "CAPACITY_CELLS", 1 << 12)
    c = tiny.cell("double-laser.live-walk")
    c.config = dict(c.config, **{"robot0/max_range": 6.0,
                                 "robot1/max_range": 5.0})
    spans.enable()
    spans.reset()
    try:
        run = tiny.run(c, seed=3_000_000_021, seconds=1.2)
        counts = spans.count_events()
    finally:
        spans.disable()
        spans.reset()
    node = run.node
    grid = node.grid
    assert rf.reach_cull_pays(grid, node.localizers[0].geom)
    assert int(node._segments.count) > 128       # the old capacity's
    assert run.window.overflowed == 0
    caps = [n for name, _, n, _ in counts if name == "segment_capacity"]
    assert caps and set(caps) == {128 * 16}
    held, swept = 0, []
    for name, _, n, _ in counts:
        if name == "segments":
            held = n
        elif name == "segments_swept":
            swept.append((n, held))
    assert len(swept) == run.window.attempted + 2 * run.warmup
    assert all(0 < n <= h for n, h in swept)
    assert sum(n < h for n, h in swept) >= len(swept) // 2
    assert max(h for _, h in swept) > 128
    ev = run.evidence
    assert len(ev.scans) == 16
    assert any(s.grid_after is not None for s in ev.scans)
    values = check.readings(ev, run.device)
    assert {k: values[k] for k in check.NAMES} == dict.fromkeys(
        check.NAMES, 0)


# ------------------------------------------------------------ on the card

def _pillar_field(cells: int, cell: float, pitch: float, radius: float):
    """A [cells, cells] field of pillars of `radius` on a lattice of
    `pitch` metres: signed distance to the nearest, truncated at 3 cells
    and scaled to [-1, 1]."""
    x = (np.arange(cells, dtype=np.float64) + 0.5) * cell
    d1 = np.abs((x + 0.5 * pitch) % pitch - 0.5 * pitch)
    d = np.sqrt(d1[None, :] ** 2 + d1[:, None] ** 2) - radius
    return np.clip(d / (3 * cell), -1.0, 1.0).astype(np.float32)


@pytest.mark.cuda
def test_cull_and_sweep_equal_their_twins_on_a_4096_grid():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ohm_tsd_slam_tpu_torch.ops.segment_min_cuda import segment_min

    dev = torch.device("cuda")
    cell = 0.025
    grid = from_arrays(field_arrays(_pillar_field(4096, cell, 1.0, 0.1),
                                    cell), device=dev)
    seg = rf.extract_segments(grid)
    assert seg.pack.shape[1] == 524288
    assert 32768 < int(seg.count) < 524288 and int(seg.n_dropped) == 0
    twins = rf.CasterKernels(None, None, None, None,
                             rf.pack_channels_rows, None)
    cpu = seg._replace(**{f: getattr(seg, f).cpu() for f in (
        "p0", "p1", "valid", "n_dropped", "pack", "count", "origin")})
    geom = _geom(30.0)
    for xyt in ((51.2, 51.2, 0.3), (20.0, 80.0, -2.0), (1.0, 1.0, 0.7)):
        pose = se2.make(*xyt, dtype=torch.float32, device=dev)
        radius = rf.reach_radius(grid, geom)
        culled = rf.reach_cull(seg, pose, radius)
        plain = rf.reach_cull(cpu, pose.cpu(), radius, twins)
        assert _same(culled.pack.cpu(), plain.pack)
        assert int(culled.count) == int(plain.count) > 32768 // 8
        ray, tr, idx_min, idx_max, _ = rf.beam_geometry(grid, geom, pose)
        lo = (torch.floor(idx_min) - 1.0).clamp(min=0.0)
        hi = torch.ceil(idx_max) + 1.0
        args = (ray, lo, hi, lo, tr - seg.origin)
        got = segment_min(culled.pack, culled.count, *args,
                          levels=rf.ROUNDS, cover=rf.COVER)
        full = segment_min(seg.pack, seg.count, *args, levels=rf.ROUNDS,
                           cover=rf.COVER)
        twin = rf.segment_min_plain(plain.pack, plain.count,
                                    *(a.cpu() for a in args),
                                    levels=rf.ROUNDS, cover=rf.COVER)
        assert torch.equal(got, full) and torch.equal(got.cpu(), twin)
        assert torch.isfinite(got[:, 0]).sum() > 200
