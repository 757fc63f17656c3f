"""The port's isocontour caster (ohm_tsd_slam_tpu_torch/grid/raycast_fast.py)
against the JAX package's, on the CPU.

Each plain twin of the four CUDA kernels is held against the jnp function
and the Pallas kernel (interpret mode) it replaces: the segment layers,
the row pack, the K-level candidate sweep and the window replay.  The
whole caster runs in float64 against JAX `raycast_fast` (mask equal,
coordinates and normals within 1e-9 m, as tests/test_raycast_fast.py
holds the JAX caster to the exact march) and against the golden caster
rows of the compiled reference: on the CPU the caster runs its kernel
path with the twins in place of the kernels, with a cached extraction and
with the extraction inline.  Inputs are made
from numpy with a seed (scans, fields), pushed through the port and
converted to the JAX package's grid."""

import functools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ohm_tsd_slam_tpu.grid.raycast_fast as jrf
from ohm_tsd_slam_tpu.core import se2 as jse2
from ohm_tsd_slam_tpu.grid import interpolate as jinterp
from ohm_tsd_slam_tpu.grid.state import TsdGrid as JTsdGrid
from ohm_tsd_slam_tpu.ops.pack_rows_pallas import pack_channels_rows_pallas
from ohm_tsd_slam_tpu.ops.raycast_pallas import (
    pack_segments as jpack_segments,
    pad_beams,
    segment_min_pallas,
)
from ohm_tsd_slam_tpu.ops.segment_layers_pallas import segment_layers_pallas
from ohm_tsd_slam_tpu.ops.window_block_pallas import window_single_pallas
from ohm_tsd_slam_tpu.sensor import polar2d as jpolar
import ohm_tsd_slam_tpu_torch.grid.raycast_fast as rf
from ohm_tsd_slam_tpu_torch.config import GridConfig
from ohm_tsd_slam_tpu_torch.core import se2
from ohm_tsd_slam_tpu_torch.grid.push import push
from ohm_tsd_slam_tpu_torch.grid.raycast import raycast
from ohm_tsd_slam_tpu_torch.grid.state import (
    create,
    expand_tiles,
    from_arrays,
)
from ohm_tsd_slam_tpu_torch.ops.segment_min_cuda import segment_min
from ohm_tsd_slam_tpu_torch.ops.window_replay_cuda import window_replay
from ohm_tsd_slam_tpu_torch.sensor import polar2d as tpolar
from ohm_tsd_slam_tpu_torch.utils.testing import (
    field_arrays,
    rect_walls,
    simulate_scan,
    sliver_field,
)

from golden_io import ROOM_BIN, Scenario, load_golden

jsegment_layers = jax.jit(jrf._segment_layers)

GRID = dict(map_size=8, cellsize=0.04)            # 256^2, 32x32 tiles
GEOM = dict(size=361, angular_res=math.radians(0.75),
            phi_min=math.radians(-135.0), max_range=9.0,
            min_range=0.01, low_reflectivity_range=1.0)
PUSH_POSES = [(5.12, 5.12, 0.2), (5.3, 5.2, 0.5)]
QUERY_POSES = [(5.12, 5.12, 0.2), (5.0, 5.0, 1.2), (4.5, 5.5, -1.3),
               (50.0, 50.0, 0.0)]
FIELDS = ("tsd", "weight", "tile_init", "tile_initw")


def _scan(xyt):
    pose = np.array(jse2.make(*xyt, dtype=jnp.float64))
    return simulate_scan(pose, GEOM["size"], GEOM["angular_res"],
                         GEOM["phi_min"], GEOM["max_range"],
                         segments=rect_walls(1.5, 1.5, 8.5, 8.5),
                         circles=[((7.0, 7.2), 0.5), ((3.0, 7.5), 0.35)])


def _jgrid_from(d):
    return JTsdGrid(**{f: jnp.asarray(d[f]) for f in FIELDS},
                    cell_size=d["cell_size"],
                    max_truncation=d["max_truncation"],
                    max_weight=d["max_weight"], tile_dim=d["tile_dim"])


@functools.lru_cache(maxsize=None)
def _scene(dtype_name):
    """Two scans of the room pushed by the port (held against the JAX push
    in tests/test_torch_grid.py), in both packages."""
    dt = getattr(torch, dtype_name)
    geom = tpolar.SensorPolar2D(**GEOM)
    g = create(GridConfig(**GRID), dtype=dt)
    for xyt in PUSH_POSES:
        d, m = tpolar.standard_mask(geom, torch.as_tensor(_scan(xyt),
                                                          dtype=dt))
        g = push(g, geom, se2.make(*xyt, dtype=dt), d, m)
    d = {f: getattr(g, f).numpy() for f in FIELDS}
    d.update(cell_size=g.cell_size, max_truncation=g.max_truncation,
             max_weight=g.max_weight, tile_dim=g.tile_dim)
    return _jgrid_from(d), g


@pytest.fixture(params=["float64", "float32"])
def scene(request):
    return _scene(request.param)


@pytest.fixture
def scene32():
    """The float32 scene: the kernels and their Pallas counterparts are
    float32."""
    return _scene("float32")


def _ulps(t, n):
    return n * torch.finfo(t.dtype).eps


def _beams(tgrid, xyt=(5.12, 5.12, 0.2)):
    """The port's beam geometry for one pose."""
    geom = tpolar.SensorPolar2D(**GEOM)
    pose = se2.make(*xyt, dtype=tgrid.tsd.dtype)
    return rf.beam_geometry(tgrid, geom, pose)


# ---------------------------------------------------------------- extraction

def test_segment_layers_match_jax(scene):
    jg, tg = scene
    jmask, jchans = jsegment_layers(jg)
    mask, chans = rf._segment_layers(tg)
    m = np.asarray(jmask)
    np.testing.assert_array_equal(mask.numpy(), m)
    assert m[:m.size // 4].sum() > 100            # real segments
    for got, want in zip(chans, jchans):
        # same formulas and operation order; XLA's fused code may round
        # a multiply-add once where torch rounds twice
        np.testing.assert_allclose(got.numpy()[m], np.asarray(want)[m],
                                   rtol=_ulps(got, 4), atol=0)


@pytest.mark.parametrize("field", ["pushed", "nan_noise"])
def test_segment_layers_twin_matches_pallas_kernel(scene32, field):
    """Kernel A's twin: the float32 0/1 mask and its 128-lane row counts
    equal segment_layers_pallas's, virtual layers (NaN cells) included."""
    jg, tg = scene32
    if field == "nan_noise":
        rng = np.random.default_rng(11)
        f = rng.uniform(-1, 1, (128, 128)).astype(np.float32)
        f[rng.random(f.shape) < 0.3] = np.nan
        d = field_arrays(f, 0.04)
        jg, tg = _jgrid_from(d), from_arrays(d)
    mask, cnt = rf.segment_layers_plain(tg)
    jmask, jcnt = segment_layers_pallas(jg.tsd, interpret=True)
    assert mask.dtype == torch.float32 and cnt.dtype == torch.int32
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    plane = mask.numel() // 4
    assert mask[2 * plane:].sum() > 0 or field == "pushed"


def test_pack_rows_twin_matches_pallas_kernel(scene32):
    """Kernel B's twin: the [5, S + 128] pack of the layer endpoints and
    the total count equal pack_channels_rows_pallas's on the same layers,
    with and without overflow."""
    _, tg = scene32
    mask, _ = rf.segment_layers_plain(tg)
    _, chans = rf._segment_layers(tg)
    jmask = jnp.asarray(mask.numpy())
    jchans = tuple(jnp.asarray(c.numpy()) for c in chans)
    for size in (4096, 256):
        want, jcnt = pack_channels_rows_pallas(jmask, jchans, size,
                                               interpret=True)
        got, cnt = rf.pack_rows_plain(tg, mask, size)
        assert int(cnt) == int(jcnt) == int(mask.sum())
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(cnt) > 256 + 128                   # the second size overflows


def test_extract_segments_matches_jax(scene):
    jg, tg = scene
    jseg = jrf.extract_segments_jit(jg)
    seg = rf.extract_segments(tg)
    valid = seg.valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(jseg.valid))
    # rounding as in test_segment_layers_match_jax
    np.testing.assert_allclose(seg.p0.numpy()[valid],
                               np.asarray(jseg.p0)[valid],
                               rtol=_ulps(seg.p0, 4), atol=0)
    np.testing.assert_allclose(seg.p1.numpy()[valid],
                               np.asarray(jseg.p1)[valid],
                               rtol=_ulps(seg.p1, 4), atol=0)
    assert int(seg.n_dropped) == int(jseg.n_dropped) == 0
    assert int(seg.count) == int(valid.sum()) > 100
    # the candidate pack, relative to the grid centre
    origin = jrf._pack_origin(jg, jseg.p0.dtype)
    np.testing.assert_array_equal(seg.origin.numpy(), np.asarray(origin))
    jpack, jcount = jpack_segments(jseg.p0 - origin, jseg.p1 - origin,
                                   jseg.valid, dtype=jseg.p0.dtype)
    S = seg.pack.shape[1]
    # valid columns (the JAX gather leaves garbage in the invalid ones);
    # the cross product cancels, so its error is relative to its terms
    got, want = seg.pack.numpy()[:, valid], np.asarray(jpack)[:, :S][:, valid]
    scale = np.abs(want).max(axis=1, keepdims=True)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=_ulps(seg.pack, 16) * scale.max())
    assert int(seg.count) == int(jcount)


# ----------------------------------------------------------------- candidates

@functools.lru_cache(maxsize=None)
def _small_scene(map_size, dtype_name):
    """The room of _scene on a coarser grid of 2**map_size cells a side
    (10.24 m either way), in both packages."""
    dt = getattr(torch, dtype_name)
    geom = tpolar.SensorPolar2D(**GEOM)
    g = create(GridConfig(map_size=map_size,
                          cellsize=10.24 / 2 ** map_size), dtype=dt)
    for xyt in PUSH_POSES:
        d, m = tpolar.standard_mask(geom, torch.as_tensor(_scan(xyt),
                                                          dtype=dt))
        g = push(g, geom, se2.make(*xyt, dtype=dt), d, m)
    d = {f: getattr(g, f).numpy() for f in FIELDS}
    d.update(cell_size=g.cell_size, max_truncation=g.max_truncation,
             max_weight=g.max_weight, tile_dim=g.tile_dim)
    return _jgrid_from(d), g


@pytest.mark.parametrize("dtype_name", ["float64", "float32"])
def test_general_extraction_matches_jax(dtype_name):
    """A map_size 6 grid (64 cells a row) is narrower than the fused
    kernels' 128-lane rows: extract_segments takes the dense layers and
    the channel compaction (kernel E's twin here), and gives the segments
    of the JAX package's _isocontour_segments; the caster on them renders
    as JAX's."""
    jg, tg = _small_scene(6, dtype_name)
    assert not rf.fused_extraction(tg)
    jp0, jp1, jvalid, jdropped = jrf._isocontour_segments(jg)
    seg = rf.extract_segments(tg)
    valid = seg.valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(jvalid))
    assert int(seg.n_dropped) == int(jdropped) == 0
    assert int(seg.count) == int(valid.sum()) > 50
    tol = 1e-9 if dtype_name == "float64" else 4 * float(
        torch.finfo(torch.float32).eps) * 10.24
    for got, want in ((seg.p0, jp0), (seg.p1, jp1)):
        np.testing.assert_allclose(got.numpy()[valid],
                                   np.asarray(want)[valid], rtol=0, atol=tol)
    assert not seg.p0.numpy()[~valid].any()
    if dtype_name == "float64":
        geom = tpolar.SensorPolar2D(**GEOM)
        jgeom = jpolar.SensorPolar2D(**GEOM)
        for xyt in QUERY_POSES[:1]:
            res = rf.raycast_fast(tg, geom, se2.make(*xyt, dtype=tg.tsd.dtype),
                                  segments=seg)
            jres = jrf.raycast_fast(jg, jgeom,
                                    jse2.make(*xyt, dtype=jnp.float64))
            m = np.asarray(jres.mask)
            np.testing.assert_array_equal(res.mask.numpy(), m)
            assert m.sum() > 100 and int(res.n_dropped) == 0
            np.testing.assert_allclose(res.coords.numpy()[m],
                                       np.asarray(jres.coords)[m],
                                       rtol=0, atol=1e-9)


@pytest.mark.parametrize("dtype_name", ["float64", "float32"])
def test_general_route_equals_fused_route(dtype_name, monkeypatch):
    """Two routes to one answer: on a map_size 7 grid, which the fused
    kernels take, the dense layers + channel compaction give the fused
    route's pack and count bit for bit, overflow included, and
    extract_segments takes the general route exactly when
    fused_extraction says no."""
    _, tg = _small_scene(7, dtype_name)
    assert rf.fused_extraction(tg)
    ks = rf.cuda_kernels()
    for size in (4096, 128):
        fused, n_f = rf._pack_fused(tg, size, ks)
        general, n_g = rf._pack_general(tg, size, ks)
        assert int(n_f) == int(n_g) > 128 + 128
        assert fused.dtype == general.dtype == tg.tsd.dtype
        assert torch.equal(fused, general)
    want = rf.extract_segments(tg)
    monkeypatch.setattr(rf, "fused_extraction", lambda grid: False)
    calls = []
    got = rf.extract_segments(tg, kernels=ks._replace(
        segment_layers=None, pack_rows=None,
        compact_channels=lambda *a: calls.append(1)
        or ks.compact_channels(*a)))
    assert calls == [1]
    for a, b in zip(got[:7], want[:7]):
        assert torch.equal(a, b)


def test_segment_candidates_match_jax(scene):
    """Kernel C's twin, one level, against the JAX package's per-round
    search (_segment_candidates) over its own extraction."""
    jg, tg = scene
    seg = rf.extract_segments(tg)
    jseg = jrf.extract_segments_jit(jg)
    ray, tr, idx_min, idx_max, _ = _beams(tg)
    lo = (torch.floor(idx_min) - 1.0).clamp(min=0.0)
    hi = torch.ceil(idx_max) + 1.0
    j = lambda t: jnp.asarray(t.numpy())              # noqa: E731
    for t_after in (lo, lo + 40.0):
        got = rf.segment_min_plain(seg.pack, seg.count, ray, lo, hi, t_after,
                                   tr - seg.origin)[:, 0].numpy()
        want = np.asarray(jrf._segment_candidates(
            jseg.p0, jseg.p1, jseg.valid, j(tr), j(ray), j(lo), j(hi),
            j(t_after)))
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
        fin = np.isfinite(want)
        assert fin.sum() > 100
        # the pack's cross products are taken about the grid centre and
        # split by the sensor translation, so they round differently from
        # the direct ones: the bound of the levels test below in float32
        rtol = 1e-12 if got.dtype == np.float64 else 1e-4
        np.testing.assert_allclose(got[fin], want[fin], rtol=rtol)


def test_segment_min_levels_match_pallas_and_rounds(scene32):
    """Kernel C's twin: K levels from the [8, S] pack equal
    segment_min_pallas's (interpret mode) and the sequential per-round
    searches of the JAX package (tests/test_raycast_pallas.py:83-108's
    tolerance)."""
    jg, tg = scene32
    seg = rf.extract_segments(tg)
    jseg = jrf.extract_segments_jit(jg)
    ray, tr, idx_min, _, _ = _beams(tg)
    lo = torch.zeros_like(idx_min)
    hi = torch.full_like(idx_min, 400.0)
    cover = 6.0
    tr_pack = tr - seg.origin
    got = rf.segment_min_plain(seg.pack, seg.count, ray, lo, hi, lo, tr_pack,
                               levels=4, cover=cover).numpy()
    j = lambda t: jnp.asarray(t.numpy())              # noqa: E731
    want = np.asarray(segment_min_pallas(
        j(seg.pack), pad_beams(j(ray), j(lo), j(hi), j(lo), j(tr_pack)),
        j(seg.count), levels=4, cover=cover,
        interpret=True))[:ray.shape[0]]
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    assert fin[:, 0].sum() > 100
    # XLA's CPU code contracts the cross products into multiply-adds; the
    # twin rounds every product, as kernel C does on the card
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6)

    bound = lo
    for k in range(4):
        ref = np.asarray(jrf._segment_candidates(
            jseg.p0, jseg.p1, jseg.valid, j(tr), j(ray), j(lo), j(hi),
            j(bound)))
        np.testing.assert_array_equal(np.isfinite(got[:, k]),
                                      np.isfinite(ref))
        f = np.isfinite(ref)
        np.testing.assert_allclose(got[f, k], ref[f], rtol=1e-4)
        bound = torch.from_numpy(np.where(f, ref + cover, np.inf))

    # the CPU wrapper is the twin; no segments or no open beam: no work
    np.testing.assert_array_equal(
        segment_min(seg.pack, seg.count, ray, lo, hi, lo, tr_pack, 4,
                    cover).numpy(), got)
    none = segment_min(seg.pack, torch.zeros_like(seg.count), ray, lo, hi,
                       lo, tr_pack)
    closed = segment_min(seg.pack, seg.count, ray, lo, hi,
                         torch.full_like(lo, math.inf), tr_pack)
    assert not torch.isfinite(none).any() and not torch.isfinite(closed).any()


# ------------------------------------------------------------- window replay

def test_window_replay_matches_jax(scene32):
    """Kernel D's twin against _window_events + interpolate_normal and
    window_single_pallas (interpret mode), at the tolerances of
    tests/test_raycast_pallas.py:400-414, on a scattered beam subset with
    inactive slots."""
    jg, tg = scene32
    seg = rf.extract_segments(tg)
    ray, tr, _, _, _ = _beams(tg)
    B = ray.shape[0]
    idx_min = torch.full((B,), 2.0)
    idx_max = torch.full((B,), 220.0)
    t_1 = rf.segment_min_plain(seg.pack, seg.count, ray, idx_min,
                               torch.full((B,), 230.0), idx_min,
                               tr - seg.origin)[:, 0]
    has = torch.isfinite(t_1)
    k_1 = torch.where(has, t_1, 0.0)
    CAP = 64
    rng = np.random.default_rng(0)
    idx = torch.from_numpy(np.sort(rng.choice(B, CAP, replace=False)))
    act = has[idx] & (torch.arange(CAP) < CAP - 5)
    k = torch.where(act, k_1[idx], 0.0)
    tw0 = idx_min[idx] + (torch.floor(k - idx_min[idx]) - rf.BACKOFF).clamp(
        min=0.0)
    args = (tg, k, ray[idx], idx_min[idx], idx_max[idx], act, tr)
    out = window_replay(*args).numpy()
    np.testing.assert_array_equal(out, rf.window_replay_plain(*args).numpy())
    np.testing.assert_array_equal(tw0.numpy(),
                                  rf.window_start(k, idx_min[idx]).numpy())

    j = lambda t: jnp.asarray(t.numpy())              # noqa: E731
    r_hit, r_any, r_pos, r_int = jrf._window_events(
        jg, j(tr), j(ray[idx]), j(idx_min[idx]), j(idx_max[idx]), j(k),
        j(act))
    r_n, r_nok = jinterp.interpolate_normal(
        jg, r_pos + j(ray[idx]) * (r_int[:, None] - 1.0))
    k_hit, k_any, k_pos, k_int, k_n, k_nok = window_single_pallas(
        jg, j(tw0), j(ray[idx]), j(idx_max[idx]), j(act),
        jnp.broadcast_to(j(tr), (CAP, 2)), rf.WINDOW, interpret=True)
    am = act.numpy()
    assert am.sum() > 40
    for hit, anyv, pos, interp, nrm, nok in (
            (r_hit, r_any, r_pos, r_int, r_n, r_nok),
            (k_hit, k_any, k_pos, k_int, k_n, k_nok)):
        np.testing.assert_array_equal(out[am, 1] > 0, np.asarray(anyv)[am])
        np.testing.assert_array_equal(out[am, 0] > 0, np.asarray(hit)[am])
        m = am & np.asarray(hit)
        assert m.sum() > 30
        np.testing.assert_allclose(out[m, 2:4], np.asarray(pos)[m],
                                   atol=1e-5)
        np.testing.assert_allclose(out[m, 4], np.asarray(interp)[m],
                                   atol=2e-4)
        np.testing.assert_array_equal(out[m, 7] > 0, np.asarray(nok)[m])
        nm = m & np.asarray(nok)
        np.testing.assert_allclose(out[nm, 5:7], np.asarray(nrm)[nm],
                                   atol=1e-4)
    assert not out[~am].any()                     # inactive rows are zero


def test_uninitialized_tiles_are_nan(scene):
    """The replay leaves out interpolate_bilinear's tile check: a cell of
    a tile never initialized must be NaN, which the port's push keeps."""
    _, tg = scene
    geom = tpolar.SensorPolar2D(**GEOM)
    g = create(GridConfig(**GRID), dtype=tg.tsd.dtype)
    for xyt in PUSH_POSES + [(3.0, 3.0, 2.0)]:
        d, m = tpolar.standard_mask(geom, torch.as_tensor(
            _scan(xyt), dtype=g.tsd.dtype))
        g = push(g, geom, se2.make(*xyt, dtype=g.tsd.dtype), d, m)
    uninit = ~expand_tiles(g, g.tile_init)
    assert uninit.any() and (~uninit).any()
    assert torch.isnan(g.tsd[uninit]).all()
    uninit = ~expand_tiles(tg, tg.tile_init)
    assert torch.isnan(tg.tsd[uninit]).all()


# ------------------------------------------------------------- whole caster

@pytest.mark.parametrize("cached", [True, False], ids=["cached", "inline"])
def test_raycast_fast_matches_jax(scene, cached):
    jg, tg = scene
    jgeom = jpolar.SensorPolar2D(**GEOM)
    tgeom = tpolar.SensorPolar2D(**GEOM)
    seg = rf.extract_segments(tg) if cached else None
    for xyt in QUERY_POSES:
        jr = jrf.raycast_fast_jit(jg, jgeom, jse2.make(*xyt,
                                                      dtype=jg.tsd.dtype))
        tr = rf.raycast_fast(tg, tgeom, se2.make(*xyt, dtype=tg.tsd.dtype),
                             segments=seg)
        mask = tr.mask.numpy()
        np.testing.assert_array_equal(mask, np.asarray(jr.mask))
        assert int(tr.n_dropped) == int(jr.n_dropped) == 0
        # float64: 1e-9 m, the JAX caster's own bound against the exact
        # march; float32: the tolerance of
        # tests/test_raycast_pallas.py:350-356 for the JAX kernel path
        f64 = tg.tsd.dtype == torch.float64
        np.testing.assert_allclose(tr.coords.numpy()[mask],
                                   np.asarray(jr.coords)[mask], rtol=0,
                                   atol=1e-9 if f64 else 1e-4)
        np.testing.assert_allclose(tr.normals.numpy()[mask],
                                   np.asarray(jr.normals)[mask], rtol=0,
                                   atol=1e-9 if f64 else 1e-3)
        if xyt[0] < 10:
            assert mask.mean() > 0.5
        else:
            assert not mask.any()


def test_raycast_fast_empty_grid():
    geom = tpolar.SensorPolar2D(**GEOM)
    for dt in (torch.float64, torch.float32):
        tg = create(GridConfig(**GRID), dtype=dt)
        res = rf.raycast_fast(tg, geom, se2.make(5.0, 5.0, 0.0, dtype=dt))
        assert not res.mask.any() and int(res.n_dropped) == 0
        assert not res.coords.any()


@pytest.fixture(scope="module")
def golden_final():
    """The golden room's final grid, pushed by the port (float64)."""
    if not os.path.exists(ROOM_BIN):
        pytest.skip("golden data not generated (make -C golden)")
    s = Scenario()
    geom = tpolar.SensorPolar2D(
        size=s.size, angular_res=s.angular_res, phi_min=s.phi_min,
        max_range=s.max_range, min_range=s.min_range,
        low_reflectivity_range=s.low_reflectivity_range)
    from ohm_tsd_slam_tpu_torch.grid.state import free_footprint

    g = create(GridConfig(map_size=s.layout_grid, cellsize=s.cellsize,
                          truncation_radius=s.max_trunc / s.cellsize,
                          tile_dim=2 ** s.layout_part), dtype=torch.float64)
    if s.footprint is not None:
        cx, cy, w, h = s.footprint
        g = free_footprint(g, (cx, cy), w, h)
    for pose, ranges in zip(s.push_poses, s.push_ranges):
        d, m = tpolar.standard_mask(geom, torch.as_tensor(ranges))
        g = push(g, geom, torch.as_tensor(pose), d, m)
    return s, geom, g, load_golden()


@pytest.mark.parametrize("q", range(3))
@pytest.mark.parametrize("cached", [True, False], ids=["cached", "inline"])
def test_raycast_fast_golden_parity(golden_final, q, cached):
    """tests/test_reference_parity.py:149-167 for the port's caster."""
    s, geom, g, golden = golden_final
    res = rf.raycast_fast(g, geom, torch.as_tensor(s.query_poses[q]),
                          segments=rf.extract_segments(g) if cached else None)
    ref_mask = golden["ray%02d.mask" % q].astype(bool)
    mask = res.mask.numpy()
    np.testing.assert_array_equal(mask, ref_mask)
    np.testing.assert_allclose(res.coords.numpy()[mask],
                               golden["ray%02d.coords" % q][mask], rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(res.normals.numpy()[mask],
                               golden["ray%02d.normals" % q][mask], rtol=0,
                               atol=1e-9)


# --------------------------------------------------------------- the rounds

@pytest.mark.parametrize("cached", [True, False], ids=["cached", "inline"])
def test_sliver_needs_the_rounds(monkeypatch, cached):
    """A sliver thinner than a march step: beams whose samples step over
    it must go on to the wall behind, found only by the candidate rounds.
    The caster equals the exact march and the JAX caster with its ROUNDS,
    and misses beams with one round."""
    d = field_arrays(sliver_field(256, 100, 140), 0.04)
    tg, jg = from_arrays(d), _jgrid_from(d)
    tgeom = tpolar.SensorPolar2D(**GEOM)
    xyt = (2.0, 5.12, 0.3)
    pose = se2.make(*xyt, dtype=torch.float64)
    exact = raycast(tg, tgeom, pose)
    seg = rf.extract_segments(tg) if cached else None
    fast = rf.raycast_fast(tg, tgeom, pose, segments=seg)
    jr = jrf.raycast_fast_jit(jg, jpolar.SensorPolar2D(**GEOM),
                              jse2.make(*xyt, dtype=jnp.float64))
    mask = fast.mask.numpy()
    np.testing.assert_array_equal(mask, exact.mask.numpy())
    np.testing.assert_array_equal(mask, np.asarray(jr.mask))
    np.testing.assert_allclose(fast.coords.numpy()[mask],
                               exact.coords.numpy()[mask], atol=1e-9)
    # some beams end at the wall (x = 5.62 m, 3.6 m ahead), not the sliver
    x_world = (se2.transform_points(pose, fast.coords)[:, 0]).numpy()
    assert (mask & (x_world > 5.0)).sum() > 10
    assert (mask & (x_world < 4.2)).sum() > 10

    monkeypatch.setattr(rf, "ROUNDS", 1)
    one = rf.raycast_fast(tg, tgeom, pose, segments=seg)
    assert one.mask.sum() < fast.mask.sum()


def test_unresolved_cap_is_at_least_256():
    """ROADMAP.md queue 3: the JAX formula gives 128 for 2048 < N < 8192."""
    assert all(rf.unresolved_cap(n) >= 256 for n in (361, 2048, 2049, 4000,
                                                     8191, 20000))
    assert rf.unresolved_cap(1 << 20) == (-(-(1 << 20) // 64) // 128 + 1) * 128


# ---------------------------------------------------------------- the guards

@pytest.mark.parametrize("cached", [True, False], ids=["cached", "inline"])
def test_overflow_counts_and_checked_falls_back(scene, monkeypatch, cached):
    _, tg = scene
    geom = tpolar.SensorPolar2D(**GEOM)
    pose = se2.make(5.12, 5.12, 0.2, dtype=tg.tsd.dtype)

    def render():
        seg = rf.extract_segments(tg) if cached else None
        return rf.raycast_fast(tg, geom, pose, segments=seg)

    assert int(render().n_dropped) == 0
    n_seg = int(rf.extract_segments(tg).count)
    monkeypatch.setattr(rf, "MAX_SEGMENTS", 128)
    starved = render()
    assert int(starved.n_dropped) == n_seg - 128 > 0
    checked = rf.raycast_checked(tg, geom, pose)
    exact = raycast(tg, geom, pose)
    assert int(checked.n_dropped) == int(starved.n_dropped)
    for name in ("coords", "normals", "mask", "ranges"):
        assert torch.equal(getattr(checked, name), getattr(exact, name)), name


def test_stale_cache_falls_back(scene):
    """A cache of another field counts as a full overflow: the grid
    shifted by whole cells (the JAX fingerprint cannot tell it apart) and
    a field written in place."""
    jg, tg = scene
    geom = tpolar.SensorPolar2D(**GEOM)
    B = geom.size
    pose = se2.make(5.0, 5.0, 0.9, dtype=tg.tsd.dtype)
    seg = rf.extract_segments(tg)
    assert not rf.is_stale(seg, tg)
    assert int(rf.raycast_fast(tg, geom, pose, segments=seg).n_dropped) == 0

    shifted = from_arrays({**{f: getattr(tg, f).numpy() for f in FIELDS},
                           "tsd": np.roll(tg.tsd.numpy(), 3, axis=1),
                           "cell_size": tg.cell_size,
                           "max_truncation": tg.max_truncation,
                           "max_weight": tg.max_weight,
                           "tile_dim": tg.tile_dim})
    # the JAX package's checksum cannot tell the shifted field apart
    assert int(jrf.grid_fingerprint(jnp.asarray(shifted.tsd.numpy()))) == int(
        jrf.grid_fingerprint(jg.tsd))
    written = from_arrays({**{f: getattr(tg, f).numpy() for f in FIELDS},
                           "cell_size": tg.cell_size,
                           "max_truncation": tg.max_truncation,
                           "max_weight": tg.max_weight,
                           "tile_dim": tg.tile_dim})
    seg_w = rf.extract_segments(written)
    written.tsd[10, 10] = 0.5                     # bumps the version
    for grid, cache in ((shifted, seg), (written, seg_w)):
        assert rf.is_stale(cache, grid)
        stale = rf.raycast_fast(grid, geom, pose, segments=cache)
        assert int(stale.n_dropped) >= B
        checked = rf.raycast_checked(grid, geom, pose, segments=cache)
        exact = raycast(grid, geom, pose)
        assert torch.equal(checked.mask, exact.mask)
        assert torch.equal(checked.coords, exact.coords)
        fresh = rf.raycast_fast(grid, geom, pose,
                                segments=rf.extract_segments(grid))
        assert int(fresh.n_dropped) == 0


def test_cpu_grid_runs_the_twins(scene, monkeypatch):
    """For a grid on the CPU each wrapper runs its kernel's twin (float32
    and float64 alike) and counts no launch."""
    import importlib

    names = ("segment_layers", "pack_rows", "segment_min", "window_replay",
             "window_rounds")
    mods = [importlib.import_module(
        "ohm_tsd_slam_tpu_torch.ops."
        f"{'window_replay' if n == 'window_rounds' else n}_cuda")
        for n in names]
    calls = []
    for n, mod in zip(names, mods):
        twin = getattr(mod, f"{n}_plain")

        def counted(*args, _twin=twin, _n=n, **kwargs):
            calls.append(_n)
            return _twin(*args, **kwargs)

        monkeypatch.setattr(mod, f"{n}_plain", counted)
    _, tg = scene
    launches = [getattr(mod, n).launches for n, mod in zip(names, mods)]
    geom = tpolar.SensorPolar2D(**GEOM)
    res = rf.raycast_fast(tg, geom, se2.make(5.0, 5.0, 0.4,
                                             dtype=tg.tsd.dtype))
    assert res.mask.sum() > 100 and res.coords.dtype == tg.tsd.dtype
    assert sorted(set(calls)) == sorted(names)
    assert calls.count("segment_min") == 2
    # round 1, then one call for rounds 2..ROUNDS
    assert calls.count("window_replay") == 1
    assert calls.count("window_rounds") == 1
    assert launches == [getattr(mod, n).launches
                        for n, mod in zip(names, mods)]
