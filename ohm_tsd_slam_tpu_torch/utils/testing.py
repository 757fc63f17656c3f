"""Synthetic scene generation for tests and benchmarks (a copy of
ohm_tsd_slam_tpu/utils/testing.py).

The reference ships no tests or fixtures (SURVEY.md §4); we build our own:
an analytic 2D world (line segments + circles) and an exact laser-scan
simulator, so SLAM runs can be checked against ground-truth geometry.
Pure NumPy (float64) — this is test scaffolding, not a compute path.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np


def rect_walls(x0: float, y0: float, x1: float, y1: float) -> List[Tuple]:
    """Axis-aligned rectangle as four segments (a "room")."""
    return [
        ((x0, y0), (x1, y0)),
        ((x1, y0), (x1, y1)),
        ((x1, y1), (x0, y1)),
        ((x0, y1), (x0, y0)),
    ]


def _ray_segment_t(origin, direction, a, b):
    """Smallest positive ray parameter t with origin + t*dir on segment
    ab, or inf."""
    ax, ay = a
    bx, by = b
    ox, oy = origin
    dx, dy = direction
    ex, ey = bx - ax, by - ay
    denom = dx * ey - dy * ex
    if abs(denom) < 1e-15:
        return math.inf
    t = ((ax - ox) * ey - (ay - oy) * ex) / denom
    u = ((ax - ox) * dy - (ay - oy) * dx) / denom
    if t > 0 and 0.0 <= u <= 1.0:
        return t
    return math.inf


def _ray_circle_t(origin, direction, center, radius):
    ox, oy = origin
    cx, cy = center
    fx, fy = ox - cx, oy - cy
    a = direction[0] ** 2 + direction[1] ** 2
    b = 2 * (fx * direction[0] + fy * direction[1])
    c = fx * fx + fy * fy - radius * radius
    disc = b * b - 4 * a * c
    if disc < 0:
        return math.inf
    sq = math.sqrt(disc)
    for t in ((-b - sq) / (2 * a), (-b + sq) / (2 * a)):
        if t > 0:
            return t
    return math.inf


def simulate_scan(pose: np.ndarray, size: int, angular_res: float,
                  phi_min: float, max_range: float,
                  segments: Sequence[Tuple] = (),
                  circles: Sequence[Tuple] = ()) -> np.ndarray:
    """Exact ranges of a polar scan from SE(2) `pose` in a world of
    segments [((x,y),(x,y)), ...] and circles [((cx,cy), r), ...].

    Beams with no intersection within max_range return inf (the
    "no return" convention of sensor_msgs/LaserScan after the reference's
    maskInvalidDepth)."""
    origin = pose[:2, 2]
    R = pose[:2, :2]
    ranges = np.full(size, np.inf)
    for i in range(size):
        phi = phi_min + i * angular_res
        d_local = np.array([math.cos(phi), math.sin(phi)])
        d = R @ d_local
        t_best = math.inf
        for (a, b) in segments:
            t_best = min(t_best, _ray_segment_t(origin, d, a, b))
        for (c, r) in circles:
            t_best = min(t_best, _ray_circle_t(origin, d, c, r))
        if t_best <= max_range:
            ranges[i] = t_best
    return ranges


# ---------------------------------------------------------------------------
# synthetic TSD fields for the fast caster (grid/raycast_fast.py)
# ---------------------------------------------------------------------------

def sliver_field(cells: int, sliver_col: int, wall_col: int,
                 depth: float = -0.2, rows=None) -> np.ndarray:
    """[cells, cells] field: free space (+1) but for one column of cells
    at `sliver_col` of value `depth` (in the row range `rows`, default
    all) and a solid wall (-1) from column `wall_col` on.  The sliver's
    negative band is narrower than a cell (|depth| / (1 + |depth|) of
    one), so the march can step over it without a sign change: a beam
    that does must go on to the wall, which the fast caster finds only in
    its later candidate rounds."""
    f = np.ones((cells, cells))
    r0, r1 = rows if rows is not None else (0, cells)
    f[r0:r1, sliver_col] = depth
    f[:, wall_col:] = -1.0
    return f


def noise_field(cells: int, seed: int = 0,
                nan_fraction: float = 0.1) -> np.ndarray:
    """[cells, cells] field of uniform noise in [-1, 1] with a share of
    NaN cells: nearly every quad is crossed, so the isocontour segments
    exceed any fixed capacity."""
    rng = np.random.default_rng(seed)
    f = rng.uniform(-1.0, 1.0, (cells, cells))
    f[rng.random((cells, cells)) < nan_fraction] = np.nan
    return f


def field_arrays(tsd: np.ndarray, cell_size: float, tile_dim: int = 32,
                 max_truncation: float = 0.1, max_weight: float = 300.0):
    """A grid state dict (grid/state.py::from_arrays) holding `tsd`, with
    every tile initialized and unit weights."""
    tiles = tsd.shape[0] // tile_dim
    return dict(tsd=tsd, weight=np.ones_like(tsd),
                tile_init=np.ones((tiles, tiles), bool),
                tile_initw=np.zeros((tiles, tiles), tsd.dtype),
                cell_size=cell_size, max_truncation=max_truncation,
                max_weight=max_weight, tile_dim=tile_dim)
