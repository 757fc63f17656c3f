"""Synthetic scene generation for tests and benchmarks (a copy of
ohm_tsd_slam_tpu/utils/testing.py, plus the room of the card tests).

The reference ships no tests or fixtures (SURVEY.md §4); we build our own:
an analytic 2D world (line segments + circles) and an exact laser-scan
simulator, so SLAM runs can be checked against ground-truth geometry.
Pure NumPy (float64) — this is test scaffolding, not a compute path.

The room (`world`, `narrow_world`, `scan_ranges`, `trajectory`) and the
upstream deployments as flat parameter dicts (`DOUBLE_LASER`,
`SINGLE_LASER`, `NARROW`) are what the port's `cuda` tests and
tools/torch_kernel_times.py drive through the node on the card.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np


def limit_cpu_threads() -> None:
    """Run torch's CPU operators on one thread in this process.

    The port's CPU tests call this when imported: a test runner with
    several worker processes (pytest -n) otherwise starts one intra-op
    thread per core in every worker, next to XLA's own pools, and the
    oversubscribed cores slow each worker many times over.  The tests'
    tensors are small, so one thread loses little.  The library itself
    never changes torch's thread count."""
    import torch

    if torch.get_num_threads() != 1:
        torch.set_num_threads(1)


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


def fence_segments(n: int, x0: float, y0: float, pitch: float = 0.001,
                   half: float = 2.0):
    """Endpoints p0, p1 [n, 2] of `n` parallel segments of length 2 * half
    across the x axis, `pitch` apart from (x0, y0) on: a beam from just
    before them along +x crosses every one, far more candidates than the
    candidate sweep keeps for a beam, and a slanted beam crosses some."""
    x = x0 + pitch * np.arange(n)
    p0 = np.stack([x, np.full(n, y0 - half)], axis=1)
    p1 = np.stack([x, np.full(n, y0 + half)], axis=1)
    return p0, p1


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


# ---------------------------------------------------------------------------
# the room and the deployments of the card tests
# ---------------------------------------------------------------------------

BEAMS = 1081                 # -135 deg in 0.25 deg steps (270 deg)
PHI_MIN = math.radians(-135.0)
RES = math.radians(0.25)

# configs/double-laser.yaml, as a flat parameter dict
DOUBLE_LASER = {
    "map_size": 10, "cellsize": 0.025, "truncation_radius": 3.0,
    "occ_grid_time_interval": 2.0,
    "robot_nbr": 2, "robot_0/name": "robot0", "robot_1/name": "robot1",
    "registration_mode": 0, "icp_iterations": 25,
    "trials": 50, "epsThresh": 0.15, "sizeControlSet": 140,
    "robot0/max_range": 30.0, "robot0/min_range": 0.01,
    "robot0/local_offset_x": 0.0, "robot0/local_offset_y": 0.0,
    "robot0/local_offset_yaw": 0.0,
    "robot1/max_range": 20.0, "robot1/min_range": 0.01,
    "robot1/local_offset_x": 0.5, "robot1/local_offset_y": 0.0,
    "robot1/local_offset_yaw": 3.14159265,
}

# configs/single-laser.yaml, as a flat parameter dict: one robot, the
# TSD-likelihood RANSAC seed before ICP (the reference's shipped default)
SINGLE_LASER = {
    "map_size": 10, "cellsize": 0.025, "truncation_radius": 3.0,
    "occ_grid_time_interval": 2.0, "x_off_factor": 0.5, "y_off_factor": 0.5,
    "max_range": 30.0, "min_range": 0.01, "low_reflectivity_range": 2.0,
    "laser_min_range": 0.0,
    "registration_mode": 3, "icp_iterations": 30,
    "dist_filter_min": 0.2, "dist_filter_max": 1.0,
    "reg_trs_max": 0.25, "reg_sin_rot_max": 0.17,
    "trials": 100, "epsThresh": 0.15, "sizeControlSet": 180,
    "ransac_phi_max": 30.0,
    "zhit": 0.45, "zshort": 0.25, "zmax": 0.05, "zrand": 0.25,
    "sighit": 0.2, "lamshort": 0.08, "rangemax": 20.0,
    "percentagePointsInC": 0.9,
    "pub_tsd_color_map": True, "use_object_inflation": False,
    "object_inflation_factor": 2,
    "footprint_width": 1.0, "footprint_height": 1.0,
    "footprint_x_offset": 0.28,
}

# a walkable room on a grid narrower than kernels A and B take: 64 cells
# of 0.1 m a side
NARROW = {
    "map_size": 6, "cellsize": 0.1, "truncation_radius": 3.0,
    "registration_mode": 0, "icp_iterations": 25,
    "max_range": 30.0, "min_range": 0.01,
    "footprint_width": 0.6, "footprint_height": 0.6,
    "footprint_x_offset": 0.0,
}


def world():
    """A 13.6 m x 11.6 m room in the 25.6 m grid (segments, circles).
    Robot1 starts facing the wall robot0 cannot see, so the two boxes, the
    wall stubs and the pillars north and south of the start, in both
    robots' fields of view, give robot1 something to register against."""
    segs = rect_walls(6.0, 7.0, 19.6, 18.6)
    segs += rect_walls(15.5, 14.5, 16.7, 15.4)
    segs += rect_walls(11.0, 9.0, 12.0, 9.8)
    segs += [((9.0, 16.0), (11.5, 16.0)), ((13.5, 16.5), (13.5, 18.6))]
    circles = [((10.0, 10.0), 0.4), ((16.5, 10.5), 0.3), ((14.2, 15.8), 0.3)]
    return segs, circles


def narrow_world():
    """NARROW's room: walls 0.7 m inside its 6.4 m grid and two pillars."""
    return (rect_walls(0.7, 0.7, 5.7, 5.7),
            [((4.6, 4.5), 0.35), ((1.9, 4.4), 0.3)])


def scan_ranges(xyt, max_range, scene=world):
    """The BEAMS-beam scan of `scene` from the pose (x, y, theta)."""
    x, y, th = xyt
    pose = np.array([[math.cos(th), -math.sin(th), x],
                     [math.sin(th), math.cos(th), y], [0.0, 0.0, 1.0]])
    segs, circles = scene()
    return simulate_scan(pose, BEAMS, RES, PHI_MIN, max_range,
                         segments=segs, circles=circles)


def trajectory(start, n, turn_deg=0.5):
    """n poses from `start`, ~2 cm and `turn_deg` a scan."""
    x, y, th = start
    out = []
    for _ in range(n):
        out.append((x, y, th))
        x += 0.02 * math.cos(th)
        y += 0.02 * math.sin(th)
        th += math.radians(turn_deg)
    return out
