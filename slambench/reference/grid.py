"""The plain reference's map: the TSD grid, the scan model, the exact
ray march, the fusion push and the occupancy grid, in plain PyTorch.

A frozen, self-contained copy of the straightforward path of the SLAM
system under test (ohm_tsd_slam_tpu_torch's grid/state.py,
grid/interpolate.py, grid/raycast.py, grid/push.py, grid/axis_aligned.py,
grid/color.py, sensor/polar2d.py, core/se2.py): dense tensor programs over
the whole grid, no kernels, no caches, no graphs.  It imports nothing of
the program and takes nothing the program made; the benchmark hands it
the same scans and settings it hands the program.

The render is the exact dense march, where the program runs its
isocontour caster: the caster replays the exact march where a beam can
hit first, so the two agree beam for beam up to rounding.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

TSDINC = 1.0
SUCCESS, INVALIDINDEX, EMPTYPARTITION, ISNAN = 0, 1, 2, 3
BELOW_FOV, ABOVE_FOV = -2, -1


# ---------------------------------------------------------------- SE(2)

def se2_make(x, y, theta, dtype, device) -> torch.Tensor:
    x, y, theta = (torch.full((), float(v), dtype=dtype, device=device)
                   for v in (x, y, theta))
    c, s = torch.cos(theta), torch.sin(theta)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, x]), torch.stack([s, c, y]),
                        torch.stack([zero, zero, one])])


def se2_invert(T: torch.Tensor) -> torch.Tensor:
    tix = -(T[0, 0] * T[0, 2] + T[1, 0] * T[1, 2])
    tiy = -(T[0, 1] * T[0, 2] + T[1, 1] * T[1, 2])
    zero, one = torch.zeros_like(tix), torch.ones_like(tix)
    return torch.stack([torch.stack([T[0, 0], T[1, 0], tix]),
                        torch.stack([T[0, 1], T[1, 1], tiy]),
                        torch.stack([zero, zero, one])])


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    x, y = pts[..., 0], pts[..., 1]
    return torch.stack([T[0, 0] * x + T[0, 1] * y + T[0, 2],
                        T[1, 0] * x + T[1, 1] * y + T[1, 2]], dim=-1)


def rotate_vectors(T: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    x, y = v[..., 0], v[..., 1]
    return torch.stack([T[0, 0] * x + T[0, 1] * y,
                        T[1, 0] * x + T[1, 1] * y], dim=-1)


def angle_02pi(T: torch.Tensor) -> torch.Tensor:
    """The angle in [0, 2π) from asin/acos of the rotation entries, 0 when
    the sign pattern matches neither branch (ThreadLocalize::calcAngle)."""
    arcsin = torch.asin(T[1, 0].clamp(-1.0, 1.0))
    arcsineg = torch.asin(T[0, 1].clamp(-1.0, 1.0))
    arccos = torch.acos(T[0, 0].clamp(-1.0, 1.0))
    zero = torch.zeros_like(arccos)
    return torch.where((arcsin > 0.0) & (arcsineg < 0.0), arccos,
                       torch.where((arcsin < 0.0) & (arcsineg > 0.0),
                                   2.0 * math.pi - arccos, zero))


# ---------------------------------------------------------------- sensor

@dataclass(frozen=True)
class Sensor:
    """A polar scan's geometry: beam i looks along phi_min + i·res."""

    size: int
    res: float
    phi_min: float
    max_range: float
    min_range: float
    low_reflectivity_range: float

    def rays(self, dtype, device) -> torch.Tensor:
        phi = self.phi_min + torch.arange(self.size, dtype=dtype,
                                          device=device) * self.res
        return torch.stack([torch.cos(phi), torch.sin(phi)], dim=-1)


def back_project(sensor: Sensor, pose, points) -> torch.Tensor:
    """The beam index of world points, or BELOW_FOV / ABOVE_FOV; the
    resolution divides as a tensor (the IEEE quotient on every device)."""
    local = transform_points(se2_invert(pose), points)
    phi = torch.atan2(local[..., 1], local[..., 0])
    res = torch.full((), sensor.res, dtype=phi.dtype, device=phi.device)
    idx = torch.floor((phi - sensor.phi_min) / res + 0.5).to(torch.int32)
    idx = torch.where(phi <= sensor.phi_min - 0.5 * sensor.res,
                      torch.full_like(idx, BELOW_FOV), idx)
    return torch.where(
        phi >= sensor.phi_min + (sensor.size - 0.5) * sensor.res,
        torch.full_like(idx, ABOVE_FOV), idx)


def standard_mask(sensor: Sensor, data: torch.Tensor):
    """Zero depth, ranges past max_range (to +inf), NaNs, and beams at a
    depth discontinuity under 3 degrees are masked."""
    mask = data != 0.0
    data = torch.where(data > sensor.max_range, math.inf, data)
    isnan = torch.isnan(data)
    mask = mask & ~isnan
    data = torch.where(isnan, math.inf, data)

    res = torch.full((), sensor.res, dtype=data.dtype, device=data.device)
    cosphi, sinphi = torch.cos(res), torch.sin(res)
    betamin = torch.full_like(data, math.pi)
    for shift in (-1, 1):
        b = torch.roll(data, -shift)
        c = torch.sqrt(data * data + b * b - 2.0 * data * b * cosphi)
        beta = torch.asin(torch.clamp(b / c * sinphi, -1.0, 1.0))
        consider = (data > b) & ~torch.isinf(b)
        betamin = torch.where(consider, torch.minimum(betamin, beta),
                              betamin)
    interior = torch.zeros_like(mask)
    interior[1:-1] = True
    cut = interior & ~torch.isinf(data) & (betamin < math.radians(3.0))
    return data, mask & ~cut


def to_cartesian(sensor: Sensor, data, mask):
    valid = mask & ~torch.isinf(data)
    coords = torch.where(valid[:, None],
                         sensor.rays(data.dtype, data.device)
                         * data[:, None], 0.0)
    return coords, valid


# ---------------------------------------------------------------- grid

@dataclass(frozen=True)
class Grid:
    tsd: torch.Tensor          # [H, W], NaN = unwritten
    weight: torch.Tensor       # [H, W]
    tile_init: torch.Tensor    # [TY, TX] bool
    tile_initw: torch.Tensor   # [TY, TX]
    cell_size: float
    max_truncation: float
    max_weight: float
    tile_dim: int

    @property
    def cells(self) -> int:
        return self.tsd.shape[0]

    @property
    def tiles(self) -> int:
        return self.tile_init.shape[0]


def create(map_size: int, cell_size: float, truncation_radius: float,
           dtype, device, tile_dim: int = 32,
           max_weight: float = 32.0) -> Grid:
    n = 2 ** map_size
    t = n // tile_dim
    return Grid(
        tsd=torch.full((n, n), math.nan, dtype=dtype, device=device),
        weight=torch.zeros((n, n), dtype=dtype, device=device),
        tile_init=torch.zeros((t, t), dtype=torch.bool, device=device),
        tile_initw=torch.zeros((t, t), dtype=dtype, device=device),
        cell_size=float(cell_size),
        max_truncation=max(truncation_radius * cell_size, 2.0 * cell_size),
        max_weight=float(max_weight), tile_dim=int(tile_dim))


def expand_tiles(grid: Grid, tiles: torch.Tensor) -> torch.Tensor:
    p = grid.tile_dim
    return tiles.repeat_interleave(p, 0).repeat_interleave(p, 1)


def cell_centers(grid: Grid):
    x = (torch.arange(grid.cells, dtype=grid.tsd.dtype,
                      device=grid.tsd.device) + 0.5) * grid.cell_size
    return x, x


def free_footprint(grid: Grid, center, width: float, height: float) -> Grid:
    """TSDINC into the cells of a rectangle around `center`, the touched
    tiles materialized (the cells of an empty one take its init values)."""
    s = grid.cell_size
    cx, cy = float(center[0]), float(center[1])
    x0 = math.floor((cx - width * 0.5) / s + 0.5)
    x1 = math.floor((cx + width * 0.5) / s + 0.5)
    y0 = math.floor((cy - height * 0.5) / s + 0.5)
    y1 = math.floor((cy + height * 0.5) / s + 0.5)
    if not (x0 >= 0 and x1 <= grid.cells and y0 >= 0 and y1 <= grid.cells):
        return grid
    i = torch.arange(grid.cells, device=grid.tsd.device)
    rect = ((i >= y0) & (i < y1))[:, None] & ((i >= x0) & (i < x1))[None, :]
    td = grid.tile_dim
    touched = rect.reshape(grid.tiles, td, grid.tiles, td).any(3).any(1)
    was_empty = touched & ~grid.tile_init & (grid.tile_initw > 0.0)
    cell_empty = expand_tiles(grid, was_empty)
    tsd = torch.where(cell_empty, TSDINC, grid.tsd)
    weight = torch.where(cell_empty, expand_tiles(grid, grid.tile_initw),
                         grid.weight)
    return dataclasses.replace(grid, tsd=torch.where(rect, TSDINC, tsd),
                               weight=weight,
                               tile_init=grid.tile_init | touched)


def _tap(grid: Grid, ix, iy):
    n = grid.cells
    oob = (ix < 0) | (ix >= n) | (iy < 0) | (iy >= n)
    val = grid.tsd.reshape(-1)[iy.clamp(0, n - 1) * n + ix.clamp(0, n - 1)]
    return torch.where(oob, math.nan, val)


def interpolate(grid: Grid, coords: torch.Tensor):
    """Bilinear TSD at world coordinates and the interpolation code."""
    s = grid.cell_size
    u = coords[..., 0] / s - 0.5
    v = coords[..., 1] / s - 0.5
    ix = torch.floor(u).to(torch.int64)
    iy = torch.floor(v).to(torch.int64)
    wx = u - ix.to(u.dtype)
    wy = v - iy.to(v.dtype)
    n = grid.cells
    valid = (ix >= 0) & (ix < n) & (iy >= 0) & (iy < n)
    td = grid.tile_dim
    tx = torch.div(ix, td, rounding_mode="floor").clamp(0, grid.tiles - 1)
    ty = torch.div(iy, td, rounding_mode="floor").clamp(0, grid.tiles - 1)
    tile_ok = grid.tile_init.reshape(-1)[ty * grid.tiles + tx]
    tsd = (_tap(grid, ix, iy) * (1.0 - wy) * (1.0 - wx)
           + _tap(grid, ix, iy + 1) * wy * (1.0 - wx)
           + _tap(grid, ix + 1, iy) * (1.0 - wy) * wx
           + _tap(grid, ix + 1, iy + 1) * wy * wx)
    code = torch.where(torch.isnan(tsd), ISNAN, SUCCESS)
    code = torch.where(tile_ok, code, EMPTYPARTITION)
    code = torch.where(valid, code, INVALIDINDEX)
    return torch.where(code == SUCCESS, tsd, math.nan), code


def normal(grid: Grid, coords: torch.Tensor):
    """Central differences of bilinear taps at ±cellSize, normalized."""
    s = grid.cell_size
    ex = torch.zeros_like(coords)
    ex[..., 0] = s
    ey = torch.zeros_like(coords)
    ey[..., 1] = s
    xp, cxp = interpolate(grid, coords + ex)
    xm, cxm = interpolate(grid, coords - ex)
    yp, cyp = interpolate(grid, coords + ey)
    ym, cym = interpolate(grid, coords - ey)
    ok = ((cxp == SUCCESS) & (cxm == SUCCESS) & (cyp == SUCCESS)
          & (cym == SUCCESS))
    n = torch.stack([xp - xm, yp - ym], dim=-1)
    norm = torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True))
    n = n / torch.where(norm > 0, norm, 1.0)
    return torch.where(ok[..., None], n, math.nan), ok


# ---------------------------------------------------------------- render

def _first_true(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.uint8).argmax(dim=-1)


def raycast(grid: Grid, sensor: Sensor, pose: torch.Tensor):
    """The model scan from `pose` by the exact march: every beam sampled
    at every cell step, the first +→− sign change a hit, −→+ a back face,
    a coarse skip over empty tiles first.  Returns (coords [B, 2] and
    normals [B, 2] in the sensor frame, mask [B])."""
    dtype, dev = grid.tsd.dtype, grid.tsd.device
    s = grid.cell_size
    rays = sensor.rays(dtype, dev)
    x, y = rays[:, 0], rays[:, 1]
    ray = torch.stack([pose[0, 0] * x + pose[0, 1] * y,
                       pose[1, 0] * x + pose[1, 1] * y], dim=-1) * s
    tr = pose[:2, 2]
    tx, ty = tr[0], tr[1]
    top = grid.cells * s
    inside = (tx > 0.0) & (tx < top) & (ty > 0.0) & (ty < top)
    def_min = (1.0 - 2.0 * inside.to(dtype)) * 10e9
    dim = (grid.cells - 1) * s
    rx, ry = ray[:, 0], ray[:, 1]
    zero = torch.zeros_like(rx)
    xmin = torch.where(rx.abs() > 10e-6,
                       (torch.where(rx > 0.0, zero, dim) - tx) / rx, def_min)
    ymin = torch.where(ry.abs() > 10e-6,
                       (torch.where(ry > 0.0, zero, dim) - ty) / ry, def_min)
    xmax = torch.where(rx.abs() > 10e-6,
                       (torch.where(rx > 0.0, dim, zero) - tx) / rx, -def_min)
    ymax = torch.where(ry.abs() > 10e-6,
                       (torch.where(ry > 0.0, dim, zero) - ty) / ry, -def_min)
    idx_min = torch.maximum(xmin, ymin).clamp(min=0.0)
    idx_min = idx_min.clamp(min=sensor.min_range / s)
    idx_max = torch.minimum(xmax, ymax).clamp(max=sensor.max_range / s)
    feasible = idx_min < idx_max

    steps = int(math.ceil(sensor.max_range / s)) + 2
    part = float(grid.tile_dim)
    m = torch.arange(int(math.ceil(steps / part)) + 1, dtype=dtype,
                     device=dev)
    t_coarse = idx_min[:, None] + m[None, :] * part
    coarse_valid = t_coarse < idx_max[:, None]
    _, code_c = interpolate(grid, tr + t_coarse[..., None] * ray[:, None, :])
    informative = ((code_c != EMPTYPARTITION) & (code_c != INVALIDINDEX)
                   & coarse_valid)
    last_valid = (coarse_valid.sum(dim=1) - 1).clamp(min=0)
    skip = torch.where(informative.any(dim=1),
                       (_first_true(informative) - 1).clamp(min=0),
                       last_valid)
    idx_start = idx_min + skip.to(dtype) * part

    k = torch.arange(steps + 1, dtype=dtype, device=dev)
    t = idx_start[:, None] + k[None, :]
    pos = tr + t[..., None] * ray[:, None, :]
    tsd, code = interpolate(grid, pos)
    v = torch.where(code == SUCCESS, tsd, math.nan)
    step_valid = (t[:, 1:] - 1.0) <= idx_max[:, None]
    v_prev, v_cur = v[:, :-1], v[:, 1:]
    ev_pos = (v_prev > 0) & (v_cur < 0) & step_valid
    ev = ev_pos | ((v_prev < 0) & (v_cur > 0) & step_valid)
    kk = _first_true(ev)[:, None]
    hit = ev.any(dim=1) & torch.gather(ev_pos, 1, kk)[:, 0]
    vp = torch.gather(v_prev, 1, kk)[:, 0]
    vc = torch.gather(v_cur, 1, kk)[:, 0]
    pos_ev = torch.gather(pos[:, 1:, :], 1,
                          kk[:, :, None].expand(-1, 1, 2))[:, 0, :]
    coords_w = pos_ev + ray * (vp / (vp - vc) - 1.0)[:, None]
    normals_w, n_ok = normal(grid, coords_w)

    mask = feasible & hit & n_ok
    inv = se2_invert(pose)
    coords = torch.where(mask[:, None], transform_points(inv, coords_w), 0.0)
    normals = torch.where(mask[:, None], rotate_vectors(inv, normals_w), 0.0)
    return coords, normals, mask


# ---------------------------------------------------------------- push

def _tile_cull(grid: Grid, sensor: Sensor, pose, data, mask):
    """Which tiles a scan updates, which it traverses whole (emptiness),
    and each tile's weight ((maxRange - distance) / maxRange)²."""
    dtype, dev = grid.tsd.dtype, grid.tsd.device
    p, s = grid.tile_dim, grid.cell_size
    tr = pose[:2, 2]
    c = (torch.arange(grid.tiles, dtype=dtype, device=dev) * p
         + (p + 1) * 0.5) * s
    dx = c[None, :] - tr[0]
    dy = c[:, None] - tr[1]
    distance = torch.sqrt(dx * dx + dy * dy)
    circumradius = math.sqrt(2.0) * (p * s) * 0.5
    closest = distance - circumradius - grid.max_truncation
    farthest = distance + circumradius + grid.max_truncation
    in_window = (closest <= sensor.max_range) & (farthest >= sensor.min_range)

    e0 = (torch.arange(grid.tiles, dtype=dtype, device=dev) * p + 0.5) * s
    e1 = e0 + p * s
    shape = (grid.tiles, grid.tiles)
    ex = torch.stack([a[None, :].expand(shape) for a in (e0, e1, e0, e1)], -1)
    ey = torch.stack([a[:, None].expand(shape) for a in (e0, e0, e1, e1)], -1)
    idx = back_project(sensor, pose, torch.stack([ex, ey], dim=-1))
    seen = (idx != BELOW_FOV) & (idx != ABOVE_FOV)
    mapped = torch.where(idx == ABOVE_FOV, sensor.size - 1,
                         torch.where(idx == BELOW_FOV, 0, idx))
    lo, hi = mapped.amin(dim=-1), mapped.amax(dim=-1)
    beams = torch.arange(sensor.size, device=dev)
    in_span = (beams >= lo[..., None]) & (beams <= hi[..., None])
    visible = (in_span & (data > closest[..., None]) & mask).any(dim=-1)
    empty_beam = torch.where(
        torch.isinf(data),
        (distance < sensor.low_reflectivity_range)[..., None],
        (data > farthest[..., None]) & mask)
    is_empty = (~in_span | empty_beam).all(dim=-1)
    base = in_window & seen.any(dim=-1) & visible
    empty_inc = base & seen.all(dim=-1) & is_empty
    max_range = torch.full((), sensor.max_range, dtype=dtype, device=dev)
    part_weight = ((sensor.max_range - distance.clamp(max=sensor.max_range))
                   / max_range) ** 2
    return base & ~empty_inc, empty_inc, part_weight


def push(grid: Grid, sensor: Sensor, pose, data, mask) -> Grid:
    """Fuse one masked scan into the grid: the weighted running average of
    the truncated signed distance in the tiles the scan touches, and one
    more emptiness step in those it traverses whole."""
    dtype = grid.tsd.dtype
    trunc = grid.max_truncation
    tr = pose[:2, 2]
    touch, empty_inc, part_weight = _tile_cull(grid, sensor, pose, data,
                                               mask)
    newly = touch & ~grid.tile_init
    was_empty = newly & (grid.tile_initw > 0.0)
    c_empty = expand_tiles(grid, was_empty)
    c_plain = expand_tiles(grid, newly & ~was_empty)
    tsd0 = torch.where(c_empty, TSDINC,
                       torch.where(c_plain, math.nan, grid.tsd))
    w0 = torch.where(c_empty, expand_tiles(grid, grid.tile_initw),
                     torch.where(c_plain, 0.0, grid.weight))

    xs, ys = cell_centers(grid)
    shape = (grid.cells, grid.cells)
    cells = torch.stack([xs[None, :].expand(shape),
                         ys[:, None].expand(shape)], dim=-1)
    idx = back_project(sensor, pose, cells)
    d = torch.where(mask, data, math.nan)[
        idx.clamp(0, sensor.size - 1).to(torch.int64)]
    m = ~torch.isnan(d) & (idx >= 0)
    dx = cells[..., 0] - tr[0]
    dy = cells[..., 1] - tr[1]
    dist = torch.sqrt(dx * dx + dy * dy)
    finite = ~torch.isinf(d)
    sd = torch.where(finite, d - dist, trunc)
    add = m & (finite | (dist < sensor.low_reflectivity_range))
    accept = add & expand_tiles(grid, touch) & (sd >= -trunc)
    tsd_new = (sd / torch.full((), trunc, dtype=dtype, device=sd.device)
               ).clamp(max=TSDINC)
    w_meas = (torch.where(sd.abs() < -grid.cell_size / 2.0,
                          torch.ones_like(sd), 0.01)
              * expand_tiles(grid, part_weight))
    nan0 = torch.isnan(tsd0)
    denom = w0 + w_meas
    tsd1 = torch.where(accept, torch.where(nan0, tsd_new,
                                           (tsd0 * w0 + tsd_new * w_meas)
                                           / denom), tsd0)
    w1 = torch.where(accept, torch.where(nan0, denom,
                                         denom.clamp(max=grid.max_weight)),
                     w0)

    c_inc = expand_tiles(grid, empty_inc & grid.tile_init)
    nan1 = torch.isnan(tsd1)
    w_e = torch.where(nan1, w1 + 1.0, (w1 + 1.0).clamp(max=grid.max_weight))
    tsd_e = torch.where(nan1, TSDINC, (tsd1 * (w_e - 1.0) + 1.0) / w_e)
    initw = torch.where(empty_inc & ~grid.tile_init,
                        (grid.tile_initw + 1.0).clamp(max=grid.max_weight),
                        grid.tile_initw)
    return dataclasses.replace(
        grid, tsd=torch.where(c_inc, tsd_e, tsd1),
        weight=torch.where(c_inc, w_e, w1),
        tile_init=grid.tile_init | touch, tile_initw=initw)


# ---------------------------------------------------------------- publication

def _shift_tiles(tiles: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    dev = tiles.device
    rows = torch.arange(tiles.shape[0], device=dev)[:, None] >= dy
    cols = torch.arange(tiles.shape[1], device=dev)[None, :] >= dx
    return torch.roll(tiles, (dy, dx), (0, 1)) & rows & cols


def occupancy(grid: Grid, inflation: int = 0) -> torch.Tensor:
    """The occupancy grid [H, W] int8 (-1 unknown, 0 free, 100 occupied):
    cells of scanned tiles free where tsd > 0, the halo spill of a scanning
    tile into its neighbours' first row and column, and the zero crossings
    along rows and columns stamped at round(x / cellSize)."""
    tsd = grid.tsd
    H, W = tsd.shape
    dev = tsd.device
    p = grid.tile_dim
    t = torch.arange(grid.tiles, device=dev)
    ring = (t >= 1) & (t <= grid.tiles - 2)
    interior = ring[:, None] & ring[None, :]
    ii = interior & grid.tile_init
    cell_ii = expand_tiles(grid, ii)
    hh = torch.arange(H, device=dev)
    row0 = ((hh % p == 0) & (hh >= p))[:, None]
    col0 = ((hh % p == 0) & (hh >= p))[None, :]
    spill_down = row0 & expand_tiles(grid, _shift_tiles(ii, 1, 0))
    spill_right = col0 & expand_tiles(grid, _shift_tiles(ii, 0, 1))
    cell_init = expand_tiles(grid, grid.tile_init)
    cell_empty = expand_tiles(grid, ~grid.tile_init
                              & (grid.tile_initw > 0.0) & interior)
    spill = spill_down | spill_right | (
        row0 & col0 & expand_tiles(grid, _shift_tiles(ii, 1, 1)))
    free = ((cell_ii | spill) & cell_init & (tsd > 0.0)) | cell_empty
    occ = torch.where(free, 0, -1).to(torch.int8)

    def crossing(a, b):
        return ((a > 0) & (b < 0)) | ((a < 0) & (b > 0))

    a, b = tsd[:, :-1], tsd[:, 1:]
    hmask = crossing(a, b) & (cell_ii[:, :-1] | spill_down[:, :-1])
    gx = torch.arange(1, W, dtype=tsd.dtype, device=dev)
    hu = torch.floor(gx[None, :] - 1.0 + a / (a - b) + 0.5).to(torch.int64)
    hv = torch.arange(H, device=dev)[:, None].expand(hu.shape)
    a2, b2 = tsd[:-1, :], tsd[1:, :]
    vmask = crossing(a2, b2) & (cell_ii[:-1, :] | spill_right[:-1, :])
    gy = torch.arange(1, H, dtype=tsd.dtype, device=dev)
    vv = torch.floor(gy[:, None] - 1.0 + a2 / (a2 - b2) + 0.5).to(torch.int64)
    vu = torch.arange(W, device=dev)[None, :].expand(vv.shape)
    hits = torch.zeros(H * W, dtype=torch.int32, device=dev)
    for u, v, m in ((hu, hv, hmask), (vu, vv, vmask)):
        ok = m & (u > 0) & (u < W) & (v > 0) & (v < H)
        flat = v.clamp(0, H - 1) * W + u.clamp(0, W - 1)
        hits.index_put_((flat.reshape(-1),), ok.reshape(-1).to(torch.int32),
                        accumulate=True)
    occupied = (hits > 0).reshape(H, W)
    if inflation > 0:
        base = occupied
        for dy in range(-inflation, inflation):
            for dx in range(-inflation, inflation):
                occupied = occupied | torch.roll(base, (dy, dx), (0, 1))
    return torch.where(occupied, 100, occ).to(torch.int8)


def color_image(grid: Grid) -> torch.Tensor:
    """[H, W, 3] uint8: a green ramp for positive TSD, red for negative,
    white for empty unmaterialized tiles, black for unknown."""
    n, s, td = grid.cells, grid.cell_size, grid.tile_dim
    dtype, dev = grid.tsd.dtype, grid.tsd.device
    px = torch.arange(n, dtype=dtype, device=dev) * (n * s / n)
    i = torch.floor(px / s - 0.5).to(torch.int64)
    ok = (i >= 0) & (i < n)
    valid = ok[None, :] & ok[:, None]
    ic = i.clamp(0, n - 1)
    ty, tx = (ic // td)[:, None], (ic // td)[None, :]
    tsd = grid.tsd[ic[:, None], ic[None, :]]
    tsd = torch.where(valid & grid.tile_init[ty, tx], tsd, math.nan)
    empty = valid & (~grid.tile_init & (grid.tile_initw > 0.0))[ty, tx]
    pos, neg = tsd > 0.0, tsd < 0.0
    ramp_pos = (torch.where(pos, tsd, 0.0) * 255.0).to(torch.uint8)
    ramp_neg = ((1.0 + torch.where(neg, tsd, 0.0)) * 255.0).to(torch.uint8)
    other = torch.where(empty, 255, 0).to(torch.uint8)
    r = torch.where(pos, ramp_pos, torch.where(neg, ramp_neg, other))
    g = torch.where(pos, 255, torch.where(neg, 0, other))
    b = torch.where(pos, ramp_pos, torch.where(neg, 0, other))
    return torch.stack([r, g, b], dim=-1).to(torch.uint8)
