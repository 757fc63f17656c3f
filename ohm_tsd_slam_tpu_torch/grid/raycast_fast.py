"""The isocontour ("fast") caster (port of
ohm_tsd_slam_tpu/grid/raycast_fast.py: one pose, or a pose batch folded
into the beam axis).

The exact march samples every beam at every cell step.  This caster finds
where a beam can hit first and replays the exact march only there:

  1. extraction, once per grid version (`extract_segments`): marching
     squares over the cell-centre quads turns the TSD zero level set into
     line segments, plus short virtual segments through crossings next to
     NaN cells; the segments are compacted in flat order into a fixed list
     of segment_capacity(grid) (MAX_SEGMENTS up to a 1024^2 grid; the rest
     are counted in n_dropped, never silently lost) and packed into the
     pose-independent [8, S] candidate pack;
  2. per scan, on a grid wider than twice a beam's reach (`reach_cull`,
     which slam/localize.py applies), the pack is first cut to the
     segments within that reach of the sensor, in the same order: no
     other segment can hold a candidate, so the render is unchanged;
     then the earliest exact ray-segment intersection of each beam
     seeds a WINDOW-sample replay of the exact march
     (RayCastPolar2D.cpp:237-270: bilinear taps, +→− hit, −→+ back face,
     NaN skip), BACKOFF steps before the candidate;
  3. rounds 2..ROUNDS replay the beams whose window saw no sign change
     but have a later candidate (a double crossing inside one march step),
     at most UNRESOLVED_CAP of them per round; more count into n_dropped.

The caster is the JAX package's TPU path with the five CUDA kernels of
ops/ (segment layers, row pack, segment min, window replay with its rounds
entry point, and the channel compaction behind the extraction of grids
narrower than the fused kernels take) in place of its Pallas kernels, and
it reads nothing back to the host: rounds 2..ROUNDS always run, cheaply
(one candidate sweep a scan gives every beam its ROUNDS candidates, and one
launch replays at most UNRESOLVED_CAP unresolved beams a round).  Each kernel's plain
twin lives here (`segment_layers_plain`, `pack_rows_plain`,
`segment_min_plain`, `window_replay_plain`, `window_rounds_plain`) or in
grid/compact.py (`pack_channels_rows`).  A
wrapper launches its kernel for a CUDA tensor (which must be float32: it
raises otherwise) and runs its twin for a CPU tensor, so a grid on the CPU,
in float32 or float64, takes the same path on the twins.

A SegmentCache is tied to the tensor it was extracted from: a cache whose
`tsd` is not the grid's, or whose version differs, is stale and counts as a
full overflow (every beam in n_dropped), so `raycast_checked` (and with
it the step) falls back to the exact march.  That check is exact and
host-side; the JAX package's order-independent checksum accepts a grid
shifted by whole cells (ROADMAP.md queue 3).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from ohm_tsd_slam_tpu_torch.core import se2
from ohm_tsd_slam_tpu_torch.grid.compact import (
    compact_mask,
    pack_channels_rows,
)
from ohm_tsd_slam_tpu_torch.grid.raycast import (
    RaycastResult,
    beam_geometry,
    beam_geometry_batch,
    first_event,
    raycast,
    sensor_frame,
)
from ohm_tsd_slam_tpu_torch.grid.state import TsdGrid
from ohm_tsd_slam_tpu_torch.sensor.polar2d import SensorPolar2D
from ohm_tsd_slam_tpu_torch.utils.compiled import compiled, when

# max isocontour segments kept on a grid of up to CAPACITY_CELLS cells;
# segments beyond the capacity are dropped AND counted (n_dropped; a
# 1024^2 map of corridors has ~10-30k segments).  Larger grids get
# MAX_SEGMENTS for every CAPACITY_CELLS cells (segment_capacity).
MAX_SEGMENTS = 32768
CAPACITY_CELLS = 1 << 20
WINDOW = 8           # replay samples per candidate window
BACKOFF = 2.0        # window starts this many steps before the candidate
# backward-compat alias (overflow capacity)
MAX_CROSSINGS = MAX_SEGMENTS
ROUNDS = 4           # candidate/replay rounds
COVER = WINDOW - BACKOFF - 2.0   # next candidate at least this far on
# segments per chunk of the candidate sweep's twin: the [beams, chunk]
# temporaries stay ~35 MB at 1081 float64 beams (the min is order-free)
SEG_CHUNK = 4096


def segment_capacity(grid: TsdGrid) -> int:
    """The extraction's segment capacity for `grid`: MAX_SEGMENTS (read
    at call time, so patchable) up to CAPACITY_CELLS cells (map_size 10),
    and as much again for every further CAPACITY_CELLS cells begun, so
    that a mapped site of any size keeps the segments a room of corridors
    would have per cell (map_size 12: 16 x MAX_SEGMENTS)."""
    cells = grid.cells_x * grid.cells_y
    return MAX_SEGMENTS * max(1, -(-cells // CAPACITY_CELLS))


def unresolved_cap(n_beams: int) -> int:
    """Compacted replay slots per round.  The JAX package's formula, with
    the floor of 256 it lacks for 2048 < N < 8192 (ROADMAP.md queue 3);
    overflow counts into n_dropped either way."""
    if n_beams <= 2048:
        return 256
    return max(256, (-(-n_beams // 64) // 128 + 1) * 128)


# --------------------------------------------------------------------------
# extraction
# --------------------------------------------------------------------------

def _ms_crossing(a, b):
    """Marching-squares edge-crossing predicate (shared helper)."""
    return ((a > 0) & (b < 0)) | ((a < 0) & (b > 0))


def _ms_frac(a, b):
    return a / (a - b)


def _quad_segments(v00, v01, v11, v10, qx, qy, s):
    """Per-quad marching-squares endpoint formulas: the one copy of the
    crossing / interpolation / first-last / saddle geometry.  The CUDA
    kernels (csrc/segment_layers.cu, csrc/pack_rows.cu) follow it in the
    same operation order.

    Corners: v00=(y,x), v01=(y,x+1), v11=(y+1,x+1), v10=(y+1,x); qx/qy
    broadcastable float quad indices.  Returns a dict with the per-layer
    endpoints and masks.
    """
    quad_ok = ~(torch.isnan(v00) | torch.isnan(v01)
                | torch.isnan(v11) | torch.isnan(v10))

    # edges: bottom (v00-v01), right (v01-v11), top (v10-v11),
    # left (v00-v10); crossing points in world coords
    cb = _ms_crossing(v00, v01)
    cr = _ms_crossing(v01, v11)
    ct = _ms_crossing(v10, v11)
    cl = _ms_crossing(v00, v10)

    Bx = (qx + 0.5 + _ms_frac(v00, v01)) * s
    By = ((qy + 0.5) * s).expand_as(Bx)
    Rx = ((qx + 1.5) * s).expand_as(Bx)
    Ry = (qy + 0.5 + _ms_frac(v01, v11)) * s
    Tx = (qx + 0.5 + _ms_frac(v10, v11)) * s
    Ty = ((qy + 1.5) * s).expand_as(Bx)
    Lx = ((qx + 0.5) * s).expand_as(Bx)
    Ly = (qy + 0.5 + _ms_frac(v00, v10)) * s
    Px = [Bx, Rx, Tx, Lx]
    Py = [By, Ry, Ty, Ly]

    F = [cb & quad_ok, cr & quad_ok, ct & quad_ok, cl & quad_ok]
    n_crossed = sum(f.to(torch.int32) for f in F)

    # two-crossing quads: the segment joins the first and last crossed
    # edge in B,R,T,L order (unique for n == 2)
    def idx(k):
        return torch.full_like(n_crossed, k)

    first = torch.where(F[0], idx(0), torch.where(F[1], idx(1), torch.where(
        F[2], idx(2), torch.where(F[3], idx(3), idx(0)))))
    last = torch.where(F[3], idx(3), torch.where(F[2], idx(2), torch.where(
        F[1], idx(1), torch.where(F[0], idx(0), idx(3)))))

    def pick(P, sel):
        out = P[0]
        for k in (1, 2, 3):
            out = torch.where(sel == k, P[k], out)
        return out

    two = quad_ok & (n_crossed == 2)
    four = quad_ok & (n_crossed == 4)

    # saddle decider for the ambiguous case: the bilinear saddle value
    # (v00*v11 - v01*v10)/(v00 + v11 - v01 - v10) decides connectivity.
    # saddle sign == sign(v00): the v01/v10 corners are isolated ->
    # segments (B,R) and (T,L); otherwise (B,L) and (T,R).
    den = v00 + v11 - v01 - v10
    saddle = torch.where(den.abs() > 0, (v00 * v11 - v01 * v10)
                         / torch.where(den == 0, 1.0, den), 0.0)
    same00 = (saddle > 0) == (v00 > 0)

    # segment 1: two-crossing join, or (B, R or L) for saddle quads
    s1_p0x = torch.where(four, Px[0], pick(Px, first))
    s1_p0y = torch.where(four, Py[0], pick(Py, first))
    s1_p1x = torch.where(four, torch.where(same00, Px[1], Px[3]),
                         pick(Px, last))
    s1_p1y = torch.where(four, torch.where(same00, Py[1], Py[3]),
                         pick(Py, last))

    # segment 2 only on saddle quads: (T, L or R)
    s2_p1x = torch.where(same00, Px[3], Px[1])
    s2_p1y = torch.where(same00, Py[3], Py[1])

    return dict(quad_ok=quad_ok, two=two, four=four, Px=Px, Py=Py,
                s1_p0x=s1_p0x, s1_p0y=s1_p0y, s1_p1x=s1_p1x,
                s1_p1y=s1_p1y, s2_p0x=Px[2], s2_p0y=Py[2],
                s2_p1x=s2_p1x, s2_p1y=s2_p1y)


def _place(a: torch.Tensor, shape, row: int = 0, col: int = 0):
    """`a` written into zeros of `shape` at (row, col) (a zero pad)."""
    out = a.new_zeros(shape)
    out[row:row + a.shape[0], col:col + a.shape[1]] = a
    return out


def _segment_layers(grid: TsdGrid):
    """Dense marching-squares + virtual-segment layers.

    Returns (mask [4*H*W] bool, (p0x, p0y, p1x, p1y) flat channels), layer
    major: 0 segment 1, 1 the saddle's segment 2, 2 virtual h-edge,
    3 virtual v-edge."""
    s = grid.cell_size
    tsd = grid.tsd
    H, W = tsd.shape
    dtype, dev = tsd.dtype, tsd.device

    v00 = tsd[:-1, :-1]          # corner (y,   x)
    v01 = tsd[:-1, 1:]           # corner (y,   x+1)
    v11 = tsd[1:, 1:]            # corner (y+1, x+1)
    v10 = tsd[1:, :-1]           # corner (y+1, x)

    qx = torch.arange(W - 1, dtype=dtype, device=dev)[None, :]
    qy = torch.arange(H - 1, dtype=dtype, device=dev)[:, None]
    q = _quad_segments(v00, v01, v11, v10, qx, qy, s)

    s1_mask = q["two"] | q["four"]
    s2_mask = q["four"]

    # --- virtual segments for NaN-adjacent crossings ---------------------
    # A crossed edge both of whose adjacent quads have a NaN corner (the
    # thin unseen side of a wall) belongs to no marching-squares segment,
    # yet the exact march can still see a sign change across it.  Emit a
    # short segment through the crossing point, transverse to the cell
    # pair; the exact window replay resolves the rest.
    clean = s1_mask                                       # [H-1, W-1]
    VIRT = 0.9 * s

    # h-edge (y, x): bottom edge of quad (y, x), top edge of quad (y-1, x)
    ev_h_full = _ms_crossing(tsd[:, :-1], tsd[:, 1:])      # [H, W-1]
    clean_h = _place(clean, (H, W - 1))                    # quad (y, x)
    clean_h_up = _place(clean, (H, W - 1), row=1)          # quad (y-1, x)
    virt_h = ev_h_full & ~(clean_h | clean_h_up)
    fh = _ms_frac(tsd[:, :-1], tsd[:, 1:])
    hx = (torch.arange(W - 1, dtype=dtype, device=dev)[None, :]
          + 0.5 + fh) * s
    hy = ((torch.arange(H, dtype=dtype, device=dev)[:, None] + 0.5)
          * s).expand_as(hx)

    # v-edge (y, x): left edge of quad (y, x), right edge of quad (y, x-1)
    ev_v_full = _ms_crossing(tsd[:-1, :], tsd[1:, :])      # [H-1, W]
    clean_v = _place(clean, (H - 1, W))
    clean_v_left = _place(clean, (H - 1, W), col=1)
    virt_v = ev_v_full & ~(clean_v | clean_v_left)
    fv = _ms_frac(tsd[:-1, :], tsd[1:, :])
    vy = (torch.arange(H - 1, dtype=dtype, device=dev)[:, None]
          + 0.5 + fv) * s
    vx = ((torch.arange(W, dtype=dtype, device=dev)[None, :] + 0.5)
          * s).expand_as(vy)

    def stack(a, b, c, d):
        return torch.stack([_place(x, (H, W)) for x in (a, b, c, d)]
                           ).reshape(-1)

    mask = stack(s1_mask, s2_mask, virt_h, virt_v)
    chans = (stack(q["s1_p0x"], q["s2_p0x"], hx, vx - VIRT),
             stack(q["s1_p0y"], q["s2_p0y"], hy - VIRT, vy),
             stack(q["s1_p1x"], q["s2_p1x"], hx, vx + VIRT),
             stack(q["s1_p1y"], q["s2_p1y"], hy + VIRT, vy))
    return mask, chans


def segment_layers_plain(grid: TsdGrid):
    """Twin of csrc/segment_layers.cu (TPU kernel 2's contract): the layer
    mask as float32 0/1 [4*H*W] and its per-128-lane row counts (int32)."""
    mask, _ = _segment_layers(grid)
    mask = mask.to(torch.float32)
    return mask, mask.reshape(-1, 128).sum(1).to(torch.int32)


def pack_rows_plain(grid: TsdGrid, mask: torch.Tensor, size: int):
    """Twin of csrc/pack_rows.cu (TPU kernel 3's contract): the
    [5, size + 128] pack of the endpoint channels of the set lanes of the
    layer mask, in flat order, and the total count (int32).  The pack has
    the grid's dtype (the kernel's is float32)."""
    _, chans = _segment_layers(grid)
    return pack_channels_rows(mask, chans, size)


class SegmentCache(NamedTuple):
    """Pose-independent isocontour extraction of one grid version.

    The grid changes only when the mapper fuses a significantly moved scan
    (ThreadLocalize.cpp:402,728-736) while the localizer renders every scan
    (:353), so the node extracts once per grid version and passes the cache
    to every scan's render.  Valid only for the tensor `tsd` it was built
    from at version `version` (see the module docstring)."""

    p0: torch.Tensor          # [S, 2] world endpoints
    p1: torch.Tensor          # [S, 2]
    valid: torch.Tensor       # [S] bool
    n_dropped: torch.Tensor   # int64: segments lost to the capacity
    pack: torch.Tensor        # [8, S] candidate pack (pack_segments)
    count: torch.Tensor       # int32: valid segments (the first `count`)
    origin: torch.Tensor      # [2] grid centre subtracted in the pack
    tsd: torch.Tensor         # the source field
    version: int              # its tensor version at extraction


def _pack_origin(grid: TsdGrid, dtype, device) -> torch.Tensor:
    """The grid centre: the pack's coordinates are taken relative to it,
    which bounds the magnitudes in the kernel's float32 cross products.
    Filled on the device: a copy from the host would synchronise."""
    return torch.stack([
        torch.full((), n * grid.cell_size * 0.5, dtype=dtype, device=device)
        for n in (grid.cells_x, grid.cells_y)])


def pack_segments(p0: torch.Tensor, p1: torch.Tensor, valid: torch.Tensor):
    """The pose-independent [8, S] candidate pack (rows ex, ey, p0x, p0y,
    cross(p0, e), valid, eps, 0) and the valid count, as
    ohm_tsd_slam_tpu/ops/raycast_pallas.py::pack_segments builds it.
    Callers pass p0/p1 relative to the grid centre."""
    e = p1 - p0
    ex, ey = e[:, 0], e[:, 1]
    c0p = p0[:, 0] * ey - p0[:, 1] * ex                # cross(p0, e)
    eps = 1e-6 * torch.sqrt(ex * ex + ey * ey).clamp(min=1e-30)
    pack = torch.stack([ex, ey, p0[:, 0], p0[:, 1], c0p,
                        valid.to(p0.dtype), eps, torch.zeros_like(c0p)])
    return pack, valid.sum(dtype=torch.int32)


class CasterKernels(NamedTuple):
    """The kernels of the kernel path: the CUDA wrappers of ops/
    (`cuda_kernels`), or callables with their signatures."""

    segment_layers: Callable    # ops/segment_layers_cuda.py (kernel A)
    pack_rows: Callable         # ops/pack_rows_cuda.py (kernel B)
    segment_min: Callable       # ops/segment_min_cuda.py (kernel C)
    window_replay: Callable     # ops/window_replay_cuda.py (kernel D)
    compact_channels: Callable  # ops/compact_channels_cuda.py (kernel E)
    window_rounds: Callable     # ops/window_replay_cuda.py (D's rounds)


def cuda_kernels() -> CasterKernels:
    from ohm_tsd_slam_tpu_torch.ops.compact_channels_cuda import (
        compact_channels,
    )
    from ohm_tsd_slam_tpu_torch.ops.pack_rows_cuda import pack_rows
    from ohm_tsd_slam_tpu_torch.ops.segment_layers_cuda import segment_layers
    from ohm_tsd_slam_tpu_torch.ops.segment_min_cuda import segment_min
    from ohm_tsd_slam_tpu_torch.ops.window_replay_cuda import (
        window_replay,
        window_rounds,
    )

    return CasterKernels(segment_layers, pack_rows, segment_min,
                         window_replay, compact_channels, window_rounds)


def fused_extraction(grid: TsdGrid) -> bool:
    """True when kernels A and B take this grid: they walk the field in
    128-lane rows, so its width must be a multiple of 128 (map_size >= 7).
    Any other grid takes the general extraction."""
    return grid.tsd.shape[1] % 128 == 0


def _pack_fused(grid: TsdGrid, size: int, ks: CasterKernels):
    """The [5, size + 128] segment pack and the segment count by kernel A
    (segment layers), then kernel B (row pack, endpoints in-kernel)."""
    mask, row_cnt = ks.segment_layers(grid)
    return ks.pack_rows(grid, mask, row_cnt, size)


def _pack_general(grid: TsdGrid, size: int, ks: CasterKernels):
    """The same pack for any grid: the dense layers and their endpoint
    channels in plain torch (as the JAX package runs them in XLA where
    its fused kernels' gate fails), then kernel E compacts them."""
    mask, chans = _segment_layers(grid)
    return ks.compact_channels(mask, chans, size)


def extract_endpoints(grid: TsdGrid, max_segments: int,
                      kernels: CasterKernels):
    """The isocontour segments of the grid's field, by the fused kernels
    A and B where the grid's shape allows, else by the dense layers and
    kernel E (`fused_extraction` chooses): endpoints p0, p1 [S, 2] in the
    grid's frame, their validity [S] and the int64 count of segments
    beyond the capacity S."""
    S = max_segments
    pack_fn = _pack_fused if fused_extraction(grid) else _pack_general
    packed, total = pack_fn(grid, S, kernels)
    n_dropped = (total.to(torch.int64) - S).clamp(min=0)
    return (packed[0:2, :S].t(), packed[2:4, :S].t(), packed[4, :S] > 0.0,
            n_dropped)


def extract_segments(grid: TsdGrid, max_segments: Optional[int] = None,
                     kernels: Optional[CasterKernels] = None) -> SegmentCache:
    """The pose-independent extraction for this grid version
    (extract_endpoints, then the candidate pack).  `kernels` stands in
    for the wrappers of cuda_kernels() (ops/kernel_check.py passes its
    checked ones)."""
    if max_segments is None:
        max_segments = segment_capacity(grid)  # at call time (patchable)
    p0, p1, valid, n_dropped = extract_endpoints(
        grid, max_segments, kernels or cuda_kernels())
    origin = _pack_origin(grid, p0.dtype, p0.device)
    pack, count = pack_segments(p0 - origin, p1 - origin, valid)
    return SegmentCache(p0, p1, valid, n_dropped, pack, count, origin,
                        grid.tsd, grid.tsd._version)


def is_stale(segments: SegmentCache, grid: TsdGrid) -> bool:
    """True when the cache was not extracted from this grid's field as it
    is now (host-side, exact)."""
    return (segments.tsd is not grid.tsd
            or segments.version != grid.tsd._version)


# --------------------------------------------------------------------------
# per-scan render
# --------------------------------------------------------------------------

def beam_origins(tr: torch.Tensor, n: int) -> torch.Tensor:
    """The sensor translation of each of n beams from the table tr [P, 2]
    of a pose batch folded into the beam axis (raycast_fast_batch: the
    beams of pose p are the p-th of P equal runs): [2] where there is one
    row ([2] or [1, 2]), else [n, 2]."""
    if tr.numel() == 2:
        return tr.reshape(2)
    P = tr.shape[0]
    if tr.shape != (P, 2) or n % P:
        raise ValueError(f"{n} beams do not split into the {tuple(tr.shape)} "
                         "translation table's poses")
    return tr.repeat_interleave(n // P, dim=0)


def _xy(origins: torch.Tensor):
    """beam_origins' x and y: 0-dim for one row, else [n, 1] columns (one
    operation on the same values either way)."""
    if origins.dim() == 1:
        return origins[0], origins[1]
    return origins[:, 0:1], origins[:, 1:2]


def segment_min_plain(pack: torch.Tensor, count: torch.Tensor,
                      ray: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                      t_after: torch.Tensor, tr: torch.Tensor,
                      levels: int = 1, cover: float = 0.0) -> torch.Tensor:
    """Twin of csrc/segment_min.cu (TPU kernel 4's contract): K levels of
    earliest intersections per beam from the [8, S] pack, level k being
    the earliest t >= level k-1 + cover (level 0: t >= t_after).  `tr` is
    the table of sensor translations in the pack's frame (`beam_origins`);
    segments past `count` do not count.  Returns [B, levels] (inf = none).
    Reads `count` back to bound the chunk loop."""
    n = min(int(count), pack.shape[1])
    rayx, rayy = ray[:, 0:1], ray[:, 1:2]
    lo, hi = lo[:, None], hi[:, None]
    trx, try_ = _xy(beam_origins(tr, ray.shape[0]))
    c1tr = rayx * try_ - rayy * trx                       # cross(ray, tr)
    out = []
    bound = t_after[:, None]
    for _ in range(levels):
        best = torch.full_like(lo, math.inf)
        for j0 in range(0, n, SEG_CHUNK):
            P = pack[:, j0:min(j0 + SEG_CHUNK, n)]
            ex, ey, p0x, p0y = P[0:1], P[1:2], P[2:3], P[3:4]
            c0p, valid, eps = P[4:5], P[5:6], P[6:7]
            denom = rayx * ey - rayy * ex                 # cross(ray, e)
            c1 = (rayx * p0y - rayy * p0x) - c1tr         # cross(ray, p0-tr)
            c0 = c0p - (trx * ey - try_ * ex)             # cross(p0-tr, e)
            ok_denom = denom.abs() > eps
            safe = torch.where(ok_denom, denom, 1.0)
            t = c0 / safe
            u = -c1 / safe
            ok = ((valid > 0.0) & ok_denom & (u >= 0.0) & (u <= 1.0)
                  & (t >= lo) & (t <= hi) & (t >= bound))
            best = torch.minimum(
                best, torch.where(ok, t, math.inf).amin(1, keepdim=True))
        out.append(best)
        bound = best + cover
    return torch.cat(out, dim=1)


def _taps(tsd: torch.Tensor, s: float, px: torch.Tensor, py: torch.Tensor,
          row0: int = 0):
    """Bilinear value at world points (NaN = invalid): the taps of
    grid/interpolate.py::interpolate_bilinear in its summation order, out
    of bounds reading NaN, without its tile check (a cell of a tile that
    was never initialized is NaN in the dense field, so the blend is NaN
    there anyway).  The cell size divides as a tensor: on CUDA, torch
    turns a division by a Python number into a product with its
    reciprocal, which is not the kernel's (or the CPU's) IEEE quotient.
    `tsd` may be a row block whose row 0 is world row `row0`: the base
    cell must lie in its world rows and a tap past it reads NaN."""
    H, W = tsd.shape
    s_t = torch.full((), s, dtype=px.dtype, device=px.device)
    u = px / s_t - 0.5
    v = py / s_t - 0.5
    fx = torch.floor(u)
    fy = torch.floor(v)
    wx = u - fx
    wy = v - fy
    base_ok = (fx >= 0) & (fx < W) & (fy >= row0) & (fy < row0 + H)
    ix = torch.where(base_ok, fx, 0.0).to(torch.int64)
    iy = torch.where(base_ok, fy - row0, 0.0).to(torch.int64)
    flat = tsd.reshape(-1)

    def tap(dx, dy):
        jx, jy = ix + dx, iy + dy
        inb = (jx < W) & (jy < H)
        val = flat[jy.clamp(max=H - 1) * W + jx.clamp(max=W - 1)]
        return torch.where(inb, val, math.nan)

    val = (tap(0, 0) * (1.0 - wy) * (1.0 - wx)
           + tap(0, 1) * wy * (1.0 - wx)
           + tap(1, 0) * (1.0 - wy) * wx
           + tap(1, 1) * wy * wx)
    return torch.where(base_ok, val, math.nan)


def window_start(k: torch.Tensor, idx_min: torch.Tensor) -> torch.Tensor:
    """First sample of the replay window around the candidate step k:
    BACKOFF whole steps before it, in the march's phase (idx_min + whole
    steps), not before the march's start."""
    return idx_min + (torch.floor(k - idx_min) - BACKOFF).clamp(min=0.0)


def window_replay_plain(grid: TsdGrid, k: torch.Tensor, ray: torch.Tensor,
                        idx_min: torch.Tensor, idx_max: torch.Tensor,
                        active: torch.Tensor, tr: torch.Tensor,
                        row0: int = 0) -> torch.Tensor:
    """Twin of csrc/window_replay.cu's round 1 (TPU kernels 5 and 6's
    contract): the exact-march replay over WINDOW samples from
    t = window_start(k, idx_min) per beam, the sub-cell interpolation of
    the first event and the central-difference normal there
    (grid/interpolate.py::interpolate_normal).

    Returns [N, 8]: hit, any_ev, pos_x, pos_y, interp, nx, ny, n_ok (0/1
    flags); zeros for inactive beams.  Without an event the row holds the
    geometry of the window's first sample pair, as the JAX package's
    _window_events does.  `tr` is the table of sensor translations
    (`beam_origins`).  `grid` may be a row block of the grid whose row 0
    is world row `row0` (a row-sharded rank's halo block,
    parallel/shard_raycast.py): every coordinate stays a world one."""
    s = grid.cell_size
    tsd = grid.tsd
    dtype = tsd.dtype
    trx, try_ = _xy(beam_origins(tr, k.shape[0]))
    j = torch.arange(WINDOW, dtype=dtype, device=tsd.device)
    t_w = window_start(k, idx_min)[:, None] + j[None, :]  # [N, W]
    px = trx + t_w * ray[:, 0:1]
    py = try_ + t_w * ray[:, 1:2]
    v = _taps(tsd, s, px, py, row0)
    hit, any_ev, k_ev, interp = first_event(v, t_w, idx_max)
    pos_x = torch.gather(px[:, 1:], 1, k_ev)[:, 0]
    pos_y = torch.gather(py[:, 1:], 1, k_ev)[:, 0]

    cx = pos_x + ray[:, 0] * (interp - 1.0)
    cy = pos_y + ray[:, 1] * (interp - 1.0)
    xp = _taps(tsd, s, cx + s, cy, row0)
    xm = _taps(tsd, s, cx - s, cy, row0)
    yp = _taps(tsd, s, cx, cy + s, row0)
    ym = _taps(tsd, s, cx, cy - s, row0)
    n_ok = ~(torch.isnan(xp) | torch.isnan(xm) | torch.isnan(yp)
             | torch.isnan(ym))
    nx = xp - xm
    ny = yp - ym
    norm = torch.sqrt(nx * nx + ny * ny)
    den = torch.where(norm > 0, norm, 1.0)
    nxn = torch.where(n_ok, nx / den, math.nan)
    nyn = torch.where(n_ok, ny / den, math.nan)

    out = torch.stack([hit.to(dtype), any_ev.to(dtype), pos_x, pos_y,
                       interp, nxn, nyn, n_ok.to(dtype)], dim=1)
    return torch.where(active[:, None], out, 0.0)


def _scatter_rows(S: torch.Tensor, idx: torch.Tensor, take: torch.Tensor,
                  rows: torch.Tensor) -> torch.Tensor:
    """S with row idx[i] replaced by rows[i] where take[i] (no host sync;
    the slots not taken write a scratch row that is dropped)."""
    N = S.shape[0]
    ext = torch.cat([S, S.new_zeros((1, S.shape[1]))])
    dest = torch.where(take, idx, N)
    return ext.index_copy(0, dest, rows)[:N]


def window_rounds_plain(grid: TsdGrid, S: torch.Tensor, lev: torch.Tensor,
                        ray: torch.Tensor, idx_min: torch.Tensor,
                        idx_max: torch.Tensor, tr: torch.Tensor, cap: int):
    """Twin of csrc/window_replay.cu's rounds entry point: rounds
    2..ROUNDS on the per-beam state S [N, 8] (window_replay_plain's rows,
    column 1 holding `resolved`).  In round r a beam needs a replay when
    its candidate lev[:, r] is finite and it is not resolved; the first
    `cap` needing beams, in beam order, replay the window around that
    candidate and take the new row when it holds an event; every beam that
    did not need the round is resolved from then on.

    Returns (S after the rounds, the argument left as it was; the int64
    count of needing beams beyond `cap`, summed over the rounds).  `tr` is
    the table of sensor translations (`beam_origins`)."""
    n_dropped = torch.zeros((), dtype=torch.int64, device=S.device)
    origins = beam_origins(tr, S.shape[0])
    for r in range(lev.shape[1]):
        t_r = lev[:, r]
        need = torch.isfinite(t_r) & ~(S[:, 1] > 0.0)
        n_dropped = n_dropped + (need.sum() - cap).clamp(min=0)
        idx_u, uvalid = compact_mask(need, cap)
        k_u = torch.where(uvalid, t_r[idx_u], 0.0)
        rows = window_replay_plain(
            grid, k_u, ray[idx_u], idx_min[idx_u], idx_max[idx_u], uvalid,
            origins if origins.dim() == 1 else origins[idx_u])
        S = _scatter_rows(S, idx_u, (rows[:, 1] > 0.0) & uvalid, rows)
        S[:, 1] = torch.maximum(S[:, 1], (~need).to(S.dtype))
    return S, n_dropped


def _core(grid, segments, ray, tr, idx_min, idx_max, feasible, n_dropped,
          ks: CasterKernels):
    """The JAX package's TPU path on the kernels: one candidate sweep C
    of ROUNDS levels from the march's start, window replay D for every
    beam around level 0, and D's rounds entry point for the ROUNDS-1 later
    replays around the later levels.  Nothing is read back to the host.

    The JAX package sweeps twice (K=1 for every beam, K=ROUNDS-1 from
    `max(lo, t_1 + COVER)` for the beams round 1 left unresolved), because
    on the TPU the later levels cost a second pass over all beams.  A beam
    that is unresolved has a candidate t_1 >= lo, so its second sweep
    starts at t_1 + COVER: its levels are levels 1.. of one sweep with
    `cover=COVER`.  The rounds never read the levels of a resolved beam
    (window_rounds_plain's `need`).

    `tr` is [2] for one scan, or the [P, 2] table of a pose batch whose
    beams are folded pose-major into the N beams (`beam_origins`)."""
    N = ray.shape[0]
    lo = (torch.floor(idx_min) - 1.0).clamp(min=0.0)
    hi = torch.ceil(idx_max) + 1.0
    tr_pack = tr - segments.origin

    lev = ks.segment_min(segments.pack, segments.count, ray, lo, hi, lo,
                         tr_pack, levels=ROUNDS, cover=COVER)
    t_1 = lev[:, 0]
    has = torch.isfinite(t_1) & feasible
    k_1 = torch.where(has, t_1, 0.0)

    # per-beam state [N, 8]: hit, any_ev (-> resolved), pos_x, pos_y,
    # interp, nx, ny, n_ok
    S = ks.window_replay(grid, k_1, ray, idx_min, idx_max, has, tr)
    resolved = (S[:, 1] > 0.0) | ~has
    S[:, 1] = resolved.to(S.dtype)
    if ROUNDS > 1:
        S, dropped = ks.window_rounds(grid, S, lev[:, 1:], ray, idx_min,
                                      idx_max, tr, unresolved_cap(N))
        n_dropped = n_dropped + dropped

    hit = S[:, 0] > 0.0
    coords_w = S[:, 2:4] + ray * (S[:, 4:5] - 1.0)
    return coords_w, S[:, 5:7], hit, S[:, 7] > 0.0, n_dropped


def reach_radius(grid: TsdGrid, geom: SensorPolar2D) -> float:
    """How far from the sensor a segment can hold one of kernel C's
    candidates: a beam's march ends by max_range + 2 steps (`_core`'s
    `hi`: ceil(idx_max) + 1, idx_max <= max_range / cell), and a segment
    is at most 1.8 cells long (the virtual ones; a quad's at most 1.42),
    so its first endpoint lies within max_range + 3.8 cells.  The radius
    adds the window's BACKOFF and 4 cells: room for float rounding
    thousands of times over."""
    return geom.max_range + (BACKOFF + 4.0) * grid.cell_size


def reach_cull_pays(grid: TsdGrid, geom: SensorPolar2D) -> bool:
    """Whether to cull the pack before kernel C: only where a scan's
    reach leaves part of the grid out, i.e. the grid's side is more than
    twice reach_radius (map_size 12 at 0.025 m against a 20-30 m laser;
    never a 25.6 m map).  Static: the grid's shape and the sensor decide
    it, so a graph holds the cull or does not."""
    side = min(grid.cells_x, grid.cells_y) * grid.cell_size
    return side > 2.0 * reach_radius(grid, geom)


def reach_cull(segments: SegmentCache, pose: torch.Tensor, radius: float,
               kernels: Optional[CasterKernels] = None) -> SegmentCache:
    """The cache with its pack cut to the valid segments whose first
    endpoint lies within `radius` of the sensor of `pose`, kept in pack
    order, and `count` their number: a per-scan list for kernel C.  With
    radius >= reach_radius, no segment left out can hold a candidate
    (kernel C's `t <= hi` and `0 <= u <= 1`), so every candidate, hit and
    drop count equals the whole pack's.

    The test is a few elementwise ops over the pack's capacity, and the
    kept columns are compacted by kernel E (compact_channels: the pack's
    rows 0-6 as its channels, in flat order; its validity row lands in
    row 7, which no reader of the pack reads) into a pack of capacity
    S + 128.  Nothing is read back to the host.  The capacity, source
    field, version, endpoints and drop count stay the extraction's."""
    ks = kernels or cuda_kernels()
    pack = segments.pack
    dtype, dev = pack.dtype, pack.device
    tr = se2.translation(pose.to(dtype)) - segments.origin
    dx = pack[2] - tr[0]
    dy = pack[3] - tr[1]
    r2 = torch.full((), radius * radius, dtype=dtype, device=dev)
    keep = (pack[5] > 0.0) & (dx * dx + dy * dy <= r2)
    packed, count = ks.compact_channels(keep, [pack[r] for r in range(7)],
                                        pack.shape[1])
    return segments._replace(pack=packed, count=count)


def _cache_and_drops(grid: TsdGrid, segments: Optional[SegmentCache],
                     max_segments: Optional[int], n_beams: int,
                     ks: CasterKernels):
    """The segment cache to render with (extracted inline when none is
    given) and the drops so far: the extraction's, and every beam for a
    stale cache (a full overflow)."""
    if segments is None:
        segments = extract_segments(grid, max_segments, ks)
        return segments, segments.n_dropped
    return segments, segments.n_dropped + (n_beams if is_stale(segments,
                                                               grid) else 0)


def raycast_fast(grid: TsdGrid, geom: SensorPolar2D, pose: torch.Tensor,
                 segments: Optional[SegmentCache] = None,
                 max_segments: Optional[int] = None,
                 kernels: Optional[CasterKernels] = None) -> RaycastResult:
    """Isocontour raycast.  `segments`, an extract_segments() cache of
    THIS grid version, skips the extraction; without it the extraction
    runs inline.  `kernels` as in extract_segments.  n_dropped > 0 means
    the result may have lost beams (see raycast_checked)."""
    ks = kernels or cuda_kernels()
    ray, tr, idx_min, idx_max, feasible = beam_geometry(grid, geom, pose)
    segments, n_dropped = _cache_and_drops(grid, segments, max_segments,
                                           ray.shape[0], ks)
    coords_w, normals_w, hit, n_ok, n_dropped = _core(
        grid, segments, ray, tr, idx_min, idx_max, feasible, n_dropped, ks)

    return sensor_frame(pose.to(grid.tsd.dtype), coords_w, normals_w,
                        feasible & hit & n_ok, n_dropped)


def raycast_fast_batch(grid: TsdGrid, geom: SensorPolar2D,
                       poses: torch.Tensor,
                       segments: Optional[SegmentCache] = None,
                       max_segments: Optional[int] = None,
                       kernels: Optional[CasterKernels] = None
                       ) -> RaycastResult:
    """raycast_fast for P poses [P, 3, 3] against one grid in one pass
    (ohm_tsd_slam_tpu/grid/raycast_fast.py::raycast_fast_batch): the pose
    axis is folded pose-major into the beam axis, so kernels C, D and D's
    rounds launch once each for all P * B beams, with a [P, 2] table of
    sensor translations (`beam_origins`); one extraction (or one cache)
    serves every pose, and the rounds' capacity is unresolved_cap(P * B).

    Returns a RaycastResult whose fields have a leading [P] axis;
    n_dropped is one total (a stale cache counts P * B).  Each pose's rows
    equal raycast_fast's for that pose alone while nothing is dropped: a
    beam's arithmetic does not depend on the batch."""
    ks = kernels or cuda_kernels()
    P, B = poses.shape[0], geom.size
    N = P * B
    ray, tr, idx_min, idx_max, feasible = beam_geometry_batch(grid, geom,
                                                              poses)
    segments, n_dropped = _cache_and_drops(grid, segments, max_segments, N,
                                           ks)
    coords_w, normals_w, hit, n_ok, n_dropped = _core(
        grid, segments, ray.reshape(N, 2), tr, idx_min.reshape(N),
        idx_max.reshape(N), feasible.reshape(N), n_dropped, ks)
    return sensor_frame(poses.to(grid.tsd.dtype), coords_w.reshape(P, B, 2),
                        normals_w.reshape(P, B, 2),
                        feasible & (hit & n_ok).reshape(P, B), n_dropped)


def raycast_checked(grid: TsdGrid, geom: SensorPolar2D, pose: torch.Tensor,
                    segments: Optional[SegmentCache] = None
                    ) -> RaycastResult:
    """Guarded isocontour raycast (ohm_tsd_slam_tpu/grid/raycast_fast.py::
    raycast_checked): when anything overflowed (segments, round capacity,
    stale cache) the exact march renders the scan instead, and n_dropped
    keeps the fast caster's count.  The branch is utils/compiled.py::when:
    eagerly one read of n_dropped, in a graph (raycast_checked_jit,
    localize_step_jit) a conditional node that reads nothing back."""
    fast = raycast_fast(grid, geom, pose, segments=segments)
    return when(fast.n_dropped > 0,
                lambda: raycast(grid, geom, pose)._replace(
                    n_dropped=fast.n_dropped),
                fast)


# --------------------------------------------------------------------------
# compiled entry points (utils/compiled.py: a CUDA graph a key on the card,
# the eager functions on the CPU)
# --------------------------------------------------------------------------

def strip_cache(segments: Optional[SegmentCache]) -> Optional[SegmentCache]:
    """The cache without its source field and version, the host-side half
    that a graph cannot see: a graph's key takes `is_stale` instead, and
    the copy of the cache into a graph's buffers leaves the field out."""
    if segments is None:
        return None
    return segments._replace(tsd=None, version=0)


def bind_cache(segments: Optional[SegmentCache], grid: TsdGrid,
               stale: bool) -> Optional[SegmentCache]:
    """A stripped cache tied again to `grid` (the graph's buffer at a
    capture, the caller's grid on the CPU), stale or not as decided on the
    caller's objects."""
    if segments is None:
        return None
    return segments._replace(tsd=None if stale else grid.tsd,
                             version=grid.tsd._version)


def _extract_tensors(grid: TsdGrid, max_segments: int) -> SegmentCache:
    return strip_cache(extract_segments(grid, max_segments))


_extract_graph = compiled(_extract_tensors, static_argnames=("max_segments",),
                          name="extract_segments_jit")


def extract_segments_jit(grid: TsdGrid,
                         max_segments: Optional[int] = None) -> SegmentCache:
    """extract_segments, compiled (ohm_tsd_slam_tpu/grid/raycast_fast.py::
    extract_segments_jit): one graph of kernels A and B (or the dense
    layers and kernel E) a grid shape.  The cache names the caller's field
    and its version, as extract_segments' does, so `is_stale` keeps
    working on it."""
    if max_segments is None:
        max_segments = segment_capacity(grid)
    seg = _extract_graph(grid, max_segments)
    return seg._replace(tsd=grid.tsd, version=grid.tsd._version)


extract_segments_jit.compiled = _extract_graph


def _render(grid: TsdGrid, geom: SensorPolar2D, pose: torch.Tensor,
            segments: Optional[SegmentCache], stale: bool,
            max_segments: Optional[int]) -> RaycastResult:
    return raycast_fast(grid, geom, pose, bind_cache(segments, grid, stale),
                        max_segments)


_render_graph = compiled(_render, static_argnames=("geom", "stale",
                                                   "max_segments"),
                         name="raycast_fast_jit")


def raycast_fast_jit(grid: TsdGrid, geom: SensorPolar2D, pose: torch.Tensor,
                     segments: Optional[SegmentCache] = None,
                     max_segments: Optional[int] = None) -> RaycastResult:
    """raycast_fast, compiled (ohm_tsd_slam_tpu/grid/raycast_fast.py::
    raycast_fast_jit, `geom` static): one graph of kernels C, D and D's
    rounds with their glue a key.  The cache's staleness is decided here,
    on the caller's grid, and keys the graph."""
    stale = segments is not None and is_stale(segments, grid)
    return _render_graph(grid, geom, pose, strip_cache(segments), stale,
                         max_segments)


raycast_fast_jit.compiled = _render_graph


def _checked(grid: TsdGrid, geom: SensorPolar2D, pose: torch.Tensor,
             segments: Optional[SegmentCache], stale: bool) -> RaycastResult:
    return raycast_checked(grid, geom, pose, bind_cache(segments, grid, stale))


_checked_graph = compiled(_checked, static_argnames=("geom", "stale"),
                          name="raycast_checked_jit")


def raycast_checked_jit(grid: TsdGrid, geom: SensorPolar2D,
                        pose: torch.Tensor,
                        segments: Optional[SegmentCache] = None
                        ) -> RaycastResult:
    """raycast_checked, compiled (ohm_tsd_slam_tpu/grid/raycast_fast.py::
    raycast_checked_jit, `geom` static): one graph of kernels C, D and
    D's rounds (A and B, or E, too without a cache) and the exact march in
    a conditional node on the fast caster's drop count, so one graph
    serves the scans that overflow and those that do not.  Staleness is
    decided here, as in raycast_fast_jit."""
    stale = segments is not None and is_stale(segments, grid)
    return _checked_graph(grid, geom, pose, strip_cache(segments), stale)


raycast_checked_jit.compiled = _checked_graph
