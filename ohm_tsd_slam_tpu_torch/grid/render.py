"""Differentiable range rendering from the TSD grid (port of
ohm_tsd_slam_tpu/grid/render.py).

The reference raycaster (RayCastPolar2D.cpp) is forward-only.  This module
adds gradients of the rendered range image with respect to the sensor pose
and the TSD cells, which makes the renderer a measurement model one can
optimize against (scan-to-map fitting, pose-graph refinement, grid
learning).

Math: the hit range r of a beam with world origin o(pose) and unit
direction d(pose) solves F(r; pose, tsd) = Phi(o + r d; tsd) = 0, where Phi
is the bilinearly interpolated field (TsdGrid.h:284-304).  By the implicit
function theorem dr/dp = -(dF/dp) / (dF/dr), dF/dr = grad(Phi)·d, for any
parameter p (pose entries or cell values).  The backward pass needs no
march: one pass of taps for dF/dr along each hit beam, and one gradient of
Phi at the fixed hit points for dF/d(tsd, pose).  Miss beams get an exact
zero gradient (the hit/miss decision is straight-through).

The forward values come from the ordinary raycaster (the guarded
isocontour caster `raycast_checked`, or the exact march), optionally
polished by four guarded Newton steps on the bilinear field along the ray
(`refine=True`, the default), so that the forward agrees with the IFT
gradient under finite differences.  With `refine=False` the forward is
the raycaster's ranges, bit for bit.

What differs from the JAX module: its `jax.custom_vjp` is a
`torch.autograd.Function` whose forward is the identity on the marched
ranges; the derivative along the ray is the analytic bilinear gradient
where JAX takes a `jax.jvp`, and dF/d(tsd, pose) is `torch.autograd.grad`
of Phi where JAX takes a `jax.vjp`.  The JAX backward is plain jnp (no
Pallas kernel), so plain torch is its port.  On the card the forward
launches the caster's kernels (C, D and its rounds; A and B as well
without a segment cache); the tsd cotangent is a scatter-add of four taps
a hit beam, which CUDA adds in no fixed order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ohm_tsd_slam_tpu_torch.core import se2
from ohm_tsd_slam_tpu_torch.grid.raycast import RaycastResult, raycast
from ohm_tsd_slam_tpu_torch.grid.raycast_fast import (
    SegmentCache,
    bind_cache,
    is_stale,
    raycast_checked,
    strip_cache,
)
from ohm_tsd_slam_tpu_torch.grid.state import TsdGrid
from ohm_tsd_slam_tpu_torch.sensor.polar2d import SensorPolar2D
from ohm_tsd_slam_tpu_torch.utils.compiled import compiled


def _bilinear_raw(tsd: torch.Tensor, coords: torch.Tensor, cell_size: float,
                  row0: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bilinear interpolation on the raw TSD array with NaN-safe taps.

    Same cell convention as TsdGrid::coord2Cell (TsdGrid.h:306-340): base
    cell floor(coord/s - 0.5), weights the fractional offsets from its
    centre.  NaN taps are zeroed inside the arithmetic so that no gradient
    carries a NaN; validity is returned apart.  `tsd` may be a row block
    whose row 0 is world row `row0` (parallel/shard_raycast.py): the cell
    and the weights come from the world coordinates as for the whole
    grid, and the offset is taken off the integer row.

    Returns (value, d value / d coords [..., 2], valid): the value and its
    analytic spatial gradient, both 0 where not valid."""
    H, W = tsd.shape
    s = cell_size
    u = coords[..., 0] / s - 0.5
    v = coords[..., 1] / s - 0.5
    ix = torch.floor(u).to(torch.int64)
    iy = torch.floor(v).to(torch.int64)
    wx = u - ix.to(u.dtype)
    wy = v - iy.to(v.dtype)
    iy = iy - row0
    valid = (ix >= 0) & (ix < W - 1) & (iy >= 0) & (iy < H - 1)
    flat = tsd.reshape(-1)
    base = iy.clamp(0, H - 2) * W + ix.clamp(0, W - 2)
    v00 = flat[base]
    v10 = flat[base + W]
    v01 = flat[base + 1]
    v11 = flat[base + W + 1]
    finite = ~(torch.isnan(v00) | torch.isnan(v10) | torch.isnan(v01)
               | torch.isnan(v11))
    v00, v10, v01, v11 = (torch.nan_to_num(t, nan=0.0)
                          for t in (v00, v10, v01, v11))
    # tap order and weights of TsdGridPartition::interpolateBilinear
    # (TsdGridPartition.h:214-221)
    val = (v00 * (1.0 - wy) * (1.0 - wx)
           + v10 * wy * (1.0 - wx)
           + v01 * (1.0 - wy) * wx
           + v11 * wy * wx)
    grad = torch.stack([(v01 - v00) * (1.0 - wy) + (v11 - v10) * wy,
                        (v10 - v00) * (1.0 - wx) + (v11 - v01) * wx],
                       dim=-1) / s
    ok = valid & finite
    return (torch.where(ok, val, 0.0), torch.where(ok[..., None], grad, 0.0),
            ok)


def _phi_at(geom: SensorPolar2D, cell_size: float, tsd: torch.Tensor,
            pose: torch.Tensor, r: torch.Tensor):
    """Phi(o(pose) + r · d(pose); tsd) per beam, its derivative along the
    ray (dF/dr = grad(Phi)·d) and its validity."""
    pose = pose.to(tsd.dtype)
    dirs = se2.rotate_vectors(pose, geom.rays_local(tsd.dtype, tsd.device))
    x = pose[:2, 2] + r[:, None] * dirs
    val, grad, ok = _bilinear_raw(tsd, x, cell_size)
    return val, (grad * dirs).sum(-1), ok


def _newton_refine(geom: SensorPolar2D, cell_size: float, tsd: torch.Tensor,
                   pose: torch.Tensor, r0: torch.Tensor, hit: torch.Tensor,
                   iters: int = 4) -> torch.Tensor:
    """Polish the marched crossing to the exact root of the bilinear field.

    Guarded Newton on r -> Phi(o + r d): steps are clamped to half a cell
    (the crossing lies within one cell of the march's estimate), and beams
    whose directional derivative vanishes keep their estimate.  Four steps
    suffice: the start is inside the crossing cell and Newton converges
    quadratically on the cellwise-quadratic field."""
    max_step = 0.5 * cell_size
    r = r0
    for _ in range(iters):
        val, d_dr, _ = _phi_at(geom, cell_size, tsd, pose, r)
        safe = d_dr.abs() > 1e-9
        step = torch.where(safe, -val / torch.where(safe, d_dr, 1.0), 0.0)
        r = torch.where(hit, r + step.clamp(-max_step, max_step), r)
    return r


def _ift_backward(geom: SensorPolar2D, cell_size: float, tsd: torch.Tensor,
                  pose: torch.Tensor, r0: torch.Tensor, hit_f: torch.Tensor,
                  g: torch.Tensor, need_tsd: bool, need_pose: bool):
    """The IFT cotangents (dtsd, dpose) of the ranges' cotangent g, each
    None where not needed."""
    with torch.no_grad():
        _, f_r, ok = _phi_at(geom, cell_size, tsd, pose, r0)
        # at a +/- crossing the field falls along the ray (dF/dr < 0);
        # grazing hits, where it vanishes, are left out
        active = (hit_f > 0.5) & ok & (f_r.abs() > 1e-6)
        u = torch.where(active, -g / torch.where(active, f_r, 1.0), 0.0)
    # dF/d(tsd, pose) at fixed r: the tsd cotangent is a scatter-add into
    # the four-cell stencils of the hit points
    with torch.enable_grad():
        tsd_ = tsd.detach().requires_grad_(need_tsd)
        pose_ = pose.detach().requires_grad_(need_pose)
        grads = iter(torch.autograd.grad(
            _phi_at(geom, cell_size, tsd_, pose_, r0)[0],
            [t for t in (tsd_, pose_) if t.requires_grad],
            grad_outputs=u))
    dtsd = next(grads) if need_tsd else None
    dpose = next(grads) if need_pose else None
    return dtsd, dpose


class _IftRanges(torch.autograd.Function):
    """Identity on the marched ranges r0, with the IFT backward: the
    gradient reaches `tsd` and `pose`; r0 and hit_f are constants of the
    march.  `backward_fn` computes it: `_ift_backward`, or its graph
    (render_ranges_jit)."""

    @staticmethod
    def forward(ctx, geom, cell_size, tsd, pose, r0, hit_f, backward_fn):
        ctx.geom, ctx.cell_size = geom, cell_size
        ctx.backward_fn = backward_fn
        ctx.save_for_backward(tsd, pose, r0, hit_f)
        return r0.clone()

    @staticmethod
    def backward(ctx, g):
        tsd, pose, r0, hit_f = ctx.saved_tensors
        need_tsd, need_pose = ctx.needs_input_grad[2:4]
        dtsd, dpose = ctx.backward_fn(ctx.geom, ctx.cell_size, tsd, pose, r0,
                                      hit_f, g, need_tsd, need_pose)
        return None, None, dtsd, dpose, None, None, None


def _march(grid: TsdGrid, geom: SensorPolar2D, pose: torch.Tensor,
           use_fast: bool, refine: bool, segments: Optional[SegmentCache]
           ) -> Tuple[torch.Tensor, torch.Tensor, RaycastResult]:
    """The forward's march, not differentiated: the marched (and, with
    `refine`, polished) ranges r0, the hit mask as the field's dtype, and
    the raycaster's result."""
    with torch.no_grad():
        if use_fast:
            res = raycast_checked(grid, geom, pose, segments=segments)
        else:
            res = raycast(grid, geom, pose)
        tsd = grid.tsd.detach()
        r0 = res.ranges.to(tsd.dtype)
        if refine:
            r0 = _newton_refine(geom, float(grid.cell_size), tsd,
                                pose.detach(), r0, res.mask)
        hit_f = res.mask.to(tsd.dtype)
    return r0, hit_f, res


def render_ranges(grid: TsdGrid, geom: SensorPolar2D, pose: torch.Tensor,
                  use_fast: bool = True, refine: bool = True,
                  segments: Optional[SegmentCache] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, RaycastResult]:
    """Render the range image from `pose`, differentiably.

    Args:
      grid: TSD state; gradients flow into grid.tsd.
      geom: static scan geometry.
      pose: (3,3) sensor pose; gradients flow into all pose entries
        (compose with se2.make for (x, y, theta) gradients).
      use_fast: march with the guarded isocontour caster
        (raycast_checked) instead of the exact march.
      refine: polish crossings with guarded Newton to the exact bilinear
        root; off, the forward is the raycaster's ranges bit for bit.
      segments: optional extract_segments() cache of `grid` (use_fast
        only): pose-only optimization against a fixed grid then skips the
        extraction.  A stale cache makes the guarded caster re-render with
        the exact march, so the result stays right either way.

    Returns:
      (ranges, hit, result): ranges [B] in meters (0 and a zero gradient
      where no hit), hit [B] bool, and the underlying march's
      RaycastResult (not differentiable).
    """
    r0, hit_f, res = _march(grid, geom, pose, use_fast, refine, segments)
    ranges = _IftRanges.apply(geom, float(grid.cell_size), grid.tsd, pose,
                              r0, hit_f, _ift_backward)
    return ranges, res.mask, res


# --------------------------------------------------------------------------
# the compiled entry point (utils/compiled.py)
# --------------------------------------------------------------------------

def _march_bound(grid: TsdGrid, geom: SensorPolar2D, pose: torch.Tensor,
                 use_fast: bool, refine: bool,
                 segments: Optional[SegmentCache], stale: bool):
    return _march(grid, geom, pose, use_fast, refine,
                  bind_cache(segments, grid, stale))


_forward_graph = compiled(_march_bound, static_argnames=(
    "geom", "use_fast", "refine", "stale"))
_backward_graph = compiled(_ift_backward, static_argnames=(
    "geom", "cell_size", "need_tsd", "need_pose"))


def render_ranges_jit(grid: TsdGrid, geom: SensorPolar2D,
                      pose: torch.Tensor, use_fast: bool = True,
                      refine: bool = True,
                      segments: Optional[SegmentCache] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, RaycastResult]:
    """render_ranges, compiled (ohm_tsd_slam_tpu/grid/render.py::
    render_ranges_jit, `geom`, `use_fast` and `refine` static): the
    forward's march (the guarded caster with its exact march in a
    conditional node, or the exact march, and the Newton refinement) is
    one graph a key, and the IFT backward another, replayed when autograd
    reaches the ranges; the ranges, the hit mask and both gradients equal
    render_ranges' in every bit.  A segment cache's staleness is decided
    here, as in raycast_fast_jit.  On the CPU the eager functions."""
    stale = segments is not None and is_stale(segments, grid)
    r0, hit_f, res = _forward_graph(grid, geom, pose, use_fast, refine,
                                    strip_cache(segments), stale)
    ranges = _IftRanges.apply(geom, float(grid.cell_size), grid.tsd, pose,
                              r0, hit_f, _backward_graph)
    return ranges, res.mask, res


render_ranges_jit.compiled = (_forward_graph, _backward_graph)
