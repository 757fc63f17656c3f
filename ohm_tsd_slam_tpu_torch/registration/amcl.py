"""Adaptive Monte-Carlo matching against the TSD grid (port of
ohm_tsd_slam_tpu/registration/amcl.py, registration mode AMCL).

The reference declares this matcher and never implements it
(src/obvision/registration/amcl/AdaptiveMonteCarloMatching.h:16-40 is a
header with no .cpp and no build entry).  As in the JAX package it is a
particle filter of fixed shape that localizes a scene scan against the map:

* particles: a [P, 3] batch of (x, y, theta) perturbations of the pose;
* measurement model: the TSD likelihood TSD_PDFMatching rates candidate
  poses with (TSD_PDFMatching.cpp:233-251): p = 1 - (1-zrand)·|tsd| on
  bilinear hits, zrand on misses;
* adaptivity: no variable particle count (KLD sampling); the effective
  sample size widens the resampling jitter when it is low, and the
  annealed jitter shrinks when it is high;
* resampling: systematic (low-variance), by cumulative weights and a
  left-sided search.

What differs from the JAX module: every draw takes an explicit
`torch.Generator` on the tensors' device; its numbers are not
jax.random's, so the parity tests inject JAX's draws through `AmclInject`.
The `lax.scan` over the iterations is a Python loop over fixed shapes, and
nothing is read back to the host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

from ohm_tsd_slam_tpu_torch.core import se2
from ohm_tsd_slam_tpu_torch.grid.interpolate import interpolate_bilinear
from ohm_tsd_slam_tpu_torch.grid.state import INTERPOLATE_SUCCESS, TsdGrid
from ohm_tsd_slam_tpu_torch.registration.ransac import (
    _at,
    random_valid_subset,
)


@dataclass(frozen=True)
class AmclParams:
    """Static AMCL parameters (hashable)."""

    particles: int = 512
    iterations: int = 8
    sigma_trans: float = 0.25       # initial proposal std-dev (m)
    sigma_rot: float = 0.17         # initial proposal std-dev (rad)
    anneal: float = 0.6             # per-iteration jitter decay
    zrand: float = 0.25             # miss likelihood (matches zrand_tsd)
    size_control_set: int = 140     # scene subsample per likelihood eval
    ess_target: float = 0.5         # adaptive jitter kicks in below this
    ess_boost_max: float = 3.0      # jitter widening cap


class AmclInject(NamedTuple):
    """The filter's draws, given instead of drawn (the parity tests hand
    both packages JAX's): the control set, the initial particles (already
    scaled by the proposal's sigmas; particle 0 is pinned to the prior
    either way), and for each iteration the systematic resampling's offset
    u0 in [0, 1/P) and the jitter's standard normals."""

    ctrl_idx: torch.Tensor      # [C] control indices into the scene
    ctrl_valid: torch.Tensor    # [C]
    p0: torch.Tensor            # [P, 3]
    u0: torch.Tensor            # [iterations]
    noise: torch.Tensor         # [iterations, P, 3]


def _log_likelihood(grid: TsdGrid, sensor_pose: torch.Tensor,
                    ctrl: torch.Tensor, ctrl_mask: torch.Tensor,
                    particles: torch.Tensor, zrand: float,
                    logp_sum_fn: Optional[Callable] = None) -> torch.Tensor:
    """TSD log-likelihood of each particle pose. particles: [P, 3].
    `logp_sum_fn(world [P, C, 2], ctrl_mask [C]) -> [P]`, when given,
    replaces the grid taps and the masked sum (parallel/shard_matchers.py).
    """
    c, s = torch.cos(particles[:, 2]), torch.sin(particles[:, 2])
    # the control points through each particle's perturbation
    x = ctrl[None, :, 0]
    y = ctrl[None, :, 1]
    px = c[:, None] * x - s[:, None] * y + particles[:, 0:1]
    py = s[:, None] * x + c[:, None] * y + particles[:, 1:2]
    local = torch.stack([px, py], dim=-1)                # [P, C, 2]
    if logp_sum_fn is not None:
        return logp_sum_fn(se2.transform_points(sensor_pose, local),
                           ctrl_mask)
    world = se2.transform_points(sensor_pose, local.reshape(-1, 2))
    tsd, code = interpolate_bilinear(grid, world)
    logp = torch.where(
        code == INTERPOLATE_SUCCESS,
        torch.log((1.0 - (1.0 - zrand) * tsd.abs()).clamp(min=1e-30)),
        math.log(zrand)).reshape(particles.shape[0], -1)
    return torch.where(ctrl_mask[None, :], logp, 0.0).sum(1)


def _systematic_resample(u0: torch.Tensor,
                         logw: torch.Tensor) -> torch.Tensor:
    """Indices of a low-variance (systematic) resampling of the particles
    weighted by softmax(logw), from the offset u0 in [0, 1/P)."""
    n = logw.shape[0]
    cum = torch.cumsum(torch.softmax(logw, dim=0), dim=0)
    u = u0 + torch.arange(n, dtype=logw.dtype, device=logw.device) / n
    return torch.searchsorted(cum, u).clamp(0, n - 1)


def match_amcl(generator: Optional[torch.Generator], grid: TsdGrid,
               sensor_pose: torch.Tensor, scene: torch.Tensor,
               mask_scene: torch.Tensor,
               params: AmclParams = AmclParams(),
               inject: Optional[AmclInject] = None,
               logp_sum_fn: Optional[Callable] = None) -> torch.Tensor:
    """Monte-Carlo scene-to-map matching (the working realization of
    AdaptiveMonteCarloMatching::match, AdaptiveMonteCarloMatching.h:35).

    Args:
      generator: the draw stream (a torch.Generator on the tensors'
        device); may be None only with `inject`.
      grid: the TSD map.
      sensor_pose: (3,3) current sensor pose estimate (map frame).
      scene: (N,2) scene points in the sensor frame.
      mask_scene: (N,) scene validity.
      params: static filter parameters.
      inject: the draws, given (see AmclInject).
      logp_sum_fn: replaces the grid taps of the likelihood (grid may
        then be None; see _log_likelihood): the row-sharded path's hook.
    Returns:
      (3,3) SE(2) sensor-frame correction, as the RANSAC matchers return:
      apply as pose' = sensor_pose @ T.
    """
    if generator is None and inject is None:
        raise ValueError(
            "match_amcl needs a torch.Generator on the scene's device for "
            "its draws (SlamNode hands every scan its own), or an AmclInject")
    dtype, dev = scene.dtype, scene.device
    P = params.particles
    # the proposal's std-devs (x, y, theta), filled on the device
    sigma = torch.stack([torch.full((), v, dtype=dtype, device=dev) for v in
                         (params.sigma_trans, params.sigma_trans,
                          params.sigma_rot)])
    if inject is not None:
        idx, ctrl_mask = inject.ctrl_idx.long(), inject.ctrl_valid
        p0 = inject.p0.to(dtype)
    else:
        idx, ctrl_mask = random_valid_subset(generator, mask_scene,
                                             params.size_control_set)
        p0 = torch.randn((P, 3), generator=generator, dtype=dtype,
                         device=dev) * sigma[None, :]
    ctrl = scene[idx]
    # particle 0 pinned to the prior: the filter never does worse than the
    # incoming estimate
    particles = torch.cat([torch.zeros_like(p0[:1]), p0[1:]])

    for it in range(params.iterations):
        decay = params.anneal ** it
        logw = _log_likelihood(grid, sensor_pose, ctrl, ctrl_mask,
                               particles, params.zrand, logp_sum_fn)
        w = torch.softmax(logw, dim=0)
        ess = 1.0 / (w * w).sum().clamp(min=1e-30)
        boost = (params.ess_target / (ess / P).clamp(min=1e-6)).clamp(
            1.0, params.ess_boost_max)
        if inject is not None:
            u0, noise = inject.u0[it].to(dtype), inject.noise[it].to(dtype)
        else:
            u0 = torch.rand((), generator=generator, dtype=dtype,
                            device=dev) / P
            noise = torch.randn((P, 3), generator=generator, dtype=dtype,
                                device=dev)
        resampled = particles[_systematic_resample(u0, logw)]
        particles = resampled + noise * (sigma * decay)[None, :] * boost

    # final selection: the highest-likelihood particle (no jitter)
    logw = _log_likelihood(grid, sensor_pose, ctrl, ctrl_mask, particles,
                           params.zrand, logp_sum_fn)
    best = _at(particles, logw.argmax())
    return se2.make(best[0], best[1], best[2], dtype=dtype)
