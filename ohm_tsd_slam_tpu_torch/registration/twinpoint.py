"""Two-point RANSAC matcher as fixed-shape candidate batches (port of
ohm_tsd_slam_tpu/registration/twinpoint.py).

TwinPointMatching (src/obvision/registration/ransacMatching/
TwinPointMatching.cpp):

  1) pick a random valid model point idx1 and a second valid point idx2
     3°-10° to its right (offsets counted in the list of valid indices,
     TwinPointMatching.cpp:183-192);
  2) for every scene beam i in the ±span polar window of idx1, find the
     scene beam i2 in [i+minDist, i+maxDist) whose intra-distance best
     matches |M[idx2]−M[idx1]| (the createLutIntraDistance LUT, :59-86,
     :221-247);
  3) rotation from the segment directions, translation from the
     centroids, gated by transMax (:250-284);
  4) consensus: nearest valid model point of each transformed control
     point, with the rotation clip of scene and model indices (:288-338),
     rated by (match ratio, count, −error) (:349-366).

As in the JAX package, the intra-distance LUT is a dense [S, maxDist]
array of offset differences, the per-trial scan over scene beams a
[trials, 2·span] candidate grid, the 1-NN a masked dense distance over
chunks of candidates (`ransac._chunked_scores`, the JAX `lax.map`), and
the omp-critical best update a lexicographic maximum (`ransac._lex_best`).
Every draw takes an explicit `torch.Generator`; the parity tests inject
the reference's (or JAX's) draws through `TwinInject`.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ohm_tsd_slam_tpu_torch.registration.ransac import (
    _BIG,
    RansacParams,
    _chunked_scores,
    _lex_best,
    random_valid_subset,
)

MIN_VALID_POINTS = 10   # TwinPointMatching.cpp:88


class TwinInject(NamedTuple):
    """Draws given instead of drawn, for the parity tests: control indices
    and per-trial valid-rank pairs replayed from the reference's rand()
    stream (TwinPointMatching.cpp:184-191, golden_io.replay_twin)."""

    ctrl_idx: torch.Tensor      # [C] control indices into the scene
    ctrl_valid: torch.Tensor    # [C]
    rank1: torch.Tensor         # [T] rank of idx1 among the valid model
    rank2: torch.Tensor         # [T] rank of idx2
    trial_valid: torch.Tensor   # [T]


def _intra_distance_lut(scene: torch.Tensor, mask: torch.Tensor,
                        min_d: int, max_d: int):
    """Squared distances |S[i+d] − S[i]|² for d in [min_d, max_d).

    createLutIntraDistance (TwinPointMatching.cpp:59-86) restricted to the
    offsets the search reads; an invalid endpoint gives +BIG.  Returns
    ([S, max_d − min_d] distances, the matching indices i + d)."""
    n = scene.shape[0]
    dev = scene.device
    idx2 = (torch.arange(n, device=dev)[:, None]
            + torch.arange(min_d, max_d, device=dev)[None, :])
    inb = idx2 < n
    idx2c = idx2.clamp(0, n - 1)
    d = scene[idx2c] - scene[:, None, :]
    dist2 = (d * d).sum(-1)
    ok = mask[:, None] & mask[idx2c] & inb
    return torch.where(ok, dist2, _BIG), idx2c


def match_twinpoint(generator: Optional[torch.Generator],
                    model: torch.Tensor, mask_model: torch.Tensor,
                    scene: torch.Tensor, mask_scene: torch.Tensor,
                    params: RansacParams,
                    inject: Optional[TwinInject] = None,
                    return_scores: bool = False):
    """TwinPointMatching::match (TwinPointMatching.cpp:88-389).  Returns
    the (3,3) scene-to-model transform, identity when nothing qualifies
    (and with return_scores, the candidate grids as a dict)."""
    if generator is None and inject is None:
        raise ValueError(
            "match_twinpoint needs a torch.Generator on the clouds' device "
            "for its draws, or a TwinInject")
    n = model.shape[0]
    dtype, dev = scene.dtype, scene.device
    res_deg = math.degrees(params.resolution)
    max_d = max(2, int(10.0 / res_deg))       # maxDist2ndSample (:152)
    min_d = max(1, int(3.0 / res_deg))        # minDist2ndSample (:153)
    span = params.span
    phi_max = min(params.phi_max, math.pi * 0.5)
    eps_sqr = params.eps_thresh * params.eps_thresh
    trans_max_sqr = params.trans_max * params.trans_max

    n_mvalid = mask_model.sum()
    ok = (n_mvalid >= MIN_VALID_POINTS) & (mask_scene.sum()
                                           >= MIN_VALID_POINTS)

    # idxMValid as a dense array: the beam of each valid rank (stable, so
    # that the invalid beams' common sentinel keeps beam order)
    order = torch.cumsum(mask_model.to(torch.int64), 0) - 1
    beam_of_rank = torch.argsort(
        torch.where(mask_model, order.to(torch.float32), _BIG), stable=True)

    # trials: randIdx uniform in [0, |valid|-1-minDist), the second sample
    # rank1 + minDist + rand() % (remaining - minDist)
    if inject is not None:
        rank1 = inject.rank1.long()
        rank2 = inject.rank2.long()
        trial_ok = inject.trial_valid & ok
    else:
        u1 = torch.rand(params.trials, generator=generator, dtype=dtype,
                        device=dev)
        u2 = torch.rand(params.trials, generator=generator, dtype=dtype,
                        device=dev)
        hi1 = (n_mvalid - 1 - min_d).clamp(min=1).to(dtype)
        rank1 = torch.floor(u1 * hi1).long()
        remaining = (n_mvalid - rank1 - 1).clamp(max=max_d)
        width = (remaining - min_d).clamp(min=1).to(dtype)
        rank2 = rank1 + min_d + torch.floor(u2 * width).long()
        trial_ok = (rank2 < n_mvalid) & (rank1 >= 0) & ok
    idx1 = beam_of_rank[rank1.clamp(0, n - 1)]
    idx2 = beam_of_rank[rank2.clamp(0, n - 1)]

    v_m = model[idx2] - model[idx1]                          # [T, 2]
    c_m = 0.5 * (model[idx1] + model[idx2])
    dist_m = (v_m * v_m).sum(-1)
    phi_m = torch.atan2(v_m[:, 1], v_m[:, 0])

    # control set from the raw scene validity (TwinPointMatching.cpp:144-146)
    if inject is not None:
        c_idx, c_mask = inject.ctrl_idx.long(), inject.ctrl_valid
    else:
        c_idx, c_mask = random_valid_subset(generator, mask_scene,
                                            params.size_control_set)
    ctrl = scene[c_idx]

    # scene pair search: for each (trial, window beam i) the i2 whose
    # |distS − distM| is least (the first such)
    lut, lut_idx2 = _intra_distance_lut(scene, mask_scene, min_d, max_d)
    i_s = idx1[:, None] + torch.arange(-span, span, device=dev)[None, :]
    in_rng = (i_s >= 0) & (i_s < n)
    i_c = i_s.clamp(0, n - 1)                                 # [T, W]

    diff = (lut[i_c] - dist_m[:, None, None]).abs()           # [T, W, D]
    best_diff, best_d = diff.min(dim=-1)
    i2_best = torch.gather(lut_idx2[i_c], -1, best_d[..., None])[..., 0]

    pair_ok = (trial_ok[:, None] & in_rng & mask_scene[i_c]
               & (best_diff < eps_sqr))

    # rotation + translation from the two segments (:249-277)
    s1 = scene[i_c]                                           # [T, W, 2]
    s2 = scene[i2_best]
    v_s = s2 - s1
    phi = phi_m[:, None] - torch.atan2(v_s[..., 1], v_s[..., 0])
    pair_ok = pair_ok & (phi.abs() < phi_max)

    c_s = 0.5 * (s1 + s2)
    cphi, sphi = torch.cos(phi), torch.sin(phi)
    tx = c_m[:, None, 0] - (cphi * c_s[..., 0] - sphi * c_s[..., 1])
    ty = c_m[:, None, 1] - (sphi * c_s[..., 0] + cphi * c_s[..., 1])
    pair_ok = pair_ok & (tx * tx + ty * ty <= trans_max_sqr)

    # beams the rotation shifts the window by (truncated toward zero)
    clip_f = (phi / params.resolution).to(torch.int64).reshape(-1)
    phi_f = phi.reshape(-1)
    t_f = torch.stack([tx, ty], -1).reshape(-1, 2)

    model_masked_sq = ((model * model).sum(1)
                       + (~mask_model).to(dtype) * _BIG)
    mx = model[:, 0][None, None, :]
    my = model[:, 1][None, None, :]

    def score_chunk(ph, t, valid, clip):
        c, s = torch.cos(ph), torch.sin(ph)
        x = ctrl[None, :, 0]
        y = ctrl[None, :, 1]
        stx = c[:, None] * x - s[:, None] * y + t[:, 0:1]
        sty = s[:, None] * x + c[:, None] * y + t[:, 1:2]

        # scene-side clip (TwinPointMatching.cpp:297-313)
        lo_s = (-clip).clamp(min=0)[:, None]
        hi_s = (n - clip).clamp(max=n)[:, None]
        keep_s = ((c_idx[None, :] >= lo_s) & (c_idx[None, :] <= hi_s)
                  & c_mask[None, :])

        # 1-NN into the valid model: |q|^2 + |m|^2 - 2 q.m, elementwise as
        # in ransac.match_normal
        q2 = stx * stx + sty * sty                            # [k, C]
        d2 = (q2[..., None] + model_masked_sq[None, None, :]
              - 2.0 * (stx[..., None] * mx + sty[..., None] * my))
        d2min, nn = d2.min(dim=-1)
        d2min = d2min.clamp(min=0.0)

        # model-side clip (:320-327)
        lo_m = clip.clamp(min=0)[:, None]
        hi_m = (n + clip).clamp(max=n)[:, None]
        keep = keep_s & (nn >= lo_m) & (nn <= hi_m)

        err = torch.sqrt(torch.where(keep, d2min, 0.0).sum(1))
        cnt = (keep & (d2min < eps_sqr)).sum(1)
        max_cnt = keep.sum(1)
        rate = cnt.to(dtype) / max_cnt.clamp(min=1).to(dtype)
        good = valid & (cnt > 0)
        return (torch.where(good, torch.round(rate * 1e5), -_BIG),
                torch.where(good, cnt.to(dtype), -_BIG), err, max_cnt)

    rate_q, cnt, err, max_cnt = _chunked_scores(
        (phi_f, t_f, pair_ok.reshape(-1), clip_f), params.chunk, score_chunk)

    T = _lex_best((rate_q, cnt, -err), phi_f, t_f, ok)
    if return_scores:
        return T, dict(idx1=idx1, idx2=idx2, i_s=i_s, pair_ok=pair_ok,
                       i2_best=i2_best, rate_q=rate_q, cnt=cnt, err=err,
                       max_cnt=max_cnt, phi=phi_f, t=t_f, span=span)
    return T
