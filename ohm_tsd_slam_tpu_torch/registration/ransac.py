"""RANSAC global matchers as fixed-shape trial batches (port of
ohm_tsd_slam_tpu/registration/ransac.py).

The reference's ransacMatching family
(src/obvision/registration/ransacMatching/):

  * RandomMatching base machinery: PCA normals over beam windows,
    control-set picking, subsampling (RandomMatching.cpp:41-183)
  * RandomNormalMatching, mode EXP   (RandomNormalMatching.cpp:67-395)
  * PDFMatching, mode PDF            (PDFMatching.cpp:47-430,435-487)
  * TSD_PDFMatching, mode TSD        (TSD_PDFMatching.cpp:30-283)

As in the JAX package, the whole trial set is one draw (a random strict
ranking of the valid model indices), every (trial, scene-beam offset) pair
inside the ±span polar window is one fixed-shape candidate, all candidates
are scored by dense masked tensor code, the winner is the lexicographic
maximum of the score keys (lowest index among equals), and the scan
probability products run in log space.

What differs from the JAX module:

  * every draw takes an explicit `torch.Generator` on the tensors' device
    (no global RNG).  Its numbers are not jax.random's, so the two
    packages and the compiled reference are held together only through
    `RansacInject` (the same subsample, control set and trials handed to
    each);
  * torch runs eagerly, so the [chunk, C, N] intermediates of EXP and PDF
    are real tensors (XLA fuses them away): `RansacParams.chunk` bounds
    them.  TSD has no model axis and scores all candidates in one pass;
  * the nearest model point and its payload are a `torch.min` and a gather
    (`nearest_model_plain` in EXP, `_reduce_min_payload` in PDF), where the
    TPU needed a fused variadic reduce.  On the card EXP's search is one
    CUDA kernel (csrc/nearest_model.cu), which never writes the [chunk, C,
    N] tensor, and the rest of EXP's scoring runs over all candidates at
    once;
  * nothing is read back to the host: an index held in a 0-dim tensor is
    applied with `index_select`, never as a subscript (which would copy it
    to the host first).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from ohm_tsd_slam_tpu_torch.config import BeamModelConfig, RansacConfig
from ohm_tsd_slam_tpu_torch.core import se2
from ohm_tsd_slam_tpu_torch.grid.interpolate import interpolate_bilinear
from ohm_tsd_slam_tpu_torch.grid.state import INTERPOLATE_SUCCESS, TsdGrid

_BIG = 1e9
_PHI_INVALID = -1e6      # RandomMatching::calcPhi invalid marker (:166)


def _at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] along dim 0 for a 0-dim index tensor, without a host read."""
    return x.index_select(0, i.reshape(1)).squeeze(0)


# ---------------------------------------------------------------------------
# RandomMatching base machinery
# ---------------------------------------------------------------------------

def pca_normals(points: torch.Tensor, mask: torch.Tensor,
                search_radius: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-beam normals from PCA over a ±search_radius window.

    RandomMatching::calcNormals (RandomMatching.cpp:77-146): window
    j ∈ [-r, r); needs >3 valid points; principal axes of the centered
    window in closed form (extent = max−min of projections, cf.
    Matrix::pcaAnalysis, gsl/Matrix.cpp:227-326); reject blob-like
    neighborhoods where extent²(major)/extent²(minor) < 4 (unless the
    minor extent² ≤ 1e-6, i.e. collinear); the normal is the minor axis
    oriented toward the sensor (dot(point, n) < 0).

    Returns (normals [N,2], mask_out [N]).
    """
    n = points.shape[0]
    r = search_radius
    dtype, dev = points.dtype, points.device
    beams = torch.arange(n, device=dev)
    idx = beams[:, None] + torch.arange(-r, r, device=dev)[None, :]  # [N, W]
    inb = (idx >= 0) & (idx < n)
    idx_c = idx.clamp(0, n - 1)
    wmask = mask[idx_c] & inb                      # [N, W]
    wpts = points[idx_c]                           # [N, W, 2]

    cnt = wmask.sum(1)
    denom = cnt.clamp(min=1).to(dtype)[:, None]
    wm = wmask[..., None].to(dtype)
    mean = (wpts * wm).sum(1) / denom              # [N, 2]
    d = (wpts - mean[:, None, :]) * wm             # centered, zeroed invalid

    cxx = (d[..., 0] * d[..., 0]).sum(1)
    cxy = (d[..., 0] * d[..., 1]).sum(1)
    cyy = (d[..., 1] * d[..., 1]).sum(1)

    # closed-form principal direction of the 2x2 scatter matrix
    alpha = 0.5 * torch.atan2(2.0 * cxy, cxx - cyy)
    v1 = torch.stack([torch.cos(alpha), torch.sin(alpha)], dim=-1)  # major
    v2 = torch.stack([-v1[:, 1], v1[:, 0]], dim=-1)                 # minor

    def extent(v):
        proj = (d * v[:, None, :]).sum(-1)                          # [N, W]
        pmax = torch.where(wmask, proj, -_BIG).amax(1)
        pmin = torch.where(wmask, proj, _BIG).amin(1)
        return pmax - pmin

    ext1 = extent(v1)
    ext2 = extent(v2)
    len_long2 = ext1 * ext1
    len_short2 = ext2 * ext2
    blob = (len_short2 > 1e-6) & (len_long2 / len_short2.clamp(min=1e-30)
                                  < 4.0)

    # orient toward the sensor (RandomMatching.cpp:125-135)
    sign = torch.where((points * v2).sum(1) < 0.0, 1.0, -1.0).to(dtype)
    normals = v2 * sign[:, None]

    interior = (beams >= r) & (beams < n - r)
    mask_out = mask & interior & (cnt > 3) & ~blob
    return normals, mask_out


def calc_phi(normals: torch.Tensor,
             mask: Optional[torch.Tensor]) -> torch.Tensor:
    """RandomMatching::calcPhi (RandomMatching.cpp:148-169)."""
    phi = torch.atan2(normals[:, 1], normals[:, 0])
    if mask is None:
        return phi
    return torch.where(mask, phi, _PHI_INVALID)


def subsample_mask(generator: torch.Generator, mask: torch.Tensor,
                   target_points: float = 180.0) -> torch.Tensor:
    """Random scene subsampling to ~target_points survivors.

    RandomNormalMatching/PDF/TSD all call
    subsampleMask(maskSpca, size, 180/validPoints) when that probability
    is < 0.99 (RandomNormalMatching.cpp:131-135,
    RandomMatching.cpp:171-183)."""
    prob = target_points / mask.sum().clamp(min=1).to(torch.float32)
    keep = torch.rand(mask.shape, generator=generator,
                      device=mask.device) < prob
    return torch.where(prob < 0.99, mask & keep, mask)


def random_valid_subset(generator: torch.Generator, mask: torch.Tensor,
                        k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """First k of a uniformly random strict ranking of the valid indices
    (= sampling k valid indices without replacement; the functional
    equivalent of pickControlSet's rand()/erase loop,
    RandomMatching.cpp:52-75).

    Returns (indices [k] int64, valid [k]); `valid` is False past the
    number of available valid indices.  The sentinel swallows the uniform
    of an invalid index (float32), so the sort is stable to keep the
    result a function of the seed alone.
    """
    score = (torch.rand(mask.shape, generator=generator, device=mask.device)
             + (~mask).to(torch.float32) * _BIG)
    idx = torch.argsort(score, stable=True)[:k]
    return idx, mask[idx]


# ---------------------------------------------------------------------------
# Static parameters
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RansacParams:
    """Static matcher parameters (hashable).

    Mirrors the ThreadLocalize ctor wiring (ThreadLocalize.cpp:104-117,
    :148-187): trials, epsThresh, sizeControlSet, phiMax, plus the scan
    resolution that the reference passes per call.
    """

    trials: int = 100                   # node "trials" (ThreadLocalize.cpp:105)
    eps_thresh: float = 0.15
    size_control_set: int = 140         # node "sizeControlSet" (:106)
    phi_max: float = math.radians(30.0)
    resolution: float = math.radians(0.25)
    pca_search_range: int = 10          # _pcaSearchRange (fixed in ctor)
    scale_orientation: float = 0.33     # _scaleOrientation
    zrand_tsd: float = 0.25             # node "zrand" -> TSD ctor (ThreadLocalize.cpp:190)
    trans_max: float = 0.25             # transMax gate (TwinPointMatching.cpp:97,278)
    # candidates scored per step by PDF, and by EXP's nearest-model-point
    # search in torch (its path on the CPU; on the card a kernel, which
    # ignores it).  Eager torch materializes the [chunk, C, N] search
    # tensors (605 KB per candidate and tensor at C = 140, N = 1081 in
    # float32, several alive at once), so the chunk sets the matchers'
    # peak memory; the scores do not depend on it.
    chunk: int = 256

    @property
    def span(self) -> int:
        """Polar search radius in beams (RandomNormalMatching.cpp:196-206)."""
        phi = min(self.phi_max, math.pi * 0.5)
        return max(1, int(math.floor(phi / self.resolution)))

    @property
    def scale_distance(self) -> float:
        return 1.0 / (self.eps_thresh * self.eps_thresh)

    @staticmethod
    def from_config(cfg: RansacConfig, resolution: float) -> "RansacParams":
        # no zrand_tsd: the JAX package leaves it at its default too
        return RansacParams(
            trials=cfg.trials,
            eps_thresh=cfg.eps_thresh,
            size_control_set=cfg.size_control_set,
            phi_max=math.radians(cfg.phi_max_deg),
            resolution=resolution,
        )


class RansacInject(NamedTuple):
    """Deterministic draw injection for the parity tests.

    The reference matchers consume libc rand() for the scene subsample,
    the control-set pick and the trial draws
    (RandomMatching.cpp:52-183, RandomNormalMatching.cpp:221-238); the
    golden harness intercepts rand with a replayable LCG
    (golden/shim/detrand.h) and tests/golden_io.py replays the identical
    sequence to produce these fields, so the matchers score the SAME
    candidate set as the compiled reference (and as the JAX package)."""

    sub_mask: Optional[torch.Tensor] = None     # [N] post-subsample mask
    ctrl_idx: Optional[torch.Tensor] = None     # [C] control indices
    ctrl_valid: Optional[torch.Tensor] = None   # [C]
    trial_idx: Optional[torch.Tensor] = None    # [T] model trial indices
    trial_valid: Optional[torch.Tensor] = None  # [T]


class _Prep(NamedTuple):
    """Shared trial/candidate preprocessing for all three matchers."""

    phi_cand: torch.Tensor      # [K] candidate rotation
    t_cand: torch.Tensor        # [K, 2] candidate translation
    cand_valid: torch.Tensor    # [K]
    ctrl: torch.Tensor          # [C, 2] control points (scene frame)
    ctrl_mask: torch.Tensor     # [C]
    ctrl_phi: torch.Tensor      # [C] control normals' orientation
    phi_m: torch.Tensor         # [N] model normals' orientation
    mask_m: torch.Tensor        # [N] model validity after PCA
    theta_min: torch.Tensor     # model frustum bounds
    theta_max: torch.Tensor
    ok: torch.Tensor            # >=3 valid in both clouds
    t_idx: torch.Tensor         # [T] drawn trial model indices


def _prepare(generator: Optional[torch.Generator], model: torch.Tensor,
             mask_m: torch.Tensor, scene: torch.Tensor, mask_s: torch.Tensor,
             p: RansacParams, inject: Optional[RansacInject] = None) -> _Prep:
    """Everything before the trial loop, shared verbatim by
    RandomNormalMatching.cpp:96-206 / PDFMatching.cpp:67-175 /
    TSD_PDFMatching.cpp:60-170.  Draws, in this order and only where
    `inject` gives none: the scene subsample, the control set, the trials.
    `generator` may be None only when `inject` gives all three (a fixed
    seed here would hand every scan the same draws without a word)."""
    r = p.pca_search_range // 2
    inject = inject or RansacInject()
    if generator is None and (inject.sub_mask is None
                              or inject.ctrl_idx is None
                              or inject.trial_idx is None):
        raise ValueError(
            "the RANSAC matchers need a torch.Generator on the clouds' "
            "device for their draws (SlamNode hands every scan its own), or "
            "a RansacInject that gives sub_mask, ctrl_idx and trial_idx")

    # model: PCA normals + orientation
    nm, mask_mp = pca_normals(model, mask_m, r)
    phi_m = calc_phi(nm, mask_mp)

    # scene: subsample to ~180 points, then PCA normals.  The reference
    # passes maskIn=maskS (pre-subsample) to calcNormals while maskOut
    # starts from the subsampled copy (RandomNormalMatching.cpp:131-137):
    # normals use full-mask windows, validity intersects the subsample.
    if inject.sub_mask is not None:
        mask_s_sub = inject.sub_mask
    else:
        mask_s_sub = subsample_mask(generator, mask_s)
    ns_full, mask_sp_full = pca_normals(scene, mask_s, r)
    mask_sp = mask_sp_full & mask_s_sub
    phi_s = calc_phi(ns_full, mask_sp)

    # control set: random valid scene indices (uses the *subsampled* PCA
    # mask, RandomNormalMatching.cpp:141-152)
    if inject.ctrl_idx is not None:
        c_idx, c_mask = inject.ctrl_idx.long(), inject.ctrl_valid
    else:
        c_idx, c_mask = random_valid_subset(generator, mask_sp,
                                            p.size_control_set)
    ctrl = scene[c_idx]
    ctrl_phi = calc_phi(ns_full[c_idx], None)  # calcPhi(NControl, NULL, ...)

    # model frustum from first/last valid model point (argmax of an
    # all-false mask is 0, so `last` is then n - 1, as in the JAX package)
    n = model.shape[0]
    m8 = mask_mp.to(torch.uint8)
    first = _at(model, m8.argmax())
    last = _at(model, n - 1 - m8.flip(0).argmax())
    theta_min = torch.atan2(first[1], first[0])
    theta_max = torch.atan2(last[1], last[0])

    ok = (mask_mp.sum() >= 3) & (mask_sp.sum() >= 3)

    # trials: random valid model indices without replacement
    if inject.trial_idx is not None:
        t_idx, t_valid = inject.trial_idx.long(), inject.trial_valid
    else:
        t_idx, t_valid = random_valid_subset(generator, mask_mp, p.trials)

    # candidates: every scene beam within ±span of the trial beam
    span = p.span
    phi_max = min(p.phi_max, math.pi * 0.5)
    offs = torch.arange(-span, span, device=model.device)
    i_s = t_idx[:, None] + offs[None, :]               # [T, W]
    in_rng = (i_s >= r) & (i_s < n - r)                # iMin/iMax clamp
    i_c = i_s.clamp(0, n - 1)

    dphi = phi_m[t_idx][:, None] - phi_s[i_c]
    dphi = torch.where(dphi > math.pi, dphi - 2.0 * math.pi, dphi)
    dphi = torch.where(dphi < -math.pi, dphi + 2.0 * math.pi, dphi)
    cand_valid = (t_valid[:, None] & in_rng & mask_sp[i_c]
                  & (dphi.abs() < phi_max))

    # T = R(dphi); t = M[idx] - R @ S[i]  (RandomNormalMatching.cpp:253-263)
    c, s = torch.cos(dphi), torch.sin(dphi)
    sx = scene[i_c][..., 0]
    sy = scene[i_c][..., 1]
    mx = model[t_idx][:, None, 0]
    my = model[t_idx][:, None, 1]
    tx = mx - (c * sx - s * sy)
    ty = my - (s * sx + c * sy)

    return _Prep(
        phi_cand=dphi.reshape(-1),
        t_cand=torch.stack([tx, ty], dim=-1).reshape(-1, 2),
        cand_valid=cand_valid.reshape(-1),
        ctrl=ctrl, ctrl_mask=c_mask, ctrl_phi=ctrl_phi,
        phi_m=phi_m, mask_m=mask_mp,
        theta_min=theta_min, theta_max=theta_max, ok=ok, t_idx=t_idx)


def _reduce_min_payload(primary: torch.Tensor,
                        payloads: Sequence[torch.Tensor]):
    """min over the last axis of `primary`, with the `payloads` tables
    ([N], indexed like that axis) read at the first minimum (ties resolve
    to the lowest index, as torch.min documents)."""
    val, idx = primary.min(dim=-1)
    return val, tuple(p[idx] for p in payloads)


def _transform_ctrl(prep: _Prep, phi: torch.Tensor, t: torch.Tensor):
    """Apply candidate transforms to the control set.

    phi: [k]; t: [k, 2] -> [k, C, 2]."""
    c, s = torch.cos(phi), torch.sin(phi)
    x = prep.ctrl[None, :, 0]
    y = prep.ctrl[None, :, 1]
    xs = c[:, None] * x - s[:, None] * y + t[:, 0:1]
    ys = s[:, None] * x + c[:, None] * y + t[:, 1:2]
    return torch.stack([xs, ys], dim=-1)


def _chunked_scores(cands: Sequence[torch.Tensor], chunk: int,
                    score_fn: Callable):
    """Score all candidates, `chunk` at a time -> a tuple of [K] scores.
    `cands` are per-candidate tensors ([K, ...], e.g. phi [K], t [K, 2],
    valid [K]); `score_fn` takes their slices of one chunk and returns a
    tuple of [k] tensors; the last chunk is short, not padded."""
    K = cands[0].shape[0]
    parts = [score_fn(*(c[k0:k0 + chunk] for c in cands))
             for k0 in range(0, K, chunk)]
    return tuple(torch.cat(col) for col in zip(*parts))


def _lex_best(keys: Sequence[torch.Tensor], phis: torch.Tensor,
              ts: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Deterministic winner: lexicographic max over candidate score keys
    (primary first), the lowest index among equals, a NaN key below every
    number (the order of the JAX package's stable lexsort of the negated
    keys).  Returns the (3,3) transform, identity when nothing qualifies
    (the reference's TBest identity fallback)."""
    dtype = ts.dtype
    alive = torch.ones_like(keys[0], dtype=torch.bool)
    for key in keys:
        k = torch.where(alive & ~torch.isnan(key), key, -math.inf)
        alive = alive & (k == k.max())
    b = alive.to(torch.uint8).argmax()          # the first survivor
    qualified = _at(keys[0], b) > -_BIG * 0.5
    phi = _at(phis, b)
    t = _at(ts, b)
    c, s = torch.cos(phi), torch.sin(phi)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    T_cand = torch.stack([
        torch.stack([c, -s, t[0]]),
        torch.stack([s, c, t[1]]),
        torch.stack([zero, zero, one])])
    eye = torch.eye(3, dtype=dtype, device=ts.device)
    return torch.where(ok & qualified, T_cand, eye)


# ---------------------------------------------------------------------------
# RandomNormalMatching — registration mode EXP (1)
# ---------------------------------------------------------------------------

def nearest_model_plain(st: torch.Tensor, q2: torch.Tensor,
                        model: torch.Tensor, model_masked_sq: torch.Tensor,
                        cosm: torch.Tensor, sinm: torch.Tensor, chunk: int):
    """The nearest model point of every transformed control point: EXP's
    1-NN into the valid model, a dense masked distance tensor in place of
    FLANN, `chunk` candidates at a time.

    st [K, C, 2] and q2 [K, C] (its squared norm) are the control points
    under each candidate; model_masked_sq [M] is |m|^2, plus _BIG where the
    model point is masked; cosm, sinm [M] its normal.  The distance is
    d2 = |q|^2 + |m|^2 - 2 q.m in this form (not torch.cdist), so that
    winners agree with the JAX package.  Returns d2min [K, C] (the least d2,
    clamped at 0), idx [K, C] int32 (its first index, as torch.min
    documents) and cos_nn, sin_nn [K, C] (the payload at idx).

    The twin of csrc/nearest_model.cu (ops/nearest_model_cuda.py), which
    computes the same in every bit without the [chunk, C, M] tensor, and
    its path for tensors on the CPU."""
    mx = model[:, 0][None, None, :]
    my = model[:, 1][None, None, :]
    vals, idxs = [], []
    for k0 in range(0, st.shape[0], chunk):
        s = st[k0:k0 + chunk]
        d2 = (q2[k0:k0 + chunk, :, None] + model_masked_sq[None, None, :]
              - 2.0 * (s[..., 0:1] * mx + s[..., 1:2] * my))
        val, idx = d2.min(dim=-1)
        vals.append(val.clamp(min=0.0))
        idxs.append(idx)
    idx = torch.cat(idxs)
    return torch.cat(vals), idx.to(torch.int32), cosm[idx], sinm[idx]


def match_normal(generator: Optional[torch.Generator], model: torch.Tensor,
                 mask_model: torch.Tensor, scene: torch.Tensor,
                 mask_scene: torch.Tensor, params: RansacParams,
                 inject: Optional[RansacInject] = None,
                 return_scores: bool = False):
    """RandomNormalMatching::match (RandomNormalMatching.cpp:67-395).

    Per candidate: transform the control set, clip to the model frustum,
    1-NN into the valid model (nearest_model_plain, on the card the kernel
    of csrc/nearest_model.cu), error = NN-distance·(1/ε²) +
    normal-consensus (1−cos Δφ)/2·0.33; count err<1 matches; gate
    cntMatch > |C|/3; winner by (ratio, cnt, −errSum) (:298-360).
    Everything on [K, C] runs over all candidates at once; only the
    nearest-model-point search, whose torch body holds a [chunk, C, M]
    tensor, goes `params.chunk` candidates at a time.
    """
    from ohm_tsd_slam_tpu_torch.ops.nearest_model_cuda import nearest_model

    prep = _prepare(generator, model, mask_model, scene, mask_scene, params,
                    inject)
    dtype = scene.dtype
    model_masked_sq = ((model * model).sum(1)
                       + (~prep.mask_m).to(dtype) * _BIG)
    cnt_thresh = prep.ctrl_mask.sum() // 3          # cntMatchThresh
    # the winning model point's normal enters only through
    # cos(phi_m[nn] - beta) = cos(phi_m[nn])cos(beta) + sin(phi_m[nn])
    # sin(beta)
    cosm = torch.cos(prep.phi_m)
    sinm = torch.sin(prep.phi_m)
    phi, valid = prep.phi_cand, prep.cand_valid

    st = _transform_ctrl(prep, phi, prep.t_cand)              # [K, C, 2]
    theta = torch.atan2(st[..., 1], st[..., 0])
    in_fov = ((theta >= prep.theta_min) & (theta <= prep.theta_max)
              & prep.ctrl_mask[None, :])
    max_cnt = in_fov.sum(1)
    q2 = (st * st).sum(-1)                                    # [K, C]
    d2min, _, cos_nn, sin_nn = nearest_model(
        st, q2, model, model_masked_sq, cosm, sinm, valid, params.chunk)

    # normal consensus (RandomNormalMatching.cpp:310-318)
    beta = prep.ctrl_phi[None, :] + phi[:, None]
    ncons = (1.0 - (cos_nn * torch.cos(beta)
                    + sin_nn * torch.sin(beta))) / 2.0
    err = (d2min * params.scale_distance
           + ncons * params.scale_orientation)
    err_sum = torch.where(in_fov, err, 0.0).sum(1)
    cnt = (in_fov & (err < 1.0)).sum(1)

    ratio = cnt.to(dtype) / max_cnt.clamp(min=1).to(dtype)
    good = valid & (cnt > cnt_thresh) & (max_cnt > 0)
    ratio = torch.where(good, ratio, -_BIG)
    # quantize ratio by the reference's equalThres=1e-5 so the
    # similarity tie-break (equal ratio -> lower errSum) applies
    ratio_q = torch.round(ratio * 1e5)
    T = _lex_best((ratio_q, cnt.to(ratio.dtype), -err_sum),
                  prep.phi_cand, prep.t_cand, prep.ok)
    if return_scores:
        return T, dict(prep=prep, ratio=ratio, cnt=cnt,
                       err_sum=err_sum, max_cnt=max_cnt,
                       cnt_thresh=cnt_thresh)
    return T


def normal_work(scores: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """The search work of one match_normal call, from its return_scores:
    the candidates that pass cand_valid, and the (control point, model
    point) pairs the nearest-model-point search has to test for them: Σ
    over those candidates of their control points in the model's view
    (max_cnt), times the valid model points.  Two int64 tensors on the
    clouds' device (no host read)."""
    prep = scores["prep"]
    valid = prep.cand_valid
    in_view = torch.where(valid, scores["max_cnt"], 0).sum()
    return valid.sum(), in_view * prep.mask_m.sum()


# ---------------------------------------------------------------------------
# PDFMatching — registration mode PDF (2)
# ---------------------------------------------------------------------------

def beam_model_log_prob(m: torch.Tensor, s: torch.Tensor,
                        bm: BeamModelConfig) -> torch.Tensor:
    """log of PDFMatching::probabilityOfTwoSingleScans
    (PDFMatching.cpp:435-487): zhit·N(m−s;σhit) + zshort·Exp + zmax·[s≥max]
    + zrand/rangemax + zphi·N(s;σphi)."""
    sigphit = 1.0 / (math.sqrt(2.0 * math.pi) * bm.sig_hit)
    in_range = s < bm.max_range
    phit = torch.where(in_range,
                       sigphit * torch.exp(-0.5 * (m - s) ** 2
                                           / (bm.sig_hit ** 2)), 0.0)
    # replicated quirk: the reference scales pphi by _sigphi itself, not
    # the Gaussian normalizer _sigpphi it also computes (PDFMatching.cpp:452)
    pphi = bm.sig_phi * torch.exp(-0.5 * s * s / (bm.sig_phi * bm.sig_phi))
    n = 1.0 / (1.0 - torch.exp(-bm.lam_short * m.clamp(min=1e-9)))
    pshort = torch.where(s < m,
                         n * bm.lam_short * torch.exp(-bm.lam_short * s),
                         0.0)
    pmax = (s >= bm.max_range).to(s.dtype)
    prand = in_range.to(s.dtype) * (1.0 / bm.max_range)
    p = (bm.zhit * phit + bm.zshort * pshort + bm.zmax * pmax
         + bm.zrand * prand + bm.zphi * pphi)
    return torch.log(p.clamp(min=1e-30)) - (~(p > 0)).to(s.dtype) * _BIG


def match_pdf(generator: Optional[torch.Generator], model: torch.Tensor,
              mask_model: torch.Tensor, scene: torch.Tensor,
              mask_scene: torch.Tensor, params: RansacParams,
              bm: BeamModelConfig, inject: Optional[RansacInject] = None,
              return_scores: bool = False):
    """PDFMatching::match, MATCH_SCENE_ON_MODEL branch
    (PDFMatching.cpp:47-430): per candidate, each transformed control
    point finds the model point of nearest polar angle; per-point
    beam-model probabilities multiply into the measurement probability;
    gate: fieldOfViewCount (angle diff < maxAngleDiff) must exceed
    |C|·percentagePointsInC; winner = highest probability.
    """
    prep = _prepare(generator, model, mask_model, scene, mask_scene, params,
                    inject)
    angle_thresh = math.radians(bm.max_angle_diff_deg)

    m_angle = torch.atan2(model[:, 1], model[:, 0])
    m_angle = torch.where(prep.mask_m, m_angle, _BIG)   # excluded from min
    m_dist = torch.sqrt((model * model).sum(1))
    c_gate = prep.ctrl_mask.sum().to(scene.dtype) * bm.percentage_points_in_c

    def score_chunk(phi, t, valid):
        st = _transform_ctrl(prep, phi, t)                     # [k, C, 2]
        angle = torch.atan2(st[..., 1], st[..., 0])
        dist = torch.sqrt((st * st).sum(-1))
        diff = (angle[..., None] - m_angle[None, None, :]).abs()
        min_diff, (mdist_nn,) = _reduce_min_payload(diff, (m_dist,))
        fov_cnt = ((min_diff < angle_thresh) & prep.ctrl_mask[None, :]).sum(1)
        logp = beam_model_log_prob(mdist_nn, dist, bm)
        logp_sum = torch.where(prep.ctrl_mask[None, :], logp, 0.0).sum(1)
        good = valid & (fov_cnt.to(logp_sum.dtype) > c_gate)
        return torch.where(good, logp_sum, -_BIG), logp_sum, fov_cnt

    logp, logp_raw, fov_cnt = _chunked_scores(
        (prep.phi_cand, prep.t_cand, prep.cand_valid), params.chunk,
        score_chunk)
    T = _lex_best((logp,), prep.phi_cand, prep.t_cand, prep.ok)
    if return_scores:
        return T, dict(prep=prep, logp=logp, logp_raw=logp_raw,
                       fov_cnt=fov_cnt, c_gate=c_gate)
    return T


# ---------------------------------------------------------------------------
# TSD_PDFMatching — registration mode TSD (3)
# ---------------------------------------------------------------------------

def match_tsd(generator: Optional[torch.Generator], grid: TsdGrid,
              sensor_pose: torch.Tensor, model: torch.Tensor,
              mask_model: torch.Tensor, scene: torch.Tensor,
              mask_scene: torch.Tensor, params: RansacParams,
              inject: Optional[RansacInject] = None,
              return_scores: bool = False,
              logp_sum_fn: Optional[Callable] = None):
    """TSD_PDFMatching::match (TSD_PDFMatching.cpp:30-283): candidates
    are scored directly against the map: transform the control set into
    the map frame (TMap = TSensor·T), read the TSD field bilinearly, and
    multiply per-point likelihoods (1 − (1−zrand)·|tsd|), zrand on
    interpolation misses (:223-251).  Winner = highest probability.

    All K candidates are scored in one pass: without a model axis the
    largest tensor is [K, C, 2] (27 MB at 100 trials, 240 offsets and 140
    control points in float32), so `params.chunk` does not apply.

    `logp_sum_fn(world [K, C, 2], ctrl_mask [C]) -> [K]`, when given,
    replaces the grid taps and the masked sum (grid may then be None):
    the row-sharded path plugs its shard-local taps in here
    (parallel/shard_matchers.py).
    """
    prep = _prepare(generator, model, mask_model, scene, mask_scene, params,
                    inject)
    zrand = params.zrand_tsd
    log_zrand = math.log(zrand)

    st = _transform_ctrl(prep, prep.phi_cand, prep.t_cand)     # [K, C, 2]
    world = se2.transform_points(sensor_pose, st)
    if logp_sum_fn is not None:
        logp_raw = logp_sum_fn(world, prep.ctrl_mask)
    else:
        tsd, code = interpolate_bilinear(grid, world)
        logp = torch.where(
            code == INTERPOLATE_SUCCESS,
            torch.log((1.0 - (1.0 - zrand) * tsd.abs()).clamp(min=1e-30)),
            log_zrand)
        logp_raw = torch.where(prep.ctrl_mask[None, :], logp, 0.0).sum(1)
    logp = torch.where(prep.cand_valid, logp_raw, -_BIG)

    T = _lex_best((logp,), prep.phi_cand, prep.t_cand, prep.ok)
    if return_scores:
        return T, dict(prep=prep, logp=logp, logp_raw=logp_raw)
    return T
