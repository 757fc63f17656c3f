"""The plain reference's SLAM step: the settings of a deployment, the
robots' start, one localization step (a RANSAC seed in modes EXP, PDF and
TSD, then ICP) and its gates, in plain PyTorch.

A frozen copy of the straightforward path of the system under test
(ohm_tsd_slam_tpu_torch's config.py, slam/node.py, slam/localize.py,
registration/icp.py with the modular pair assignment and filters,
registration/estimators.py, registration/ransac.py), trimmed to the four
registration modes of upstream's localizer (ThreadLocalize.h:75-81): ICP
(0), EXP (1, RandomNormalMatching), PDF (2, PDFMatching) and TSD (3,
TSD_PDFMatching).  ICP runs every iteration with a carry that freezes once
the reference implementation would have left its loop.  The RANSAC draws
come from the same per-robot, per-scan generator seeds as the node's,
drawn in the same order and shapes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, NamedTuple, Optional

import torch

from slambench.reference import grid as G

MODE_ICP, MODE_EXP, MODE_PDF, MODE_TSD = 0, 1, 2, 3
# folds (seed, robot, scan counter) into one generator seed, as the node
SEED_MIX = 1_000_003
_BIG = 1e9


def draw_seed(seed: int, robot: int, count: int) -> int:
    return ((seed * SEED_MIX + robot) * SEED_MIX + count) % (1 << 63)


# ---------------------------------------------------------------- settings

@dataclass(frozen=True)
class Beam:
    """PDF's beam model (ThreadLocalize.cpp:114-129; upstream's names in
    the parameters: zhit, zphi, zshort, zmax, zrand, sighit, sigphi,
    lamshort, rangemax, percentagePointsInC, maxAngleDiff)."""

    zhit: float
    zphi: float
    zshort: float
    zmax: float
    zrand: float
    sig_hit: float
    sig_phi: float
    lam_short: float
    range_max: float
    percentage_points_in_c: float
    max_angle_diff_deg: float


@dataclass(frozen=True)
class Robot:
    max_range: float
    min_range: float
    low_reflectivity_range: float
    laser_min_range: float
    offset: tuple               # (x, y, yaw) from the grid's centre
    footprint: tuple            # (width, height, x_offset)
    mode: int
    iterations: int
    dist_min: float
    dist_max: float
    trns_max: float
    rot_max: float
    trns_min: float
    rot_min: float
    trials: int
    eps_thresh: float
    size_control_set: int
    phi_max_deg: float
    beam: Beam


@dataclass(frozen=True)
class Deployment:
    map_size: int
    cell_size: float
    truncation_radius: float
    x_offset: float
    y_offset: float
    inflation: int
    robots: List[Robot]

    @property
    def size_m(self) -> float:
        return 2 ** self.map_size * self.cell_size


def deployment(params: dict) -> Deployment:
    """The deployment of a flat parameter dict in the reference's names
    (the ros__parameters of config/*.yaml), with the defaults of the
    upstream node."""
    n = int(params.get("robot_nbr", 1))
    beam = Beam(
        zhit=float(params.get("zhit", 0.45)),
        zphi=float(params.get("zphi", 0.0)),
        zshort=float(params.get("zshort", 0.25)),
        zmax=float(params.get("zmax", 0.05)),
        zrand=float(params.get("zrand", 0.25)),
        sig_hit=float(params.get("sighit", 0.2)),
        sig_phi=float(params.get("sigphi", math.radians(3.0))),
        lam_short=float(params.get("lamshort", 0.08)),
        range_max=float(params.get("rangemax", 20.0)),
        percentage_points_in_c=float(params.get("percentagePointsInC", 0.9)),
        max_angle_diff_deg=float(params.get("maxAngleDiff", 3.0)))
    robots = []
    for i in range(n):
        ns = ""
        if n > 1:
            name = params.get(f"robot_{i}/name", f"robot{i}")
            ns = str(name) + "/"

        def pick(key, default):
            return params.get(ns + key, params.get(key, default))

        mode = int(pick("registration_mode", 0))
        if mode not in (MODE_ICP, MODE_EXP, MODE_PDF, MODE_TSD):
            raise ValueError(f"registration_mode {mode}: the reference "
                             "runs modes 0 (ICP), 1 (EXP), 2 (PDF) and 3 "
                             "(TSD)")
        robots.append(Robot(
            max_range=float(pick("max_range", 30.0)),
            min_range=float(pick("min_range", 0.001)),
            low_reflectivity_range=float(pick("low_reflectivity_range", 2.0)),
            laser_min_range=float(pick("laser_min_range", 0.0)),
            offset=(float(pick("local_offset_x", 0.0)),
                    float(pick("local_offset_y", 0.0)),
                    float(pick("local_offset_yaw", 0.0))),
            footprint=(float(pick("footprint_width", 1.0)),
                       float(pick("footprint_height", 1.0)),
                       float(pick("footprint_x_offset", 0.28))),
            mode=mode,
            iterations=int(pick("icp_iterations", 25)),
            dist_min=float(pick("dist_filter_min", 0.2)),
            dist_max=float(pick("dist_filter_max", 1.0)),
            trns_max=float(pick("reg_trs_max", 0.25)),
            rot_max=float(pick("reg_sin_rot_max", 0.17)),
            trns_min=0.05, rot_min=0.03,
            trials=int(params.get("trials", 100)),
            eps_thresh=float(params.get("epsThresh", 0.15)),
            size_control_set=int(params.get("sizeControlSet", 140)),
            phi_max_deg=float(pick("ransac_phi_max", 30.0)),
            beam=beam))
    inflate = bool(params.get("use_object_inflation", False))
    return Deployment(
        map_size=int(params.get("map_size", 10)),
        cell_size=float(params.get("cellsize", 0.025)),
        truncation_radius=float(params.get("truncation_radius", 3.0)),
        x_offset=float(params.get("x_offset", 0.0)),
        y_offset=float(params.get("y_offset", 0.0)),
        inflation=(int(params.get("object_inflation_factor", 2))
                   if inflate else 0),
        robots=robots)


def sensor(robot: Robot, beams: int, angle_min: float,
           increment: float) -> G.Sensor:
    return G.Sensor(size=beams, res=increment, phi_min=angle_min,
                    max_range=robot.max_range, min_range=robot.min_range,
                    low_reflectivity_range=robot.low_reflectivity_range)


def start_xy(dep: Deployment, robot: Robot) -> tuple:
    """Where a robot's localizer starts: the grid's centre plus the
    configured offsets (the yaw is offset[2])."""
    return (dep.size_m * 0.5 + dep.x_offset + robot.offset[0],
            dep.size_m * 0.5 + dep.y_offset + robot.offset[1])


def start_pose(dep: Deployment, robot: Robot, dtype, device):
    return G.se2_make(*start_xy(dep, robot), robot.offset[2], dtype, device)


def preprocess(sensor_: G.Sensor, robot: Robot, ranges, dtype, device):
    data = torch.as_tensor(ranges, dtype=dtype, device=device)
    if robot.laser_min_range > 0.0:
        data = torch.where(data < robot.laser_min_range, 0.0, data)
    return G.standard_mask(sensor_, data)


def start(dep: Deployment, first_scans, angle_min: float, increment: float,
          dtype, device) -> G.Grid:
    """The grid after every robot's first scan: each frees its footprint,
    and the first robot's scan is pushed once."""
    grid = G.create(dep.map_size, dep.cell_size, dep.truncation_radius,
                    dtype, device)
    for r, (robot, ranges) in enumerate(zip(dep.robots, first_scans)):
        sen = sensor(robot, len(ranges), angle_min, increment)
        pose = start_pose(dep, robot, dtype, device)
        w, h, xo = robot.footprint
        x, y = start_xy(dep, robot)
        grid = G.free_footprint(grid, (x + xo, y), w, h)
        if r == 0:
            data, mask = preprocess(sen, robot, ranges, dtype, device)
            grid = G.push(grid, sen, pose, data, mask)
    return grid


# ---------------------------------------------------------------- ICP

def _rigid(c, s, tx, ty):
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, tx]), torch.stack([s, c, ty]),
                        torch.stack([zero, zero, one])])


def _closed_form(model, scene, idx, pmask):
    """The closed-form 2D point-to-point fit of the pairs (model[idx],
    scene) and the mean squared pair distance before it."""
    pm = model[idx]
    n = pmask.sum().clamp(min=1).to(pm.dtype)

    def mean(x):
        return torch.sum(torch.where(pmask, x, 0.0)) / n

    rms = mean(torch.sum((pm - scene) ** 2, dim=1))
    cmx, cmy = mean(pm[:, 0]), mean(pm[:, 1])
    csx, csy = mean(scene[:, 0]), mean(scene[:, 1])
    xf, yf = pm[:, 0] - cmx, pm[:, 1] - cmy
    xs, ys = scene[:, 0] - csx, scene[:, 1] - csy
    nom = torch.sum(torch.where(pmask, yf * xs - xf * ys, 0.0))
    den = torch.sum(torch.where(pmask, xf * xs + yf * ys, 0.0))
    dtheta = torch.atan2(nom, den)
    c, s = torch.cos(dtheta), torch.sin(dtheta)
    return _rigid(c, s, cmx - (c * csx - s * csy),
                  cmy - (c * csy + s * csx)), rms


def icp(model, model_mask, scene, scene_mask, robot: Robot, T_init,
        pose, bounds: float):
    """ICP of `scene` onto `model`: nearest neighbours, the shrinking
    distance gate, the reciprocal rule, the closed-form estimate; every
    iteration runs, the carry frozen once the loop would have ended."""
    dtype, dev = scene.dtype, scene.device
    its = robot.iterations
    M = model.shape[0]
    S = scene.shape[0]
    dist_it = (its - 10) & 0xFFFFFFFF
    it1 = float(dist_it - 1) if dist_it >= 1 else 1.0
    mult = 0.0 if it1 == 0.0 else (robot.dist_min / robot.dist_max) ** (
        1.0 / it1)
    thresh2 = ((robot.dist_max ** 2) * torch.pow(
        mult, torch.arange(its, dtype=dtype, device=dev))
    ).clamp(min=robot.dist_min ** 2)

    T = T_init
    rms_prev = torch.full((), 10e12, dtype=dtype, device=dev)
    conv = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    m2 = torch.sum(model * model, dim=1)[None, :]
    scene_ids = torch.arange(S, dtype=dtype, device=dev)
    for it in range(its):
        cur = G.transform_points(T, scene)
        w = G.transform_points(pose, cur)
        smask = (scene_mask & (w[:, 0] >= 0.0) & (w[:, 0] <= bounds)
                 & (w[:, 1] >= 0.0) & (w[:, 1] <= bounds))
        # nearest model point: d² = |s|² + |m|² − 2 s·m, first minimum
        s2 = torch.sum(cur * cur, dim=1, keepdim=True)
        cross = cur[:, 0:1] * model[None, :, 0] + cur[:, 1:2] * model[None, :, 1]
        d2 = torch.where(model_mask[None, :],
                         (s2 + m2 - 2.0 * cross).clamp(min=0.0), torch.inf)
        best, idx = torch.min(d2, dim=1)
        best = torch.where(smask, best, torch.inf)
        pmask = smask & torch.isfinite(best) & (best <= thresh2[it])
        # reciprocal: one pair a model point, the closest, ties to the
        # lowest scene index
        dsel = torch.where(pmask, best, torch.inf)
        col = torch.full((M,), torch.inf, dtype=dtype, device=dev)
        col = col.scatter_reduce(0, idx, dsel, reduce="amin")
        is_best = pmask & (dsel == col[idx])
        sid = torch.where(is_best, scene_ids, torch.inf)
        first = torch.full((M,), torch.inf, dtype=dtype, device=dev)
        first = first.scatter_reduce(0, idx, sid, reduce="amin")
        pmask = is_best & (sid == first[idx])

        T_last, rms = _closed_form(model, cur, idx, pmask)
        matchable = pmask.sum() > 2
        T_new = torch.where(matchable, T_last @ T, T)
        rms = torch.where(matchable, rms, rms_prev)
        plateau = (rms - rms_prev).abs() < 10e-10
        conv_new = torch.where(plateau, conv + 1, 0).to(torch.int32)
        success = matchable & ((rms <= 0.0) | (conv_new >= its))
        T = torch.where(done, T, T_new)
        conv = torch.where(done, conv, conv_new)
        rms_prev = torch.where(done, rms_prev, rms)
        done = done | ~matchable | success
    return T


# ---------------------------------------------------------------- RANSAC

# candidates EXP and PDF score at a time: their [k, C, N] intermediates
# (C control points against N model beams: 0.78 MB a candidate and tensor
# at C = 180, N = 1081 in float32, several alive at once) stay bounded on
# the card; the scores do not depend on it
CHUNK = 256
PCA_RADIUS = 10 // 2          # _pcaSearchRange 10: windows of beams [-5, 5)
SCALE_ORIENTATION = 0.33      # RandomNormalMatching's _scaleOrientation
ZRAND_TSD = 0.25              # TSD_PDFMatching's zrand


def _pca_normals(points, mask, r: int):
    n = points.shape[0]
    dtype, dev = points.dtype, points.device
    beams = torch.arange(n, device=dev)
    idx = beams[:, None] + torch.arange(-r, r, device=dev)[None, :]
    inb = (idx >= 0) & (idx < n)
    idx_c = idx.clamp(0, n - 1)
    wmask = mask[idx_c] & inb
    wpts = points[idx_c]
    cnt = wmask.sum(1)
    wm = wmask[..., None].to(dtype)
    mean = (wpts * wm).sum(1) / cnt.clamp(min=1).to(dtype)[:, None]
    d = (wpts - mean[:, None, :]) * wm
    cxx = (d[..., 0] * d[..., 0]).sum(1)
    cxy = (d[..., 0] * d[..., 1]).sum(1)
    cyy = (d[..., 1] * d[..., 1]).sum(1)
    alpha = 0.5 * torch.atan2(2.0 * cxy, cxx - cyy)
    v1 = torch.stack([torch.cos(alpha), torch.sin(alpha)], dim=-1)
    v2 = torch.stack([-v1[:, 1], v1[:, 0]], dim=-1)

    def extent(v):
        proj = (d * v[:, None, :]).sum(-1)
        return (torch.where(wmask, proj, -_BIG).amax(1)
                - torch.where(wmask, proj, _BIG).amin(1))

    long2, short2 = extent(v1) ** 2, extent(v2) ** 2
    blob = (short2 > 1e-6) & (long2 / short2.clamp(min=1e-30) < 4.0)
    sign = torch.where((points * v2).sum(1) < 0.0, 1.0, -1.0).to(dtype)
    interior = (beams >= r) & (beams < n - r)
    return v2 * sign[:, None], mask & interior & (cnt > 3) & ~blob


def _phi(normals, mask=None):
    phi = torch.atan2(normals[:, 1], normals[:, 0])
    return phi if mask is None else torch.where(mask, phi, -1e6)


def _subset(gen, mask, k: int):
    """The first k of a random strict ranking of the valid indices."""
    score = (torch.rand(mask.shape, generator=gen, device=mask.device)
             + (~mask).to(torch.float32) * _BIG)
    idx = torch.argsort(score, stable=True)[:k]
    return idx, mask[idx]


def _at(x, i):
    return x.index_select(0, i.reshape(1)).squeeze(0)


class Draws(NamedTuple):
    """The draws of a matcher handed in instead of taken from its
    generator: the scene's mask after the subsample, the control set's
    and the trials' indices, each with its validity.  Tests replay the
    compiled upstream's rand() stream into them; the benchmark hands
    none."""

    sub_mask: torch.Tensor      # [N]
    ctrl_idx: torch.Tensor      # [C]
    ctrl_valid: torch.Tensor    # [C]
    trial_idx: torch.Tensor     # [T]
    trial_valid: torch.Tensor   # [T]


class Candidates(NamedTuple):
    """What every RANSAC matcher scores: K = trials × 2·span candidate
    transforms (trial-major, then the scene beam ascending, upstream's
    visit order), and the control set they are scored by."""

    phis: torch.Tensor          # [K] each candidate's rotation
    ts: torch.Tensor            # [K, 2] its translation
    valid: torch.Tensor         # [K]
    ctrl: torch.Tensor          # [C, 2] the control points (scene frame)
    ctrl_mask: torch.Tensor     # [C]
    ctrl_phi: torch.Tensor      # [C] the orientation of their normals
    phi_m: torch.Tensor         # [N] the orientation of the model's normals
    mask_m: torch.Tensor        # [N] model points with a normal
    theta_min: torch.Tensor     # the model's frustum: the polar angles of
    theta_max: torch.Tensor     # its first and last point with a normal
    ok: torch.Tensor            # three normals or more in both clouds
    t_idx: torch.Tensor         # [T] the trials' model indices


def candidates(gen, model, mask_m, scene, mask_s, robot: Robot, res: float,
               draws: Optional[Draws] = None) -> Candidates:
    """The preparation that EXP, PDF and TSD share
    (RandomNormalMatching.cpp:96-263, PDFMatching.cpp:67-175,
    TSD_PDFMatching.cpp:60-170): the model's PCA normals; the scene
    subsampled to ~180 points, its normals taken over the whole scan's
    windows and kept where the subsample keeps the beam; a control set of
    size_control_set scene points with a normal; `trials` model points
    with a normal; and for each trial, every scene beam within ±phi_max
    of its beam whose normal turns onto the trial's by less than phi_max,
    as the rotation by that turn and the translation that lays the scene
    point on the model point.  The draws, from `gen` in this order unless
    `draws` gives them: the subsample, the control set, the trials.

    Departure from upstream: the subsample, the control set and the
    trials are one uniform draw each (a random strict ranking of the valid
    indices) where upstream calls rand() point by point; `draws` replays
    upstream's stream exactly."""
    r = PCA_RADIUS
    nm, mask_mp = _pca_normals(model, mask_m, r)
    phi_m = _phi(nm, mask_mp)
    if draws is None:
        prob = 180.0 / mask_s.sum().clamp(min=1).to(torch.float32)
        keep = torch.rand(mask_s.shape, generator=gen,
                          device=mask_s.device) < prob
        mask_sub = torch.where(prob < 0.99, mask_s & keep, mask_s)
    else:
        mask_sub = draws.sub_mask
    ns, mask_sp = _pca_normals(scene, mask_s, r)
    mask_sp = mask_sp & mask_sub
    phi_s = _phi(ns, mask_sp)
    if draws is None:
        c_idx, c_mask = _subset(gen, mask_sp, robot.size_control_set)
    else:
        c_idx, c_mask = draws.ctrl_idx, draws.ctrl_valid
    n = model.shape[0]
    ok = (mask_mp.sum() >= 3) & (mask_sp.sum() >= 3)
    if draws is None:
        t_idx, t_valid = _subset(gen, mask_mp, robot.trials)
    else:
        t_idx, t_valid = draws.trial_idx, draws.trial_valid
    # the frustum: with no model normal, model[0] and model[n - 1]
    m8 = mask_mp.to(torch.uint8)
    first = _at(model, m8.argmax())
    last = _at(model, n - 1 - m8.flip(0).argmax())

    phi_max = min(math.radians(robot.phi_max_deg), math.pi * 0.5)
    span = max(1, int(math.floor(phi_max / res)))
    offs = torch.arange(-span, span, device=model.device)
    i_s = t_idx[:, None] + offs[None, :]
    i_c = i_s.clamp(0, n - 1)
    dphi = phi_m[t_idx][:, None] - phi_s[i_c]
    dphi = torch.where(dphi > math.pi, dphi - 2.0 * math.pi, dphi)
    dphi = torch.where(dphi < -math.pi, dphi + 2.0 * math.pi, dphi)
    valid = (t_valid[:, None] & (i_s >= r) & (i_s < n - r) & mask_sp[i_c]
             & (dphi.abs() < phi_max))
    c, s = torch.cos(dphi), torch.sin(dphi)
    sx, sy = scene[i_c][..., 0], scene[i_c][..., 1]
    tx = model[t_idx][:, None, 0] - (c * sx - s * sy)
    ty = model[t_idx][:, None, 1] - (s * sx + c * sy)
    return Candidates(
        phis=dphi.reshape(-1), ts=torch.stack([tx, ty], dim=-1).reshape(-1, 2),
        valid=valid.reshape(-1), ctrl=scene[c_idx], ctrl_mask=c_mask,
        ctrl_phi=_phi(ns[c_idx]), phi_m=phi_m, mask_m=mask_mp,
        theta_min=torch.atan2(first[1], first[0]),
        theta_max=torch.atan2(last[1], last[0]), ok=ok, t_idx=t_idx)


def _transform(cands: Candidates, phi, t):
    """The control set under k candidate transforms: [k, C, 2]."""
    c, s = torch.cos(phi), torch.sin(phi)
    x, y = cands.ctrl[None, :, 0], cands.ctrl[None, :, 1]
    return torch.stack([c[:, None] * x - s[:, None] * y + t[:, 0:1],
                        s[:, None] * x + c[:, None] * y + t[:, 1:2]], -1)


def _chunked(cands: Candidates, score, chunk: int):
    """`score(phi [k], t [k, 2], valid [k])` over every candidate, `chunk`
    at a time, each of its [k] outputs joined to [K]."""
    K = cands.phis.shape[0]
    parts = [score(cands.phis[k:k + chunk], cands.ts[k:k + chunk],
                   cands.valid[k:k + chunk]) for k in range(0, K, chunk)]
    return tuple(torch.cat(col) for col in zip(*parts))


def _best(keys, cands: Candidates):
    """The candidate whose keys are largest, compared in order, the lowest
    index among equals, a NaN below every number, as a transform; the
    identity where its first key marks it unqualified (-_BIG) or either
    cloud has fewer than three normals (upstream's TBest fallback).

    Departure from upstream: EXP's winner is this total order, where
    upstream accepts candidates as they stream past by a rule that is not
    one (RandomNormalMatching.cpp:344-360); PDF and TSD keep the first
    highest probability, as upstream's strict `>` does."""
    alive = torch.ones_like(keys[0], dtype=torch.bool)
    for key in keys:
        k = torch.where(alive & ~torch.isnan(key), key, -math.inf)
        alive = alive & (k == k.max())
    b = alive.to(torch.uint8).argmax()
    qualified = _at(keys[0], b) > -_BIG * 0.5
    phi, t = _at(cands.phis, b), _at(cands.ts, b)
    T = _rigid(torch.cos(phi), torch.sin(phi), t[0], t[1])
    return torch.where(cands.ok & qualified, T,
                       torch.eye(3, dtype=t.dtype, device=t.device))


class NormalScores(NamedTuple):
    ratio: torch.Tensor         # [K] cnt / max_cnt, -_BIG where gated out
    cnt: torch.Tensor           # [K] control points that match
    err_sum: torch.Tensor       # [K] their errors summed over the frustum
    max_cnt: torch.Tensor       # [K] control points inside the frustum
    cnt_thresh: torch.Tensor    # |C| // 3


def normal_scores(cands: Candidates, model, robot: Robot,
                  chunk: int = CHUNK) -> NormalScores:
    """RandomNormalMatching's score of each candidate
    (RandomNormalMatching.cpp:265-343): the control set transformed and
    kept inside the model's frustum; each point's first nearest model
    point with a normal, by d² = |q|² + |m|² − 2 q·m; its error d²/ε²
    plus 0.33 · (1 − cos Δφ) / 2, Δφ between the two normals (cos Δφ
    taken as cos·cos + sin·sin); a match where the error is under 1; the
    candidate gated on more matches than a third of the control set.

    Departure from upstream: the nearest point is exact, by a dense
    search, where upstream asks a FLANN kd-tree."""
    dtype = model.dtype
    m2 = torch.sum(model * model, dim=1)
    mx, my = model[:, 0], model[:, 1]
    cosm, sinm = torch.cos(cands.phi_m), torch.sin(cands.phi_m)
    cnt_thresh = cands.ctrl_mask.sum() // 3
    scale_d = 1.0 / (robot.eps_thresh * robot.eps_thresh)

    def score(phi, t, valid):
        st = _transform(cands, phi, t)
        theta = torch.atan2(st[..., 1], st[..., 0])
        in_fov = ((theta >= cands.theta_min) & (theta <= cands.theta_max)
                  & cands.ctrl_mask[None, :])
        max_cnt = in_fov.sum(1)
        q2 = torch.sum(st * st, dim=-1)
        d2 = torch.where(cands.mask_m, q2[..., None] + m2 - 2.0 * (
            st[..., 0:1] * mx + st[..., 1:2] * my), torch.inf)
        d2min, nn = torch.min(d2, dim=-1)
        beta = cands.ctrl_phi[None, :] + phi[:, None]
        cos_d = cosm[nn] * torch.cos(beta) + sinm[nn] * torch.sin(beta)
        err = (d2min.clamp(min=0.0) * scale_d
               + (1.0 - cos_d) / 2.0 * SCALE_ORIENTATION)
        cnt = (in_fov & (err < 1.0)).sum(1)
        ratio = cnt.to(dtype) / max_cnt.clamp(min=1).to(dtype)
        good = valid & (cnt > cnt_thresh) & (max_cnt > 0)
        return (torch.where(good, ratio, -_BIG), cnt,
                torch.where(in_fov, err, 0.0).sum(1), max_cnt)

    return NormalScores(*_chunked(cands, score, chunk), cnt_thresh)


def match_normal(gen, model, mask_m, scene, mask_s, robot: Robot,
                 res: float, draws: Optional[Draws] = None,
                 chunk: int = CHUNK):
    """Mode EXP's seed, RandomNormalMatching::match
    (RandomNormalMatching.cpp:67-395): the candidate with the highest
    share of matches, rounded at upstream's equalThres 1e-5, then the
    most matches, then the least error."""
    cands = candidates(gen, model, mask_m, scene, mask_s, robot, res, draws)
    sc = normal_scores(cands, model, robot, chunk)
    return _best((torch.round(sc.ratio * 1e5), sc.cnt.to(sc.ratio.dtype),
                  -sc.err_sum), cands)


def beam_log_prob(m, s, beam: Beam):
    """log of PDFMatching::probabilityOfTwoSingleScans
    (PDFMatching.cpp:435-487) of a measured range s where the model reads
    m: zhit·N(m − s; sighit) + zshort·Exp(s; lamshort) below m + zmax at
    or past rangemax + zrand/rangemax below it + zphi·sigphi·N(s; sigphi);
    where that sum is 0, -_BIG.

    Kept from upstream: its last term is scaled by sigphi itself, not by
    the Gaussian's normaliser it also computes (PDFMatching.cpp:452)."""
    in_range = s < beam.range_max
    hit = 1.0 / (math.sqrt(2.0 * math.pi) * beam.sig_hit)
    phit = torch.where(in_range, hit * torch.exp(
        -0.5 * (m - s) ** 2 / (beam.sig_hit ** 2)), 0.0)
    pphi = beam.sig_phi * torch.exp(-0.5 * s * s
                                    / (beam.sig_phi * beam.sig_phi))
    norm = 1.0 / (1.0 - torch.exp(-beam.lam_short * m.clamp(min=1e-9)))
    pshort = torch.where(s < m, norm * beam.lam_short
                         * torch.exp(-beam.lam_short * s), 0.0)
    pmax = (s >= beam.range_max).to(s.dtype)
    prand = in_range.to(s.dtype) * (1.0 / beam.range_max)
    p = (beam.zhit * phit + beam.zshort * pshort + beam.zmax * pmax
         + beam.zrand * prand + beam.zphi * pphi)
    return torch.log(p.clamp(min=1e-30)) - (~(p > 0)).to(s.dtype) * _BIG


class PdfScores(NamedTuple):
    logp: torch.Tensor          # [K] log-probability, -_BIG where gated out
    logp_raw: torch.Tensor      # [K] before the gate
    fov_cnt: torch.Tensor       # [K] control points with a model beam near


def pdf_scores(cands: Candidates, model, robot: Robot,
               chunk: int = CHUNK) -> PdfScores:
    """PDFMatching's score of each candidate, the scene on the model
    (PDFMatching.cpp:180-400): each transformed control point takes the
    model point with a normal of the nearest polar angle, the first among
    equals; the beam model's log-probabilities of its range against that
    point's are summed over the control set; the candidate is gated on
    more control points within maxAngleDiff of their model point than
    percentagePointsInC of the control set.

    Departure from upstream: the probabilities multiply as a sum of
    logarithms, where upstream's product underflows."""
    beam = robot.beam
    thresh = math.radians(beam.max_angle_diff_deg)
    m_angle = torch.where(cands.mask_m,
                          torch.atan2(model[:, 1], model[:, 0]), _BIG)
    m_dist = torch.sqrt(torch.sum(model * model, dim=1))
    gate = cands.ctrl_mask.sum().to(model.dtype) * beam.percentage_points_in_c

    def score(phi, t, valid):
        st = _transform(cands, phi, t)
        angle = torch.atan2(st[..., 1], st[..., 0])
        dist = torch.sqrt(torch.sum(st * st, dim=-1))
        diff, nn = torch.min((angle[..., None] - m_angle).abs(), dim=-1)
        fov = ((diff < thresh) & cands.ctrl_mask[None, :]).sum(1)
        logp = torch.where(cands.ctrl_mask[None, :],
                           beam_log_prob(m_dist[nn], dist, beam), 0.0).sum(1)
        good = valid & (fov.to(logp.dtype) > gate)
        return torch.where(good, logp, -_BIG), logp, fov

    return PdfScores(*_chunked(cands, score, chunk))


def match_pdf(gen, model, mask_m, scene, mask_s, robot: Robot, res: float,
              draws: Optional[Draws] = None, chunk: int = CHUNK):
    """Mode PDF's seed, PDFMatching::match (PDFMatching.cpp:47-430): the
    candidate of the highest probability."""
    cands = candidates(gen, model, mask_m, scene, mask_s, robot, res, draws)
    return _best((pdf_scores(cands, model, robot, chunk).logp,), cands)


def match_tsd(gen, grid: G.Grid, pose, model, mask_m, scene, mask_s,
              robot: Robot, res: float, draws: Optional[Draws] = None):
    """Mode TSD's seed, TSD_PDFMatching::match (TSD_PDFMatching.cpp:30-283):
    each candidate scored by the likelihood of the transformed control set
    in the map, 1 − (1 − zrand)·|tsd| a point and zrand where the map
    reads nothing; the most likely kept."""
    cands = candidates(gen, model, mask_m, scene, mask_s, robot, res, draws)
    st = _transform(cands, cands.phis, cands.ts)
    tsd, code = G.interpolate(grid, G.transform_points(pose, st))
    logp = torch.where(code == G.SUCCESS,
                       torch.log((1.0 - (1.0 - ZRAND_TSD) * tsd.abs())
                                 .clamp(min=1e-30)),
                       math.log(ZRAND_TSD))
    logp = torch.where(cands.ctrl_mask[None, :], logp, 0.0).sum(1)
    return _best((torch.where(cands.valid, logp, -_BIG),), cands)


# ---------------------------------------------------------------- the step

class Step(NamedTuple):
    pose: torch.Tensor          # (3, 3) the pose after the scan
    reg_error: torch.Tensor     # bool: the pose was rejected
    significant: torch.Tensor   # bool: the scan goes to the map


def registration_error(robot: Robot, T):
    """Whether the registration's transform T moves too far to be kept."""
    trns = torch.sqrt(T[0, 2] ** 2 + T[1, 2] ** 2)
    err = (trns > robot.trns_max) | (
        torch.sin(G.angle_02pi(T)).abs() > robot.rot_max)
    return err


def significant(robot: Robot, last_pose, new_pose):
    """Whether a pose moved far enough from the last mapped one for its
    scan to go to the map."""
    dx = new_pose[0, 2] - last_pose[0, 2]
    dy = new_pose[1, 2] - last_pose[1, 2]
    dphi = torch.sin(G.angle_02pi(new_pose)
                     - G.angle_02pi(last_pose)).abs()
    return (dphi > robot.rot_min) | (torch.sqrt(dx * dx + dy * dy)
                                     > robot.trns_min)


def step(dep: Deployment, robot: Robot, sen: G.Sensor, grid: G.Grid, pose,
         last_pose, data, mask, gen: Optional[torch.Generator]) -> Step:
    """One localization step of `robot` on `grid` from `pose`."""
    scene, scene_mask = G.to_cartesian(sen, data, mask)
    coords, _, model_mask = G.raycast(grid, sen, pose)
    if robot.mode == MODE_EXP:
        T_init = match_normal(gen, coords, model_mask, scene, scene_mask,
                              robot, sen.res)
    elif robot.mode == MODE_PDF:
        T_init = match_pdf(gen, coords, model_mask, scene, scene_mask,
                           robot, sen.res)
    elif robot.mode == MODE_TSD:
        T_init = match_tsd(gen, grid, pose, coords, model_mask, scene,
                           scene_mask, robot, sen.res)
    else:
        T_init = torch.eye(3, dtype=scene.dtype, device=scene.device)
    T = icp(coords, model_mask, scene, scene_mask, robot, T_init, pose,
            dep.size_m)
    err = registration_error(robot, T) | ~(model_mask.sum() > 0)
    new_pose = torch.where(err, pose, pose @ T)
    return Step(new_pose, err,
                (~err) & significant(robot, last_pose, new_pose))
