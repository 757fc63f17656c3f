"""The plain reference's EXP and PDF matchers (slambench/reference/slam.py)
against the compiled, unmodified upstream (golden/data/ransac/:
RandomNormalMatching and PDFMatching built with a deterministic rand
shim), as tests/test_torch_ransac_golden.py holds the port's.

The upstream rand() stream is replayed (tests/golden_io.py) into the
reference's draws, so it scores upstream's candidate set.  In float64 on
the CPU, with that test's tolerances:

  * the candidate set: every (trial, scene index) pair upstream's trace
    recorded is one the reference keeps;
  * EXP: each candidate's errSum at 1e-8 relative, and upstream's
    streaming acceptance replayed over the reference's scores gives
    upstream's winner at 1e-9;
  * PDF: the positions and probabilities of upstream's best-so-far
    improvements, and the winner at 1e-9.

And in float32, on one generator: the reference's winners equal the
port's in every bit (the reference follows the port's formulas, so that
the check reads 0 against the CPU node).
"""

from __future__ import annotations

import math
import os

import numpy as np
import pytest
import torch

from ohm_tsd_slam_tpu_torch.config import BeamModelConfig
from ohm_tsd_slam_tpu_torch.registration import ransac as P
from slambench.reference import slam as R
from tests.golden_io import (
    RANSAC_DIR,
    load_score3d,
    replay_picks,
    replay_subsample,
)

pytestmark = pytest.mark.skipif(
    not os.path.exists(os.path.join(RANSAC_DIR, "tbest.bin")),
    reason="golden ransac data missing (make -C golden ransac)")

BEAM_KEYS = {"zhit": "beam_zhit", "zphi": "beam_zphi",
             "zshort": "beam_zshort", "zmax": "beam_zmax",
             "zrand": "beam_zrand", "sighit": "beam_sighit",
             "sigphi": "beam_sigphi", "lamshort": "beam_lamshort",
             "rangemax": "beam_rangemax",
             "percentagePointsInC": "beam_percentage_points_in_c",
             "maxAngleDiff": "beam_max_angle_diff"}


def _t(a):
    return torch.from_numpy(np.array(a))


def _padded(idx, size):
    out = np.zeros(size, np.int64)
    out[:len(idx)] = idx
    return _t(out), _t(np.arange(size) < len(idx))


@pytest.fixture(scope="module")
def golden():
    z = np.load(os.path.join(RANSAC_DIR, "inputs.npz"))
    phi_max_deg = math.degrees(float(z["phi_max"]))
    assert math.radians(phi_max_deg) == float(z["phi_max"])
    params = {"registration_mode": 1, "trials": int(z["trials"]),
              "epsThresh": float(z["eps_thresh"]),
              "sizeControlSet": int(z["size_control"]),
              "ransac_phi_max": phi_max_deg,
              **{k: float(z[v]) for k, v in BEAM_KEYS.items()}}
    robot = R.deployment(params).robots[0]
    M, S = _t(z["M"]), _t(z["S"])
    maskM, maskS = _t(z["maskM"]), _t(z["maskS"])
    n, r = M.shape[0], R.PCA_RADIUS
    # upstream's draws: the subsample over the raw scene mask, then the
    # control set and the trials over the indices with a normal
    sub, dr = replay_subsample(int(z["seed"]), maskS.numpy())
    mask_sp = R._pca_normals(S, maskS, r)[1].numpy() & sub
    mask_mp = R._pca_normals(M, maskM, r)[1].numpy()
    ctrl, tidx = replay_picks(
        dr, [i for i in range(r, n - r) if mask_sp[i]],
        [i for i in range(r, n - r) if mask_mp[i]], robot.trials,
        robot.size_control_set)
    draws = R.Draws(_t(sub), *_padded(ctrl, robot.size_control_set),
                    *_padded(tidx, robot.trials))
    clouds = (M, maskM, S, maskS)
    res = float(z["resolution"])
    cands = R.candidates(None, *clouds, robot, res, draws)
    tbest = np.fromfile(os.path.join(RANSAC_DIR, "tbest.bin")
                        ).reshape(3, 3, 3)
    return dict(z=z, robot=robot, clouds=clouds, res=res, draws=draws,
                tidx=tidx, cands=cands, tbest=tbest)


def _cand_index(span, trial, idxm, i):
    off = i - idxm + span
    assert 0 <= off < 2 * span, (trial, idxm, i)
    return trial * 2 * span + off


def _span(g):
    return max(1, int(math.floor(math.radians(g["robot"].phi_max_deg)
                                 / g["res"])))


def _transform(phi, t):
    c, s = math.cos(phi), math.sin(phi)
    return np.array([[c, -s, t[0]], [s, c, t[1]], [0.0, 0.0, 1.0]])


def test_exp_candidates_and_scores_match_upstream(golden):
    g = golden
    sc = R.normal_scores(g["cands"], g["clouds"][0], g["robot"])
    rows = load_score3d(os.path.join(RANSAC_DIR, "exp", "score3D.dat"))
    assert len(rows) > 50
    span, err_sum = _span(g), sc.err_sum.numpy()
    ref_set = set()
    for trial, idxm, i, score in rows:
        assert g["tidx"][int(trial)] == int(idxm)
        k = _cand_index(span, int(trial), int(idxm), int(i))
        ref_set.add(k)
        np.testing.assert_allclose(err_sum[k], score, rtol=1e-8, atol=1e-9)
    # upstream traced exactly the candidates past its gates (|phi| <
    # phiMax, a scene normal, cntMatch > cntMatchThresh)
    passed = g["cands"].valid.numpy() & (sc.cnt.numpy()
                                         > int(sc.cnt_thresh))
    assert set(np.nonzero(passed)[0].tolist()) == ref_set


def test_exp_winner_matches_upstream(golden):
    """Upstream's streaming acceptance (RandomNormalMatching.cpp:344-360),
    in its visit order over the reference's scores, gives upstream's
    TBest.  (The reference's own winner is the lexicographic order's,
    which that rule is not: slam.py::_best.)"""
    g = golden
    cands = g["cands"]
    sc = R.normal_scores(cands, g["clouds"][0], g["robot"])
    cnt, err_sum = sc.cnt.numpy(), sc.err_sum.numpy()
    max_cnt, valid = sc.max_cnt.numpy(), cands.valid.numpy()
    thresh = int(sc.cnt_thresh)
    best = (0.0, 0, 1e12, None)
    for k in range(len(valid)):
        if not valid[k] or cnt[k] <= thresh or max_cnt[k] <= 0:
            continue
        rat = cnt[k] / max_cnt[k]
        b_ratio, b_cnt, b_err, _ = best
        rate = (rat - b_ratio) > 1e-5 and cnt[k] > b_cnt
        # upstream's condition is the signed comparison (:349)
        similar = ((rat - b_ratio) < 1e-5 and cnt[k] == b_cnt
                   and err_sum[k] < b_err)
        if rate or similar:
            best = (rat, cnt[k], err_sum[k], k)
    k = best[3]
    assert k is not None
    T_stream = _transform(float(cands.phis[k]), cands.ts[k].numpy())
    np.testing.assert_allclose(T_stream, g["tbest"][0], atol=1e-9)


def test_pdf_improvements_and_winner_match_upstream(golden):
    g = golden
    cands = g["cands"]
    sc = R.pdf_scores(cands, g["clouds"][0], g["robot"])
    logp_raw, gated = sc.logp_raw.numpy(), sc.logp.numpy()
    rows = load_score3d(os.path.join(RANSAC_DIR, "pdf", "score3D.dat"))
    span = _span(g)
    best, improvements = -np.inf, []
    for k in range(len(gated)):
        # upstream's bestProb starts at 0.0: a probability that underflows
        # to 0 in double never wins
        if gated[k] <= -1e8 or logp_raw[k] <= -708.0:
            continue
        if logp_raw[k] > best:
            best = logp_raw[k]
            improvements.append(k)
    ref = [(_cand_index(span, int(trial), int(idxm), int(i)), score)
           for trial, idxm, i, score in rows]
    assert [k for k, _ in ref] == improvements
    for k, score in ref:
        # the trace prints prob · 10e100 fixed to 9 places
        got = math.exp(logp_raw[k]) * 10e100
        assert abs(got - score) <= 5e-10 + 1e-6 * abs(score), (k, got, score)
    T = R.match_pdf(None, *g["clouds"], g["robot"], g["res"], g["draws"])
    np.testing.assert_allclose(T.numpy(), g["tbest"][1], atol=1e-9)


@pytest.mark.parametrize("seed", [0, 7, 2_900_000_003])
def test_float32_winners_equal_the_ports(golden, seed):
    """On one generator in float32 the reference's EXP and PDF seeds equal
    the port's (registration/ransac.py) in every bit, and neither is the
    identity; the reference's scores do not depend on its chunk."""
    g = golden
    robot = g["robot"]
    M, maskM, S, maskS = g["clouds"]
    clouds = (M.float(), maskM, S.float(), maskS)
    params = P.RansacParams(
        trials=robot.trials, eps_thresh=robot.eps_thresh,
        size_control_set=robot.size_control_set,
        phi_max=math.radians(robot.phi_max_deg), resolution=g["res"])
    b = robot.beam
    bm = BeamModelConfig(
        zhit=b.zhit, zphi=b.zphi, zshort=b.zshort, zmax=b.zmax,
        zrand=b.zrand, sig_hit=b.sig_hit, sig_phi=b.sig_phi,
        lam_short=b.lam_short, max_range=b.range_max,
        percentage_points_in_c=b.percentage_points_in_c,
        max_angle_diff_deg=b.max_angle_diff_deg)

    def gen():
        out = torch.Generator()
        out.manual_seed(seed)
        return out

    eye = torch.eye(3)
    for ref, port in (
            (R.match_normal(gen(), *clouds, robot, g["res"]),
             P.match_normal(gen(), *clouds, params)),
            (R.match_pdf(gen(), *clouds, robot, g["res"]),
             P.match_pdf(gen(), *clouds, params, bm))):
        assert ref.dtype == torch.float32
        assert torch.equal(ref, port), (ref, port)
        assert not torch.equal(ref, eye)
    cands = R.candidates(gen(), *clouds, robot, g["res"])
    for scores in (R.normal_scores, R.pdf_scores):
        whole = scores(cands, clouds[0], robot)
        for chunk in (1, 37):
            for a, b in zip(whole, scores(cands, clouds[0], robot, chunk)):
                assert torch.equal(a, b)
