"""The port's RANSAC matchers against the compiled, unmodified reference
(golden/data/ransac/: RandomNormalMatching / PDFMatching / TSD_PDFMatching
built with a deterministic rand shim), as
tests/test_reference_parity_ransac.py holds the JAX matchers to it.

The reference's rand() stream is replayed in Python (golden_io.DetRand) to
recover the identical subsample mask, control set and trial draws; those
are injected into the port's matchers (RansacInject), which then score the
SAME candidate set.  Asserted, in float64 on the CPU:

  * the candidate set: every (trial, scene index) pair the reference's
    trace recorded equals the port's gated candidates, which pins the PCA
    masks too;
  * EXP: per-candidate errSum at 1e-8 relative;
  * PDF/TSD: the positions and probabilities of the reference's
    best-so-far improvements;
  * the winning transform of each matcher against tbest.bin at 1e-9 (EXP
    through the reference's streaming acceptance rule, which is not a total
    order, replayed over the port's score grids).

This file imports torch and numpy only (no JAX function is traced).
"""

import math
import os

import numpy as np
import pytest
import torch

from ohm_tsd_slam_tpu_torch.config import BeamModelConfig, GridConfig
from ohm_tsd_slam_tpu_torch.grid.push import push
from ohm_tsd_slam_tpu_torch.grid.state import create
from ohm_tsd_slam_tpu_torch.registration.ransac import (
    RansacInject,
    RansacParams,
    match_normal,
    match_pdf,
    match_tsd,
    pca_normals,
)
from ohm_tsd_slam_tpu_torch.sensor.polar2d import SensorPolar2D

from golden_io import (
    RANSAC_DIR,
    load_score3d,
    replay_picks,
    replay_subsample,
)

pytestmark = pytest.mark.skipif(
    not os.path.exists(os.path.join(RANSAC_DIR, "tbest.bin")),
    reason="golden ransac data missing (make -C golden ransac)")


def _t(a):
    return torch.from_numpy(np.array(a))


def padded(idx, size):
    """`idx` in the first slots of `size` int64 zeros, and the flags."""
    out = np.zeros(size, np.int64)
    out[:len(idx)] = idx
    return _t(out), _t(np.arange(size) < len(idx))


def replayed_inject(seed, model, mask_m, scene, mask_s, params):
    """The draws the reference made from `seed`, as a RansacInject, and
    the trial indices (see golden_io)."""
    r = params.pca_search_range // 2
    n = model.shape[0]
    _, mask_mp = pca_normals(model, mask_m, r)
    sub, dr = replay_subsample(seed, mask_s.numpy())
    _, mask_sp_full = pca_normals(scene, mask_s, r)
    mask_sp = mask_sp_full.numpy() & sub
    mask_mp = mask_mp.numpy()
    idx_s_valid = [i for i in range(r, n - r) if mask_sp[i]]
    idx_m_valid = [i for i in range(r, n - r) if mask_mp[i]]
    ctrl, tidx = replay_picks(dr, idx_s_valid, idx_m_valid, params.trials,
                              params.size_control_set)
    return RansacInject(_t(sub), *padded(ctrl, params.size_control_set),
                        *padded(tidx, params.trials)), tidx


@pytest.fixture(scope="module")
def setup():
    z = np.load(os.path.join(RANSAC_DIR, "inputs.npz"))
    M, S = _t(z["M"]), _t(z["S"])
    maskM, maskS = _t(z["maskM"]), _t(z["maskS"])
    params = RansacParams(
        trials=int(z["trials"]), eps_thresh=float(z["eps_thresh"]),
        size_control_set=int(z["size_control"]),
        phi_max=float(z["phi_max"]), resolution=float(z["resolution"]),
        zrand_tsd=float(z["zrand_tsd"]))
    inject, tidx = replayed_inject(int(z["seed"]), M, maskM, S, maskS,
                                   params)
    tbest = np.fromfile(os.path.join(RANSAC_DIR, "tbest.bin")
                        ).reshape(3, 3, 3)
    return dict(z=z, M=M, S=S, maskM=maskM, maskS=maskS, params=params,
                inject=inject, tidx=tidx, tbest=tbest)


def _clouds(s):
    return s["M"], s["maskM"], s["S"], s["maskS"]


def _cand_index(params, trial, idxm, i):
    span = params.span
    off = i - idxm + span
    assert 0 <= off < 2 * span, (trial, idxm, i)
    return trial * 2 * span + off


def _visit_order(params, tidx):
    """C++ candidate visit order: trials ascending, i ascending."""
    return range(len(tidx) * 2 * params.span)


@pytest.fixture(scope="module")
def exp_scores(setup):
    _, aux = match_normal(None, *_clouds(setup), setup["params"],
                          inject=setup["inject"], return_scores=True)
    return aux


def test_exp_candidate_scores_match(setup, exp_scores):
    s, aux = setup, exp_scores
    rows = load_score3d(os.path.join(RANSAC_DIR, "exp", "score3D.dat"))
    assert len(rows) > 50
    err_sum = aux["err_sum"].numpy()
    cnt = aux["cnt"].numpy()
    thresh = int(aux["cnt_thresh"])
    cand_valid = aux["prep"].cand_valid.numpy()

    # the reference traced exactly the candidates passing its gates
    # (|phi| < phiMax, maskSpca, cntMatch > cntMatchThresh,
    # RandomNormalMatching.cpp:338-379): the sets must agree
    ref_set = set()
    for trial, idxm, i, score in rows:
        trial = int(trial)
        assert s["tidx"][trial] == int(idxm)       # trial draw replay
        k = _cand_index(s["params"], trial, int(idxm), int(i))
        ref_set.add(k)
        np.testing.assert_allclose(err_sum[k], score, rtol=1e-8, atol=1e-9)
    got = {int(k) for k in np.nonzero(cand_valid & (cnt > thresh))[0]
           if k // (2 * s["params"].span) < len(s["tidx"])}
    assert got == ref_set


def test_exp_winner_matches(setup, exp_scores):
    """The reference's streaming acceptance
    (RandomNormalMatching.cpp:344-360) replayed over the port's score
    grids gives the compiled reference's TBest."""
    s, aux = setup, exp_scores
    cnt = aux["cnt"].numpy()
    err_sum = aux["err_sum"].numpy()
    max_cnt = aux["max_cnt"].numpy()
    valid = aux["prep"].cand_valid.numpy()
    phi = aux["prep"].phi_cand.numpy()
    t = aux["prep"].t_cand.numpy()
    thresh = int(aux["cnt_thresh"])

    best = (0.0, 0, 1e12, None)
    for k in _visit_order(s["params"], s["tidx"]):
        if not valid[k] or cnt[k] <= thresh or max_cnt[k] <= 0:
            continue
        rat = cnt[k] / max_cnt[k]
        b_ratio, b_cnt, b_err, _ = best
        rate = ((rat - b_ratio) > 1e-5) and (cnt[k] > b_cnt)
        # replicated quirk (RandomNormalMatching.cpp:349): the condition
        # is the SIGNED comparison, not an absolute-difference band
        similar = (((rat - b_ratio) < 1e-5) and (cnt[k] == b_cnt)
                   and err_sum[k] < b_err)
        if rate or similar:
            best = (rat, cnt[k], err_sum[k], k)

    k = best[3]
    assert k is not None
    c, sn = math.cos(phi[k]), math.sin(phi[k])
    T_stream = np.array([[c, -sn, t[k, 0]], [sn, c, t[k, 1]],
                         [0.0, 0.0, 1.0]])
    np.testing.assert_allclose(T_stream, s["tbest"][0], atol=1e-9)


def _check_improvements(s, rows, logp_raw, gated, scale, tol):
    """Emulate the streaming prob > best walk and compare improvement
    positions and values with the trace rows."""
    valid = gated > -1e8    # gate sentinel is -1e9
    best = -np.inf
    improvements = []
    for k in _visit_order(s["params"], s["tidx"]):
        # the reference's bestProb starts at 0.0, so a candidate whose
        # double-precision probability underflowed to 0 can never win
        if not valid[k] or logp_raw[k] <= -708.0:
            continue
        if logp_raw[k] > best:
            best = logp_raw[k]
            improvements.append(k)
    ref = [(_cand_index(s["params"], int(trial), int(idxm), int(i)), score)
           for trial, idxm, i, score in rows]
    assert [k for k, _ in ref] == improvements, (ref, improvements)
    for k, score in ref:
        # in the PROB domain against the trace's fixed(9) print: absolute
        # half-ulp 5e-10 plus a relative term
        got = math.exp(logp_raw[k]) * scale
        assert abs(got - score) <= 5e-10 + tol * abs(score), (k, got, score)


def test_pdf_improvements_match(setup):
    s, z = setup, setup["z"]
    bm = BeamModelConfig(
        zhit=float(z["beam_zhit"]), zphi=float(z["beam_zphi"]),
        zshort=float(z["beam_zshort"]), zmax=float(z["beam_zmax"]),
        zrand=float(z["beam_zrand"]),
        percentage_points_in_c=float(z["beam_percentage_points_in_c"]),
        max_range=float(z["beam_rangemax"]),
        sig_phi=float(z["beam_sigphi"]), sig_hit=float(z["beam_sighit"]),
        lam_short=float(z["beam_lamshort"]),
        max_angle_diff_deg=float(z["beam_max_angle_diff"]))
    T, aux = match_pdf(None, *_clouds(s), s["params"], bm,
                       inject=s["inject"], return_scores=True)
    rows = load_score3d(os.path.join(RANSAC_DIR, "pdf", "score3D.dat"))
    _check_improvements(s, rows, aux["logp_raw"].numpy(),
                        aux["logp"].numpy(), scale=10e100, tol=1e-6)
    # PDF's acceptance is a pure prob max, so the lexicographic winner is
    # the reference's
    np.testing.assert_allclose(T.numpy(), s["tbest"][1], atol=1e-9)


def test_tsd_improvements_match(setup):
    s, z = setup, setup["z"]
    # the harness pushed the model scan through the reference TsdGrid;
    # push the identical scan here
    geom = SensorPolar2D(size=int(z["M"].shape[0]),
                         angular_res=float(z["resolution"]),
                         phi_min=math.radians(-135.0), max_range=9.0,
                         min_range=0.01, low_reflectivity_range=1.0)
    grid = create(GridConfig(map_size=int(z["map_size"]),
                             cellsize=float(z["cellsize"])),
                  dtype=torch.float64)
    pose_m = _t(z["pose_m"])
    grid = push(grid, geom, pose_m, _t(z["data_m"]), _t(z["mask_m"]))
    T, aux = match_tsd(None, grid, pose_m, *_clouds(s), s["params"],
                       inject=s["inject"], return_scores=True)
    rows = load_score3d(os.path.join(RANSAC_DIR, "tsd", "score3D.dat"))
    _check_improvements(s, rows, aux["logp_raw"].numpy(),
                        aux["logp"].numpy(), scale=10.0, tol=1e-5)
    np.testing.assert_allclose(T.numpy(), s["tbest"][2], atol=1e-9)
