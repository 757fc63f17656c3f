"""RANSAC mode EXP (registration/ransac.py::match_normal) around its
nearest-model-point search: the split twin, the search kernel, the
search's work counters, and the step against the benchmark's reference.

This file imports torch, numpy and the benchmark's plain reference only:
its `cuda`-marked cases run on the card with the README's `-m cuda`
command (they skip without one).

On the CPU:
  * match_normal equals the chunked body it had before its [K, C] code
    ran over all candidates at once (kept here as `chunked_body`: every
    score computed a chunk at a time), in every bit, in float32 and
    float64: T, ratio, cnt, err_sum and max_cnt, on seeded room clouds
    with masked model points, with duplicated model points (ties), with
    a scan that leaves no valid candidate, and with K not a multiple of
    the chunk;
  * `ransac_candidates` and `ransac_pairs` (normal_work, through
    localize_step and the node's span counters) equal counts made by
    hand, once for every mode-1 scan, and the other modes count neither;
  * the port's mode-1 step through SlamNode equals the plain reference's
    step (slambench/reference/slam.py: match_normal, then ICP and the
    gates) in every bit over a short stream at a small size.
On the card, at the published widths (100 trials x 238 offsets, 180
control points, 1081 room beams), the kernel equals its twin in every bit
on every query it computes, eagerly and in a graph replay, and so does
the winning transform.
"""

import math
import os
import sys

import numpy as np
import pytest
import torch

from ohm_tsd_slam_tpu_torch.config import from_flat_params
from ohm_tsd_slam_tpu_torch.ops import nearest_model_cuda as nm
from ohm_tsd_slam_tpu_torch.registration import ransac as rs
from ohm_tsd_slam_tpu_torch.slam import localize
from ohm_tsd_slam_tpu_torch.slam.messages import LaserScan
from ohm_tsd_slam_tpu_torch.slam.node import SlamNode
from ohm_tsd_slam_tpu_torch.utils import spans
from ohm_tsd_slam_tpu_torch.utils.testing import (
    BEAMS,
    PHI_MIN,
    RES,
    SINGLE_LASER,
    limit_cpu_threads,
    simulate_scan,
    trajectory,
    world,
)

# the card's run passes --noconftest: the helpers' file by its folder
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_card import bits_equal  # noqa: E402

limit_cpu_threads()

SMALL_BEAMS, SMALL_RES = 271, math.radians(1.0)
# 30 trials x 58 offsets (floor(30 deg / 1 deg) rounds to 29 a side) =
# 1740 candidates: not a multiple of the chunk
SMALL = rs.RansacParams(trials=30, size_control_set=40,
                        resolution=SMALL_RES, chunk=64)
MODEL_POSE, SCENE_POSE = (12.8, 12.8, 0.3), (12.84, 12.77, 0.34)
# the node at tiny.cell's size (slambench/tests/tiny.py), mode EXP with
# the draws cut as slambench/tests/test_slambench_modes.py cuts them
FLAT = {**SINGLE_LASER, "map_size": 8, "cellsize": 0.1,
        "registration_mode": 1, "trials": 10, "sizeControlSet": 40}
SEED = 3_000_000_019
STREAM = 8
PUBLISHED = rs.RansacParams.from_config(
    from_flat_params(SINGLE_LASER).robots[0].registration.ransac, RES)


def room_cloud(xyt, beams, res, dtype, device="cpu"):
    """The room's scan from `xyt` as scene-frame points and their mask."""
    x, y, th = xyt
    pose = np.array([[math.cos(th), -math.sin(th), x],
                     [math.sin(th), math.cos(th), y], [0.0, 0.0, 1.0]])
    segs, circles = world()
    r = torch.as_tensor(simulate_scan(pose, beams, res, PHI_MIN, 30.0,
                                      segments=segs, circles=circles),
                        dtype=dtype)
    ang = PHI_MIN + res * torch.arange(beams, dtype=dtype)
    mask = torch.isfinite(r) & (r > 0.01) & (r < 30.0)
    pts = torch.where(mask[:, None],
                      torch.stack([torch.cos(ang) * r, torch.sin(ang) * r],
                                  -1), 0.0)
    return pts.to(device), mask.to(device)


def chunked_body(generator, model, mask_model, scene, mask_scene, params):
    """match_normal as it was before its [K, C] code ran over all
    candidates at once: every score of `params.chunk` candidates at a
    time, the search a dense [chunk, C, M] tensor and its min."""
    prep = rs._prepare(generator, model, mask_model, scene, mask_scene,
                       params)
    dtype = scene.dtype
    model_masked_sq = ((model * model).sum(1)
                       + (~prep.mask_m).to(dtype) * rs._BIG)
    cnt_thresh = prep.ctrl_mask.sum() // 3
    cosm = torch.cos(prep.phi_m)
    sinm = torch.sin(prep.phi_m)
    mx = model[:, 0][None, None, :]
    my = model[:, 1][None, None, :]

    def score_chunk(phi, t, valid):
        st = rs._transform_ctrl(prep, phi, t)
        theta = torch.atan2(st[..., 1], st[..., 0])
        in_fov = ((theta >= prep.theta_min) & (theta <= prep.theta_max)
                  & prep.ctrl_mask[None, :])
        max_cnt = in_fov.sum(1)
        q2 = (st * st).sum(-1)
        d2 = (q2[..., None] + model_masked_sq[None, None, :]
              - 2.0 * (st[..., 0:1] * mx + st[..., 1:2] * my))
        d2min, (cos_nn, sin_nn) = rs._reduce_min_payload(d2, (cosm, sinm))
        d2min = d2min.clamp(min=0.0)
        beta = prep.ctrl_phi[None, :] + phi[:, None]
        ncons = (1.0 - (cos_nn * torch.cos(beta)
                        + sin_nn * torch.sin(beta))) / 2.0
        err = (d2min * params.scale_distance
               + ncons * params.scale_orientation)
        err_sum = torch.where(in_fov, err, 0.0).sum(1)
        cnt = (in_fov & (err < 1.0)).sum(1)
        ratio = cnt.to(dtype) / max_cnt.clamp(min=1).to(dtype)
        good = valid & (cnt > cnt_thresh) & (max_cnt > 0)
        ratio = torch.where(good, ratio, -rs._BIG)
        return ratio, cnt, err_sum, max_cnt

    ratio, cnt, err_sum, max_cnt = rs._chunked_scores(
        (prep.phi_cand, prep.t_cand, prep.cand_valid), params.chunk,
        score_chunk)
    T = rs._lex_best((torch.round(ratio * 1e5), cnt.to(ratio.dtype),
                      -err_sum), prep.phi_cand, prep.t_cand, prep.ok)
    return T, dict(ratio=ratio, cnt=cnt, err_sum=err_sum, max_cnt=max_cnt)


def small_case(case: str, dtype):
    """(model, model mask, scene, scene mask) of the room at 271 beams."""
    model, mm = room_cloud(MODEL_POSE, SMALL_BEAMS, SMALL_RES, dtype)
    scene, ms = room_cloud(SCENE_POSE, SMALL_BEAMS, SMALL_RES, dtype)
    if case == "masked":
        drop = torch.rand(SMALL_BEAMS, generator=torch.Generator()
                          .manual_seed(4)) < 0.2
        mm = mm & ~drop
    elif case == "ties":
        # runs of equal model points, all valid: equal distances
        for j in range(20, SMALL_BEAMS - 20, 7):
            model[j + 1] = model[j]
            model[j + 2] = model[j]
    elif case == "no_candidate":
        ms = torch.zeros_like(ms)
    return model, mm, scene, ms


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["masked", "ties", "no_candidate"])
def test_split_twin_equals_the_chunked_body(case, dtype):
    clouds = small_case(case, dtype)

    def gen():
        return torch.Generator().manual_seed(11)

    launches = nm.nearest_model.launches
    T, got = rs.match_normal(gen(), *clouds, SMALL, return_scores=True)
    T_ref, want = chunked_body(gen(), *clouds, SMALL)
    assert nm.nearest_model.launches == launches     # no kernel on the CPU
    K = got["prep"].cand_valid.numel()
    assert K == 1740 and K % SMALL.chunk
    assert bits_equal(T, T_ref)
    for k in want:
        assert bits_equal(got[k], want[k]), k
    valid = got["prep"].cand_valid
    if case == "no_candidate":
        assert not bool(valid.any()) and torch.equal(T, torch.eye(
            3, dtype=dtype))
    else:
        assert int(valid.sum()) > 100
        assert not torch.equal(T, torch.eye(3, dtype=dtype))


def test_nearest_model_plain_takes_the_first_of_ties():
    model, mm, scene, ms = small_case("ties", torch.float64)
    st = scene[None, :40] + 0.01
    q2 = (st * st).sum(-1)
    msq = (model * model).sum(1) + (~mm).to(model.dtype) * rs._BIG
    phi = torch.linspace(-3.0, 3.0, SMALL_BEAMS, dtype=torch.float64)
    d2min, idx, c, s = rs.nearest_model_plain(
        st, q2, model, msq, torch.cos(phi), torch.sin(phi), 7)
    d2 = q2[..., None] + msq - 2.0 * (st[..., 0:1] * model[:, 0]
                                      + st[..., 1:2] * model[:, 1])
    first = (d2 == d2.amin(-1, keepdim=True)).to(torch.uint8).argmax(-1)
    assert torch.equal(idx.long(), first) and idx.dtype == torch.int32
    assert torch.equal(d2min, d2.amin(-1).clamp(min=0.0))
    assert torch.equal(c, torch.cos(phi)[first])
    assert torch.equal(s, torch.sin(phi)[first])
    # a band of three equal points (at 20, 27, ...): the first, never the
    # second or the third
    band = (idx.long() >= 20) & (idx.long() < SMALL_BEAMS - 20)
    at = (idx.long() - 20) % 7
    assert bool((band & (at == 0)).any())
    assert not bool((band & ((at == 1) | (at == 2))).any())


def hand_work(scores) -> tuple:
    """The valid candidates and Σ over them of the control points in the
    model's frustum × the valid model points, counted one candidate and
    one control point at a time."""
    prep = scores["prep"]
    lo, hi = float(prep.theta_min), float(prep.theta_max)
    n_model = sum(bool(v) for v in prep.mask_m)
    cands = pairs = 0
    for k in range(prep.cand_valid.numel()):
        if not bool(prep.cand_valid[k]):
            continue
        cands += 1
        st = rs._transform_ctrl(prep, prep.phi_cand[k:k + 1],
                                prep.t_cand[k:k + 1])[0]
        theta = torch.atan2(st[:, 1], st[:, 0]).tolist()
        pairs += n_model * sum(
            1 for c, th in enumerate(theta)
            if bool(prep.ctrl_mask[c]) and lo <= th <= hi)
    return cands, pairs


def small_scans(n: int):
    """n scans of 271 beams along the room's trajectory from the start."""
    cfg = from_flat_params(FLAT)
    half = cfg.grid.size_meters * 0.5
    segs, circles = world()
    out = []
    for k, (x, y, th) in enumerate(trajectory((half, half, 0.0), n)):
        pose = np.array([[math.cos(th), -math.sin(th), x],
                         [math.sin(th), math.cos(th), y], [0.0, 0.0, 1.0]])
        out.append(LaserScan(
            ranges=simulate_scan(pose, SMALL_BEAMS, SMALL_RES, PHI_MIN, 30.0,
                                 segments=segs, circles=circles),
            angle_min=PHI_MIN, angle_increment=SMALL_RES, range_max=30.0,
            stamp=float(k)))
    return cfg, out


def test_search_counters_equal_counts_by_hand(monkeypatch):
    cfg, scans = small_scans(STREAM)
    kept = []

    def keep(*args, **kwargs):
        T, scores = rs.match_normal(*args, **kwargs)
        kept.append(scores)
        return T, scores

    monkeypatch.setattr(localize, "match_normal", keep)
    results = []
    orig = localize.localize_step

    def step(*args, **kwargs):
        results.append(orig(*args, **kwargs))
        return results[-1]

    monkeypatch.setattr("ohm_tsd_slam_tpu_torch.slam.node.localize_step_jit",
                        step)
    node = SlamNode(cfg, dtype=torch.float32, device="cpu", seed=SEED)
    spans.enable()
    spans.reset()
    try:
        for msg in scans:
            node.process_scan(0, msg)
        events = [(name, n) for name, _, n, _ in spans.count_events()
                  if name.startswith("ransac_")]
    finally:
        spans.disable()
        spans.reset()
    steps = STREAM - 1                  # the first scan starts the robot
    assert len(kept) == len(results) == steps
    hand = [hand_work(s) for s in kept]
    assert [n for name, n in events if name == "ransac_candidates"] == [
        c for c, _ in hand]
    assert [n for name, n in events if name == "ransac_pairs"] == [
        p for _, p in hand]
    for r, (c, p) in zip(results, hand):
        assert (int(r.ransac_candidates), int(r.ransac_pairs)) == (c, p)
        assert r.ransac_pairs.dtype == torch.int64
    assert all(c > 0 and p > 0 for c, p in hand)


@pytest.mark.parametrize("mode", [0, 3])
def test_other_modes_count_no_search_work(mode):
    cfg, scans = small_scans(3)
    cfg = from_flat_params({**FLAT, "registration_mode": mode})
    node = SlamNode(cfg, dtype=torch.float32, device="cpu", seed=SEED)
    node.process_scan(0, scans[0])
    loc = node.localizers[0]
    data, mask = node._preprocess(loc, np.asarray(scans[1].ranges))
    res = localize.localize_step(node.grid, loc.pose, loc.last_pose, data,
                                 mask, loc.params,
                                 generator=node._draws(0, 0))
    assert int(res.ransac_candidates) == int(res.ransac_pairs) == 0
    spans.enable()
    spans.reset()
    try:
        node.process_scan(0, scans[1])
        assert not any(k.startswith("ransac_") for k in spans.counters())
    finally:
        spans.disable()
        spans.reset()


def test_mode_1_step_equals_the_reference(monkeypatch):
    """Each scan of a short stream through the CPU node in mode 1 against
    the benchmark's plain reference from the node's own state before it:
    the same pose, error gate and mapping decision, in every bit."""
    from slambench import check
    from slambench.reference import slam as R

    cfg, scans = small_scans(STREAM)
    seeds = []

    def spy(*args, **kwargs):
        T, scores = rs.match_normal(*args, **kwargs)
        seeds.append(T)
        return T, scores

    monkeypatch.setattr(localize, "match_normal", spy)
    dep = R.deployment(FLAT)
    robot = dep.robots[0]
    sen = R.sensor(robot, SMALL_BEAMS, PHI_MIN, SMALL_RES)
    node = SlamNode(cfg, dtype=torch.float32, device="cpu", seed=SEED)
    node.process_scan(0, scans[0])
    mapped = 0
    for msg in scans[1:]:
        loc = node.localizers[0]
        before, pose, last, count = (node.grid, loc.pose, loc.last_pose,
                                     loc.scan_count)
        data, mask = R.preprocess(sen, robot, msg.ranges, torch.float32,
                                  "cpu")
        gen = torch.Generator().manual_seed(R.draw_seed(SEED, 0, count))
        ref = R.step(dep, robot, sen, check._grid(dep, before, "cpu"), pose,
                     last, data, mask, gen)
        out = node.process_scan(0, msg)
        assert out.is_nan == bool(ref.reg_error), count
        assert (node.grid is not before) == bool(ref.significant), count
        mapped += node.grid is not before
        if not out.is_nan:
            assert bits_equal(node.localizers[0].pose, ref.pose), count
    assert mapped > 0 and len(seeds) == STREAM - 1
    assert any(not torch.equal(T, torch.eye(3)) for T in seeds)


# ---------------------------------------------------------------- the card

def published_case(dtype, device):
    """Room clouds at the published widths and match_normal's draws for
    them, injected (no generator: the call can be captured)."""
    model, mm = room_cloud(MODEL_POSE, BEAMS, RES, dtype, device)
    scene, ms = room_cloud(SCENE_POSE, BEAMS, RES, dtype, device)
    gen = torch.Generator(device=device).manual_seed(2_800_000_001)
    r = PUBLISHED.pca_search_range // 2
    sub = rs.subsample_mask(gen, ms)
    mask_sp = rs.pca_normals(scene, ms, r)[1] & sub
    c_idx, c_valid = rs.random_valid_subset(gen, mask_sp,
                                            PUBLISHED.size_control_set)
    mask_mp = rs.pca_normals(model, mm, r)[1]
    t_idx, t_valid = rs.random_valid_subset(gen, mask_mp, PUBLISHED.trials)
    inject = rs.RansacInject(sub, c_idx, c_valid, t_idx, t_valid)
    return (model, mm, scene, ms), inject


def plain_search(st, q2, model, msq, cosm, sinm, valid, chunk):
    return rs.nearest_model_plain(st, q2, model, msq, cosm, sinm, chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_equals_the_twin_at_published_widths(monkeypatch, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    clouds, inject = published_case(dtype, dev)
    calls = []
    check = nm.check_inputs

    def spy(*args):
        calls.append(args)
        return check(*args)

    kernel = nm.nearest_model
    monkeypatch.setattr(nm, "check_inputs", spy)
    launches = kernel.launches
    T, got = rs.match_normal(None, *clouds, PUBLISHED, inject=inject,
                             return_scores=True)
    assert kernel.launches == launches + 1 and len(calls) == 1
    args = (*calls[0], PUBLISHED.chunk)
    st, valid = args[0], args[6]
    K, C, _ = st.shape
    assert (K, C) == (23800, 180) and int(valid.sum()) > 1000
    out = kernel(*args)
    want = plain_search(*args)
    for name, a, b in zip(("d2min", "idx", "cos_nn", "sin_nn"), out, want):
        assert bits_equal(a[valid], b[valid]), name
    skipped = ~valid
    assert bool((out[0][skipped] == math.inf).all())
    assert bool((out[1][skipped] == -1).all())
    assert not bool(out[2][skipped].any() | out[3][skipped].any())

    monkeypatch.setattr(nm, "nearest_model", plain_search)
    T_twin, twin = rs.match_normal(None, *clouds, PUBLISHED, inject=inject,
                                   return_scores=True)
    assert bits_equal(T, T_twin) and not torch.equal(
        T, torch.eye(3, dtype=dtype, device=dev))
    assert bits_equal(got["ratio"], twin["ratio"])
    for k in ("cnt", "err_sum", "max_cnt"):
        assert bits_equal(got[k][valid], twin[k][valid]), k

    # the kernel alone and the whole matcher replayed from a graph
    monkeypatch.setattr(nm, "nearest_model", kernel)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernel(*args)
        rs.match_normal(None, *clouds, PUBLISHED, inject=inject)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = kernel(*args)
        T_graph = rs.match_normal(None, *clouds, PUBLISHED, inject=inject)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(replayed, out):
            assert bits_equal(a, b)
        assert bits_equal(T_graph, T)


@pytest.mark.cuda
def test_kernel_rows_past_one_pass_and_no_valid_model_point():
    """Control sets past 256 points (two passes of a warp) and of one to
    31, and a model with no valid point (every distance masked), against
    the twin on the valid candidates."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    model, mm = room_cloud(MODEL_POSE, BEAMS, RES, torch.float32, dev)
    for K, C, none_valid in ((37, 300, False), (9, 7, False),
                             (50, 180, True)):
        st = torch.randn((K, C, 2), generator=g, device=dev) * 4.0 + 12.8
        q2 = (st * st).sum(-1)
        mask = torch.zeros_like(mm) if none_valid else mm
        msq = (model * model).sum(1) + (~mask).to(model.dtype) * rs._BIG
        phi = torch.rand(BEAMS, generator=g, device=dev) * 6.0 - 3.0
        cosm, sinm = torch.cos(phi), torch.sin(phi)
        valid = torch.rand(K, generator=g, device=dev) < 0.5
        args = (st, q2, model, msq, cosm, sinm, valid, 16)
        out = nm.nearest_model(*args)
        want = plain_search(*args)
        for name, a, b in zip(("d2min", "idx", "cos_nn", "sin_nn"), out,
                              want):
            assert bits_equal(a[valid], b[valid]), (K, C, name)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    st = torch.zeros((4, 3, 2))
    q2 = torch.zeros((4, 3))
    model = torch.zeros((5, 2))
    m1 = torch.zeros(5)
    valid = torch.ones(4, dtype=torch.bool)
    nm.check_inputs(st, q2, model, m1, m1, m1, valid)
    with pytest.raises(TypeError, match="q2"):
        nm.check_inputs(st, q2[:, :2], model, m1, m1, m1, valid)
    with pytest.raises(TypeError, match="float32 or float64"):
        nm.check_inputs(st.half(), q2, model, m1, m1, m1, valid)
    with pytest.raises(TypeError, match="valid"):
        nm.check_inputs(st, q2, model, m1, m1, m1, valid.float())
    with pytest.raises(TypeError, match="sinm"):
        nm.check_inputs(st, q2, model, m1, m1, m1[:4], valid)
    with pytest.raises(ValueError, match="K=0"):
        nm.check_inputs(st[:0], q2[:0], model, m1, m1, m1, valid[:0])
