#!/usr/bin/env python3
"""The port's kernel table (PERF.md §6, rows 1-9) on one CUDA card.

    python3 tools/torch_kernel_times.py

Run it from the root of a checkout.  Inputs, as the port's `cuda` tests
drive them (utils/testing.py's room at the upstream configs' size): the
ICP path (configs/double-laser.yaml, two robots, 30 scans a robot)
through SlamNode, then robot 0's last pose and a scan from it; the
general-extraction path (map_size 6, 15 scans) for kernel E at its path's
shape; the pose batch (P = 128) on the ICP path's grid for C, D and the
rounds; EXP's nearest model point as match_normal hands it over in
configs/single-laser.yaml's settings, on robot 0's render and scan.

For each kernel: its wrapper (`ms`), the launch alone on held buffers
(A, D, the rounds and the assignment hold nothing but their results:
their wrapper), the device time (the launch replayed from a CUDA graph of
GRAPH_REPS calls, so that the host's work is left out), its bound, its
plain twin and, where one PyTorch call computes the same function, that
call.  Times are medians of slambench/probes.py::median_ms.  A bound is
the larger of the bytes the work must move over the HBM rate and its
operations over the float32 rate: slambench/rooflines.py's for the push
and A, counted here from this run's inputs for the others.  Then the
rounds in one block against the cooperative launch at 1 to 8 poses'
beams (ops/window_replay_cuda.py::ONE_BLOCK_BEAMS).  Every line ends with
the card's name and power limit; the last line is the table as JSON.
Imports nothing of JAX.
"""

from __future__ import annotations

import importlib
import json
import math
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from ohm_tsd_slam_tpu_torch.config import from_flat_params  # noqa: E402
from ohm_tsd_slam_tpu_torch.core import se2  # noqa: E402
from ohm_tsd_slam_tpu_torch.grid import raycast_fast as rf  # noqa: E402
from ohm_tsd_slam_tpu_torch.grid.compact import (  # noqa: E402
    pack_channels_rows,
)
from ohm_tsd_slam_tpu_torch.grid.push import push  # noqa: E402
from ohm_tsd_slam_tpu_torch.grid.raycast import (  # noqa: E402
    beam_geometry_batch,
)
from ohm_tsd_slam_tpu_torch.ops import (  # noqa: E402
    compact_channels_cuda,
    nearest_model_cuda,
    pack_rows_cuda,
    push_cuda,
    segment_min_cuda,
)
from ohm_tsd_slam_tpu_torch.ops.assign_pairs_cuda import (  # noqa: E402
    assign_pairs,
)
from ohm_tsd_slam_tpu_torch.ops.window_replay_cuda import (  # noqa: E402
    ROUNDS_THREADS,
)
from ohm_tsd_slam_tpu_torch.registration import nn, ransac  # noqa: E402
from ohm_tsd_slam_tpu_torch.registration.ransac import (  # noqa: E402
    RansacParams,
)
from ohm_tsd_slam_tpu_torch.sensor.polar2d import (  # noqa: E402
    data_to_cartesian,
)
from ohm_tsd_slam_tpu_torch.slam import LaserScan, SlamNode  # noqa: E402
from ohm_tsd_slam_tpu_torch.slam import localize  # noqa: E402
from ohm_tsd_slam_tpu_torch.utils.testing import (  # noqa: E402
    BEAMS,
    DOUBLE_LASER,
    NARROW,
    PHI_MIN,
    RES,
    SINGLE_LASER,
    narrow_world,
    scan_ranges,
    trajectory,
    world,
)
from slambench import probes, rooflines  # noqa: E402
from slambench.run import card_label  # noqa: E402

CELLS = 1024
GRAPH_REPS = 20              # calls captured into one graph by device_ms
N_POSES = 128                # the pose batch: bench.py's spread
CROSSOVER_POSES = (1, 2, 3, 4, 8)    # 1081 to 8648 beams
CAP = 32768 + 128            # the pack's columns, its slack included
ms = probes.median_ms


def device_ms(fn, reps=GRAPH_REPS) -> float:
    """fn()'s device work alone: `reps` calls captured into one CUDA
    graph, the replay's median time over `reps`."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return ms(graph.replay) / reps


def bound(n_bytes: float, n_ops: float, prefix: str = "") -> dict:
    """The least time for the work (bound_ms) and what bounds it."""
    by_bytes = n_bytes / rooflines.HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / rooflines.F32_FLOP_PER_S * 1e3
    return {f"{prefix}bound_ms": max(by_bytes, by_ops),
            f"{prefix}bound_by": ("bytes" if by_bytes >= by_ops
                                  else "operations")}


def taps(n_replays: int) -> int:
    """A replay's 8 samples and 4 normal taps of 4 cells, but the field
    once at most: replays of nearby poses read the same cells."""
    return min(n_replays * 12 * 16, CELLS * CELLS * 4)


def drive(flat, n, scene=world):
    """A SlamNode of settings `flat` through n scans a robot of the room
    (the cuda tests' paths); returns the node."""
    cfg = from_flat_params(flat)
    node = SlamNode(cfg, dtype=torch.float32, device="cuda")
    half = cfg.grid.size_meters * 0.5
    gts = [trajectory((half + rc.local_offset_x, half + rc.local_offset_y,
                       rc.local_offset_yaw), n) for rc in cfg.robots]
    for k in range(n):
        for r, rc in enumerate(cfg.robots):
            node.process_scan(r, LaserScan(
                ranges=scan_ranges(gts[r][k], rc.sensor.max_range, scene),
                angle_min=PHI_MIN, angle_increment=RES,
                range_max=rc.sensor.max_range, stamp=float(k)))
    torch.cuda.synchronize()
    return node


def rounds_crossover(rounds, args: list, beams_per_pose: int) -> dict:
    """The rounds kernel on the first P poses' beams of the batch's state
    in one block and in a cooperative launch of a block for each
    ROUNDS_THREADS beams, each after a copy of the state (which both
    pay): the same rows and drops, and each one's device time."""
    g, S0, lev, ray, idx_min, idx_max, tr, _ = args
    out = {}
    for p in CROSSOVER_POSES:
        n = p * beams_per_pose
        a = (lev[:n], ray[:n], idx_min[:n], idx_max[:n], tr[:p],
             rf.unresolved_cap(n))
        S_n = S0[:n].clone()
        S_work = S_n.clone()
        got = []
        for blocks in (1, -(-n // ROUNDS_THREADS)):
            rows, dropped = rounds(g, S_n.clone(), *a, blocks=blocks)
            got.append((rows.view(torch.int32), int(dropped)))
            out[f"{n} beams, {blocks} block(s)"] = device_ms(
                lambda: (S_work.copy_(S_n), rounds(g, S_work, *a,
                                                   blocks=blocks)), reps=4)
        assert torch.equal(got[0][0], got[1][0]) and got[0][1] == got[1][1]
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_times: no CUDA device", file=sys.stderr)
        return 2
    label = card_label()
    ks = rf.cuda_kernels()
    S = rf.MAX_SEGMENTS
    node = drive(DOUBLE_LASER, 30)
    narrow = drive(NARROW, 15, narrow_world)
    loc = node.localizers[0]
    grid, geom, pose = node.grid, loc.geom, loc.pose.contiguous()
    p = pose.cpu()
    data, mask = node._preprocess(loc, scan_ranges(
        (float(p[0, 2]), float(p[1, 2]), math.atan2(float(p[1, 0]),
                                                    float(p[0, 0]))),
        geom.max_range))
    seg = node._segments_for(grid)
    segs = int(seg.count)
    rows = {}

    # 1. the push, out of place into a held grid
    held = push_cuda.empty_like(grid)

    def push_launch():
        push_cuda.launch(grid, geom, pose, data, mask, held)

    rows["push"] = dict(
        ms=ms(lambda: push_cuda.push_cuda(grid, geom, pose, data, mask)),
        kernel_ms=ms(push_launch), device_ms=device_ms(push_launch),
        bound_ms=rooflines.push_ms(CELLS, BEAMS), bound_by="rooflines.py",
        plain_ms=ms(lambda: push(grid, geom, pose, data, mask)))

    # 2. A: its wrapper holds nothing but its two results
    lmask, row_cnt = ks.segment_layers(grid)
    a_ms = ms(lambda: ks.segment_layers(grid))
    rows["segment_layers"] = dict(
        ms=a_ms, kernel_ms=a_ms,
        device_ms=device_ms(lambda: ks.segment_layers(grid)),
        bound_ms=rooflines.segment_layers_ms(CELLS), bound_by="rooflines.py",
        plain_ms=ms(lambda: rf.segment_layers_plain(grid)))

    # 3. B, and the one PyTorch call that computes B's and E's function:
    # boolean selection of each dense channel (it reads the count back)
    buf = pack_rows_cuda.empty_pack(grid.tsd.device, row_cnt.numel(), S)
    total = row_cnt.new_empty(1)

    def b_launch():
        pack_rows_cuda.launch(grid, lmask, row_cnt, buf, total)

    dmask, dchans = rf._segment_layers(grid)
    library = ms(lambda: [torch.masked_select(c, dmask) for c in dchans])
    nonzero = int((row_cnt > 0).sum())
    rows["pack_rows"] = dict(
        ms=ms(lambda: ks.pack_rows(grid, lmask, row_cnt, S)),
        kernel_ms=ms(b_launch), device_ms=device_ms(b_launch),
        plain_ms=ms(lambda: rf.pack_rows_plain(grid, lmask, S)),
        library_ms=library,
        # row counts read, the mask rows that hold a segment, 4 field taps
        # a segment, the pack written (zeros included)
        **bound(4 * CELLS * CELLS // 128 * 4 + nonzero * 512 + segs * 16
                + 5 * CAP * 4, segs * 40))

    # 4. C: the one sweep a scan, K = ROUNDS levels
    ray, tr, idx_min, idx_max, feasible = rf.beam_geometry(grid, geom, pose)
    lo = (torch.floor(idx_min) - 1.0).clamp(min=0.0)
    hi = torch.ceil(idx_max) + 1.0
    tr_pack = (tr - seg.origin).contiguous()
    cargs = (seg.pack, seg.count, ray, lo, hi, lo, tr_pack)
    c_out = torch.empty((BEAMS, rf.ROUNDS), dtype=torch.float32,
                        device=ray.device)

    def c_launch(args=cargs):
        segment_min_cuda.launch(*args, c_out, rf.COVER)

    # the noise field's pack, full to the capacity
    from ohm_tsd_slam_tpu_torch.grid.state import from_arrays
    from ohm_tsd_slam_tpu_torch.utils.testing import field_arrays, noise_field

    full = rf.extract_segments(from_arrays(field_arrays(
        noise_field(CELLS, seed=3).astype(np.float32), 0.025),
        device=grid.tsd.device))
    rows["segment_min"] = dict(
        ms=ms(lambda: ks.segment_min(*cargs, rf.ROUNDS, rf.COVER)),
        kernel_ms=ms(c_launch), device_ms=device_ms(c_launch),
        plain_ms=ms(lambda: rf.segment_min_plain(*cargs, rf.ROUNDS,
                                                 rf.COVER)),
        device_ms_full_pack=device_ms(lambda: c_launch(
            (full.pack, full.count) + cargs[2:])),
        full_pack_segments=int(full.count),
        # the kept segments' 8 pack rows, 7 values a beam, K values out;
        # ~20 operations a beam-segment pair once, a compare a beam a
        # later level
        **bound(segs * 32 + BEAMS * 28 + BEAMS * 4 * rf.ROUNDS,
                BEAMS * segs * 20 + BEAMS * (rf.ROUNDS - 1)))

    # 5. D, round 1: its wrapper holds nothing but its result
    t_1 = ks.segment_min(*cargs)[:, 0]
    has = torch.isfinite(t_1) & feasible
    k_1 = torch.where(has, t_1, 0.0)
    dargs = (grid, k_1, ray, idx_min, idx_max, has, tr.contiguous())
    d_ms = ms(lambda: ks.window_replay(*dargs))
    rows["window_replay"] = dict(
        ms=d_ms, kernel_ms=d_ms,
        device_ms=device_ms(lambda: ks.window_replay(*dargs)),
        plain_ms=ms(lambda: rf.window_replay_plain(*dargs)),
        **bound(taps(BEAMS) + BEAMS * (28 + 32), BEAMS * 12 * 25))

    # 6. the rounds on the candidates of the beams round 1 left
    # unresolved; the kernel resolves its state in place, so each timed
    # call takes a fresh copy of round 1's state, made before the clock
    S0 = ks.window_replay(*dargs)
    resolved = (S0[:, 1] > 0.0) | ~has
    S0[:, 1] = resolved.to(S0.dtype)
    t_after = torch.where(resolved, math.inf,
                          torch.maximum(lo, k_1 + rf.COVER))
    lev = ks.segment_min(seg.pack, seg.count, ray, lo, hi, t_after, tr_pack,
                         rf.ROUNDS - 1, rf.COVER)
    rargs = (lev, ray, idx_min, idx_max, tr.contiguous(),
             rf.unresolved_cap(BEAMS))
    fresh = iter([S0.clone() for _ in range(probes.CALLS + probes.WARMUP)])
    rounds_ms = ms(lambda: ks.window_rounds(grid, next(fresh), *rargs))
    S_work = S0.clone()
    needing = int(torch.isfinite(lev).sum())
    rows["window_rounds"] = dict(
        ms=rounds_ms, kernel_ms=rounds_ms,
        device_ms=device_ms(lambda: (S_work.copy_(S0), ks.window_rounds(
            grid, S_work, *rargs))),
        state_copy_device_ms=device_ms(lambda: S_work.copy_(S0)),
        plain_ms=ms(lambda: rf.window_rounds_plain(grid, S0, *rargs)),
        rounds_needing=needing,
        **bound(BEAMS * ((rf.ROUNDS - 1) * 4 + 8) + taps(needing)
                + needing * (20 + 32),
                BEAMS * (rf.ROUNDS - 1) * 6 + needing * 12 * 25))

    # 4-6 at the pose batch's shape (P = 128 folded into the beams)
    poses = torch.stack([pose @ se2.make(d, -d, 2.0 * d, device=pose.device)
                         for d in np.linspace(-0.05, 0.05, N_POSES).tolist()])
    grabbed = []

    def grab(g, S_, *rest):
        grabbed[:] = [g, S_.clone(), *rest]
        return ks.window_rounds(g, S_, *rest)

    rf.raycast_fast_batch(grid, geom, poses, segments=seg,
                          kernels=ks._replace(window_rounds=grab))
    ray_b, tr_b, imin_b, imax_b, feas_b = beam_geometry_batch(grid, geom,
                                                              poses)
    nb = ray_b.shape[0] * ray_b.shape[1]
    ray_b, imin_b, imax_b, feas_b = (ray_b.reshape(nb, 2), imin_b.reshape(nb),
                                     imax_b.reshape(nb), feas_b.reshape(nb))
    lo_b = (torch.floor(imin_b) - 1.0).clamp(min=0.0)
    cb = (seg.pack, seg.count, ray_b, lo_b, torch.ceil(imax_b) + 1.0, lo_b,
          (tr_b - seg.origin).contiguous(), rf.ROUNDS, rf.COVER)
    lev_b = ks.segment_min(*cb)
    has_b = torch.isfinite(lev_b[:, 0]) & feas_b
    db = (grid, torch.where(has_b, lev_b[:, 0], 0.0), ray_b, imin_b, imax_b,
          has_b, tr_b.contiguous())
    g_, Sb, lev_r, *beams, cap_b = grabbed
    fresh = iter([Sb.clone() for _ in range(probes.CALLS + probes.WARMUP)])
    Sb_work = Sb.clone()
    needing_b = int((torch.isfinite(lev_r) & (Sb[:, 1] == 0)[:, None]).sum())
    rows["segment_min"].update(
        batch_ms=ms(lambda: ks.segment_min(*cb)),
        batch_device_ms=device_ms(lambda: ks.segment_min(*cb), reps=4),
        batch_plain_ms=ms(lambda: rf.segment_min_plain(*cb)),
        **bound(segs * 32 + nb * 20 + nb * 16 + N_POSES * 8,
                nb * segs * 20 + nb * 3, "batch_"))
    rows["window_replay"].update(
        batch_ms=ms(lambda: ks.window_replay(*db)),
        batch_device_ms=device_ms(lambda: ks.window_replay(*db), reps=4),
        batch_plain_ms=ms(lambda: rf.window_replay_plain(*db)),
        **bound(taps(nb) + nb * (20 + 32), nb * 12 * 25, "batch_"))
    rows["window_rounds"].update(
        batch_ms=ms(lambda: ks.window_rounds(g_, next(fresh), lev_r, *beams,
                                             cap_b)),
        batch_device_ms=device_ms(lambda: (Sb_work.copy_(Sb), ks.window_rounds(
            g_, Sb_work, lev_r, *beams, cap_b)), reps=4),
        batch_plain_ms=ms(lambda: rf.window_rounds_plain(g_, Sb, lev_r,
                                                         *beams, cap_b)),
        **bound(nb * ((rf.ROUNDS - 1) * 4 + 8) + taps(needing_b)
                + needing_b * (20 + 32),
                nb * (rf.ROUNDS - 1) * 6 + needing_b * 12 * 25, "batch_"))
    rows["window_rounds"]["crossover_device_ms"] = rounds_crossover(
        ks.window_rounds, grabbed, BEAMS)

    # 7. E at its path's shape (the map_size 6 grid's layer stack) and at
    # the 1024^2 grid's (4 Mi lanes)
    def e_row(m, chans):
        out = compact_channels_cuda.empty_pack(m.device, m.numel()
                                               // compact_channels_cuda.ROW,
                                               S, len(chans) + 1)
        n = torch.empty(1, dtype=torch.int32, device=m.device)

        def e_launch():
            compact_channels_cuda.launch(m, chans, out, n)

        set_lanes = int(m.sum())
        return dict(
            ms=ms(lambda: compact_channels_cuda.compact_channels(m, chans,
                                                                 S)),
            kernel_ms=ms(e_launch), device_ms=device_ms(e_launch),
            plain_ms=ms(lambda: pack_channels_rows(m, chans, S)),
            library_ms=ms(lambda: [torch.masked_select(c, m)
                                   for c in chans]),
            lanes=m.numel(),
            # the bool mask read, 4 values a set lane, the pack written
            **bound(m.numel() + set_lanes * 16 + 5 * CAP * 4, m.numel()))

    rows["compact_channels"] = dict(
        e_row(*rf._segment_layers(narrow.grid)),
        **{f"{k}_4mi_lanes": v for k, v in e_row(dmask, dchans).items()})

    # 8. ICP's assignment on the last iteration of an eager step from
    # robot 0's last pose (S = M = 1081, K = 2, gate and reciprocal rule
    # on): its wrapper holds nothing but its results
    icp_mod = importlib.import_module(
        "ohm_tsd_slam_tpu_torch.registration.icp")
    last = []

    def kept(*args, **kwargs):
        last[:] = [args, kwargs]
        return nn.assign_pairs_fused(*args, **kwargs)

    icp_mod.assign_pairs_fused = kept
    try:
        localize.localize_step(grid, pose, loc.last_pose, data, mask,
                               loc.params, segments=seg)
    finally:
        icp_mod.assign_pairs_fused = nn.assign_pairs_fused
    args, kwargs = last
    S_, M_, K_ = args[2].shape[0], args[0].shape[0], args[4].shape[1]
    w_ms = ms(lambda: assign_pairs(*args, **kwargs))
    rows["assign_pairs"] = dict(
        ms=w_ms, kernel_ms=w_ms,
        device_ms=device_ms(lambda: assign_pairs(*args, **kwargs)),
        plain_ms=ms(lambda: nn.assign_pairs_plain(*args, **kwargs)),
        plain_device_ms=device_ms(lambda: nn.assign_pairs_plain(
            *args, **kwargs)), shape=[S_, M_, K_],
        # the clouds, masks and payload read once, idx, dist2, the mask
        # and the paired rows written; ~10 operations a scene-model pair
        **bound(M_ * (8 + 1 + 4 * K_) + S_ * (18 + 4 * K_), S_ * M_ * 10))

    # 9. EXP's nearest model point: match_normal in single-laser's
    # settings (100 trials, 180 control points) on robot 0's render and
    # scan; the kernel's inputs as the matcher hands them over, and the
    # pairs its search has to test (ransac.normal_work)
    calls, check = [], nearest_model_cuda.check_inputs

    def spy(*args):
        calls.append(args)
        return check(*args)

    model = rf.raycast_checked(grid, geom, pose, segments=seg)
    scene, scene_mask = data_to_cartesian(geom, data, mask)
    exp = RansacParams.from_config(from_flat_params(
        SINGLE_LASER).robots[0].registration.ransac, geom.angular_res)
    kernel = nearest_model_cuda.nearest_model
    nearest_model_cuda.check_inputs = spy
    try:
        _, scores = ransac.match_normal(
            torch.Generator(device="cuda").manual_seed(0), model.coords,
            model.mask, scene, scene_mask, exp, return_scores=True)
    finally:
        nearest_model_cuda.check_inputs = check
    nargs = (*calls[0], exp.chunk)
    cands, pairs = (int(x) for x in ransac.normal_work(scores))
    K_, C_ = nargs[0].shape[:2]
    n_ms = ms(lambda: kernel(*nargs))
    rows["nearest_model"] = dict(
        ms=n_ms, kernel_ms=n_ms, device_ms=device_ms(lambda: kernel(*nargs)),
        plain_ms=ms(lambda: ransac.nearest_model_plain(
            *nargs[:6], nargs[7])),
        plain_device_ms=device_ms(lambda: ransac.nearest_model_plain(
            *nargs[:6], nargs[7]), reps=2),
        shape=[K_, C_, nargs[2].shape[0]], valid_candidates=cands,
        pairs=pairs,
        # st and q2 read, four [K, C] outputs written; 8 operations a
        # (control point in view, valid model point) pair of a valid
        # candidate (slambench/metrics/match_normal_roofline.py)
        **bound(K_ * C_ * 28, pairs * 8))

    for i, (name, r) in enumerate(rows.items(), 1):
        lib = r.get("library_ms")
        print(f"row {i} {name}: wrapper {r['ms']:.4f} ms, launch alone "
              f"{r['kernel_ms']:.4f} ms, device {r['device_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.6f} ms by {r['bound_by']} "
              f"({r['bound_ms'] / r['device_ms']:.2%} of the device time), "
              f"plain {r['plain_ms']:.4f} ms, library "
              f"{'none' if lib is None else f'{lib:.4f} ms'}; "
              + ", ".join(f"{k} {v}" for k, v in r.items() if k not in (
                  "ms", "kernel_ms", "device_ms", "bound_ms", "bound_by",
                  "plain_ms", "library_ms")) + f" [{label}]")
    print(json.dumps({"card": label, "segments": segs, "kernels": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
