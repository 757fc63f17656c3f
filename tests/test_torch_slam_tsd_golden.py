"""The TSD-mode golden loop (golden/data/slam_tsd.bin: the match_tsd seed,
then ICP, the reference's shipped default) replayed through the port in
float64 on the CPU with the reference's draws, held against the compiled
reference."""

import math
import os

import numpy as np
import pytest
import torch

from ohm_tsd_slam_tpu_torch import config as tcfg
from ohm_tsd_slam_tpu_torch.core import se2
from ohm_tsd_slam_tpu_torch.grid import raycast_fast as rf
from ohm_tsd_slam_tpu_torch.grid.push import push
from ohm_tsd_slam_tpu_torch.grid.state import create, free_footprint
from ohm_tsd_slam_tpu_torch.registration.icp import IcpParams
from ohm_tsd_slam_tpu_torch.registration.ransac import (
    RansacParams,
    match_tsd,
)
from ohm_tsd_slam_tpu_torch.sensor.polar2d import (
    SensorPolar2D,
    data_to_cartesian,
    standard_mask,
)
from ohm_tsd_slam_tpu_torch.slam import LocalizeParams
from ohm_tsd_slam_tpu_torch.slam import localize as tlocalize
from ohm_tsd_slam_tpu_torch.utils.testing import limit_cpu_threads

from golden_io import GOLDEN_DIR, load_golden
from test_torch_ransac_golden import replayed_inject

limit_cpu_threads()

SLAM_TSD_BIN = os.path.join(GOLDEN_DIR, "data", "slam_tsd.bin")
SLAM_TSD_NPZ = os.path.join(GOLDEN_DIR, "data", "slam_tsd_inputs.npz")


@pytest.mark.skipif(not os.path.exists(SLAM_TSD_BIN),
                    reason="golden slam_tsd data not generated")
def test_golden_replay_tsd_matches_reference():
    """The loop in the reference's shipped default mode (TSD_PDFMatching
    seed + ICP, registration_mode 3; dispatch ThreadLocalize.cpp:558-580),
    replayed as tests/test_reference_parity_slam.py replays it through
    JAX: the harness reseeds its rand stream to seed + k per scan, the
    same draws are replayed (golden_io.DetRand) and injected into the
    port's match_tsd, whose transform enters localize_step as T_prereg.
    Every error and significance gate equal, poses within that test's
    1e-4 of the compiled reference."""
    golden = load_golden(SLAM_TSD_BIN)
    inp = np.load(SLAM_TSD_NPZ)
    scans = inp["scans"]
    (cellsize, layout_grid, max_trunc, size, ang_res, phi_min, max_range,
     min_range, low_refl, icp_iters, dist_max, dist_min, trns_max,
     rot_max, trns_min, rot_min) = inp["params"]
    fp_w, fp_h = inp["footprint"]
    (r_trials, r_eps, r_ctl, r_phi_deg, r_zrand, r_seed) = inp["ransac"]
    gt = inp["gt"]
    f64 = torch.float64

    geom = SensorPolar2D(size=int(size), angular_res=float(ang_res),
                         phi_min=float(phi_min), max_range=float(max_range),
                         min_range=float(min_range),
                         low_reflectivity_range=float(low_refl))
    gcfg = tcfg.GridConfig(map_size=int(layout_grid),
                           cellsize=float(cellsize),
                           truncation_radius=float(max_trunc / cellsize))
    gw = gcfg.size_meters
    rparams = RansacParams(
        trials=int(r_trials), eps_thresh=float(r_eps),
        size_control_set=int(r_ctl), phi_max=math.radians(float(r_phi_deg)),
        resolution=float(ang_res), zrand_tsd=float(r_zrand))
    lparams = LocalizeParams(
        geom=geom,
        icp=IcpParams.from_config(
            tcfg.IcpConfig(iterations=int(icp_iters),
                           dist_filter_max=float(dist_max),
                           dist_filter_min=float(dist_min)),
            bounds=(0.0, gw, 0.0, gw)),
        trns_max=float(trns_max), rot_max=float(rot_max),
        trns_min=float(trns_min), rot_min=float(rot_min))

    grid = create(gcfg, dtype=f64, device="cpu")
    pose = se2.make(*(float(v) for v in gt[0]), dtype=f64)
    grid = free_footprint(grid, (float(gt[0][0]), float(gt[0][1])),
                          float(fp_w), float(fp_h))
    last_pose = pose

    got_poses, got_err, got_sig = [], [], []
    for k in range(len(scans)):
        ranges = np.where(scans[k] >= 1e29, np.inf, scans[k])
        data, mask = standard_mask(geom, torch.from_numpy(ranges))
        if k == 0:
            grid = push(grid, geom, pose, data, mask)
            got_poses.append(pose.numpy())
            got_err.append(0)
            got_sig.append(1)
            continue

        model = rf.raycast_fast(grid, geom, pose)
        assert int(model.n_dropped) == 0
        scene, smask = data_to_cartesian(geom, data, mask)
        inject, _ = replayed_inject(int(r_seed) + k, model.coords,
                                    model.mask, scene, smask, rparams)
        T_pre = match_tsd(None, grid, pose, model.coords, model.mask,
                          scene, smask, rparams, inject=inject)
        res = tlocalize.localize_step(grid, pose, last_pose, data, mask,
                                      lparams, T_prereg=T_pre)
        pose = res.pose
        if bool(res.significant):
            grid = push(grid, geom, pose, data, mask)
            last_pose = pose
        got_poses.append(pose.numpy())
        got_err.append(int(bool(res.reg_error)))
        got_sig.append(int(bool(res.significant)))

    ref_poses = np.asarray(golden["pose_trace"]).reshape(-1, 3, 3)
    ref_flags = np.asarray(golden["flags"])
    got_poses = np.asarray(got_poses)
    np.testing.assert_array_equal(np.asarray(got_err), ref_flags[:, 0],
                                  err_msg="registration-error gates")
    np.testing.assert_array_equal(np.asarray(got_sig), ref_flags[:, 1],
                                  err_msg="significance gates")
    dpos = np.abs(got_poses[:, :2, 2] - ref_poses[:, :2, 2]).max()
    drot = np.abs(got_poses[:, 0, 0] - ref_poses[:, 0, 0]).max()
    print(f"TSD golden loop: max |dpos| {dpos:.3e} m, max |drot| "
          f"{drot:.3e} against the compiled reference")
    assert dpos < 1e-4, dpos
    assert drot < 1e-4, drot
