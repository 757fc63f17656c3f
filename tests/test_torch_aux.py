"""The port's point clouds (ohm_tsd_slam_tpu_torch/core/cloud.py) and trace
recorder (ohm_tsd_slam_tpu_torch/utils/trace.py) against the JAX package's
(core/cloud.py, utils/trace.py), on the CPU.

Clouds: seeded numpy points (a few NaN, some zero normals, colours) go
through both packages' masks, sub-sampling, 4x4 transform, pinhole z-buffer,
organized-cloud rotation and ASCII codec; masks and z-buffer hits equal,
values within 1e-12 (float64; the transforms are small matmuls in both),
the ASCII files byte-equal and read back equal.  Trace: the same records
serialized by both packages give the same folder, file for file and byte
for byte; the RANSAC layout from the golden EXP case
(golden/data/ransac, tests/test_aux.py::
test_ransac_trace_layout_matches_reference) gives the reference's file
names and score rows, and the same values as the JAX package's folder
within 1e-6 (the files hold six decimals)."""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ohm_tsd_slam_tpu.core import cloud as jc
from ohm_tsd_slam_tpu.registration import ransac as jr
from ohm_tsd_slam_tpu.utils.trace import (
    Trace as JTrace,
    record_ransac_trace as j_record,
)
from ohm_tsd_slam_tpu_torch.core import cloud as tc
from ohm_tsd_slam_tpu_torch.registration import ransac as tr
from ohm_tsd_slam_tpu_torch.utils.testing import limit_cpu_threads
from ohm_tsd_slam_tpu_torch.utils.trace import (
    Trace,
    record_ransac_trace,
)

from golden_io import (
    RANSAC_DIR,
    load_score3d,
    replay_picks,
    replay_subsample,
)

limit_cpu_threads()

TOL = 1e-12


def _points(n=200, seed=0):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-2.0, 2.0, (n, 3))
    coords[:, 2] = rng.uniform(-0.5, 4.0, n)
    coords[[3, n // 4], 1] = np.nan
    normals = rng.normal(size=(n, 3))
    normals[[7, 8, 9]] = 0.0
    colors = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    return coords, normals, colors


def _clouds():
    coords, normals, colors = _points()
    return (tc.create_cloud(torch.from_numpy(coords),
                            torch.from_numpy(normals),
                            torch.from_numpy(colors), attrs={"id": 1.0}),
            jc.create_cloud(jnp.asarray(coords), jnp.asarray(normals),
                            jnp.asarray(colors), attrs={"id": 1.0}))


def _eq_cloud(got, want):
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(got.coords.numpy(), np.asarray(want.coords),
                               rtol=0, atol=TOL)
    if want.normals is None:
        assert got.normals is None
    else:
        np.testing.assert_allclose(got.normals.numpy(),
                                   np.asarray(want.normals), rtol=0,
                                   atol=TOL)
    assert got.attrs == want.attrs


def _T4(yaw, pitch, t):
    c, s = math.cos(yaw), math.sin(yaw)
    cp, sp = math.cos(pitch), math.sin(pitch)
    Rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    T = np.eye(4)
    T[:3, :3] = Rz @ Ry
    T[:3, 3] = t
    return T


def test_cloud_masks_and_subsample_match_jax():
    t, j = _clouds()
    assert t.size == j.size == 200 and t.has_normals() and t.has_colors()
    keep = np.arange(200) % 3 != 1
    _eq_cloud(tc.mask_points(t, torch.from_numpy(keep)),
              jc.mask_points(j, jnp.asarray(keep)))
    _eq_cloud(tc.mask_empty_normals(t), jc.mask_empty_normals(j))
    _eq_cloud(tc.remove_invalid_points(t), jc.remove_invalid_points(j))
    _eq_cloud(tc.subsample(t, 4), jc.subsample(j, 4))
    chained = tc.subsample(tc.remove_invalid_points(
        tc.mask_empty_normals(t)), 2)
    want = jc.subsample(jc.remove_invalid_points(jc.mask_empty_normals(j)),
                        2)
    _eq_cloud(chained, want)
    assert int(chained.valid_count()) == int(want.valid_count()) < 100


def test_cloud_transform_and_projection_match_jax():
    t, j = _clouds()
    T = _T4(0.3, -0.2, (0.5, -0.1, 1.5))
    got = tc.transform(t, torch.from_numpy(T))
    want = jc.transform(j, jnp.asarray(T))
    finite = np.isfinite(np.asarray(want.coords)).all(1)
    np.testing.assert_allclose(got.coords.numpy()[finite],
                               np.asarray(want.coords)[finite], rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(got.normals.numpy(), np.asarray(want.normals),
                               rtol=0, atol=TOL)
    P = np.array([[120.0, 0.0, 64.0, 0.0], [0.0, 120.0, 48.0, 0.0],
                  [0.0, 0.0, 1.0, 0.0]])
    clean_t = tc.remove_invalid_points(got)
    clean_j = jc.remove_invalid_points(want)
    zb, hit = tc.project_to_image(clean_t, torch.from_numpy(P), 128, 96)
    jzb, jhit = jc.project_to_image(clean_j, jnp.asarray(P), 128, 96)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    assert 20 < int(hit.sum()) < 200
    np.testing.assert_allclose(zb.numpy()[hit.numpy()],
                               np.asarray(jzb)[np.asarray(jhit)], rtol=0,
                               atol=TOL)


def test_point_cloud_rotation_matches_jax():
    coords, _, _ = _points(48, seed=1)
    coords = np.nan_to_num(coords)
    t = tc.create_point_cloud(torch.from_numpy(coords), width=8, height=6)
    j = jc.create_point_cloud(jnp.asarray(coords), width=8, height=6)
    assert t.is_organized and j.is_organized and t.size == 48
    got = tc.rotate_rpy(t, 0.1, -0.4, 1.2)
    want = jc.rotate_rpy(j, 0.1, -0.4, 1.2)
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points),
                               rtol=0, atol=TOL)
    assert not tc.create_point_cloud(torch.from_numpy(coords)).is_organized
    with pytest.raises(ValueError):
        tc.create_point_cloud(torch.from_numpy(coords), width=5, height=5)


@pytest.mark.parametrize("with_colors", [True, False],
                         ids=["colors", "no_colors"])
def test_ascii_codec_matches_jax(tmp_path, with_colors):
    coords, normals, colors = _points(60, seed=2)
    coords = np.nan_to_num(coords)
    t = tc.create_cloud(torch.from_numpy(coords),
                        colors=torch.from_numpy(colors) if with_colors
                        else None)
    j = jc.create_cloud(jnp.asarray(coords),
                        colors=jnp.asarray(colors) if with_colors else None)
    path, jpath = str(tmp_path / "t.txt"), str(tmp_path / "j.txt")
    tc.save_cloud_ascii(path, t)
    jc.save_cloud_ascii(jpath, j)
    assert open(path, "rb").read() == open(jpath, "rb").read()
    if not with_colors:
        return
    got = tc.load_cloud_ascii(path, dtype=torch.float64)
    want = jc.load_cloud_ascii(jpath, dtype=jnp.float64)
    np.testing.assert_array_equal(got.coords.numpy(), np.asarray(want.coords))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.colors.numpy(), np.asarray(want.colors))
    assert 0 < int(got.mask.sum()) < 60


def _files(folder):
    return {f: open(os.path.join(folder, f), "rb").read()
            for f in sorted(os.listdir(folder))}


def test_trace_folder_equals_jax(tmp_path):
    """tests/test_aux.py::TestTrace's records, given to both packages
    (tensors to the port, arrays to JAX): the same files, byte for
    byte."""
    rng = np.random.default_rng(3)
    model, scene = rng.random((10, 2)), rng.random((8, 2))
    pairs = np.array([[0, 1], [2, 3]])
    folders = []
    for name, trace, conv in (("port", Trace(dim=2), torch.from_numpy),
                              ("jax", JTrace(dim=2), jnp.asarray)):
        trace.set_model(conv(model))
        trace.set_scene(conv(scene), conv(np.arange(8) != 5))
        trace.add_assignment(conv(scene), pairs=conv(pairs), score=0.5)
        trace.add_assignment(conv(scene + 0.1), None, 0.25)
        folder = str(tmp_path / name)
        trace.serialize(folder)
        folders.append(_files(folder))
    assert folders[0] == folders[1]
    assert {"model.dat", "scene.dat", "scene_000.dat", "pairs_000.dat",
            "scene_001.dat", "score.dat", "trace.gpi"} <= set(folders[0])
    t = Trace()
    t.set_model(model)
    t.add_ransac_candidate(1, 2, 3, scene, model[2], scene[3], 0.5)
    t.reset()
    assert t._model is None and not t._scenes and not t._ids


def _golden_exp():
    """The golden EXP case's inputs and draws (tests/test_aux.py::
    test_ransac_trace_layout_matches_reference), for both packages."""
    z = np.load(os.path.join(RANSAC_DIR, "inputs.npz"))
    M, S = z["M"], z["S"]
    maskM, maskS = z["maskM"], z["maskS"]
    N = M.shape[0]
    kw = dict(trials=int(z["trials"]), eps_thresh=float(z["eps_thresh"]),
              size_control_set=int(z["size_control"]),
              phi_max=float(z["phi_max"]), resolution=float(z["resolution"]))
    jp, tp = jr.RansacParams(**kw), tr.RansacParams(**kw)
    r = jp.pca_search_range // 2
    _, mask_mp = jr.pca_normals(jnp.asarray(M), jnp.asarray(maskM), r)
    sub, dr = replay_subsample(int(z["seed"]), maskS)
    _, mask_sp_full = jr.pca_normals(jnp.asarray(S), jnp.asarray(maskS), r)
    mask_sp = np.asarray(mask_sp_full) & sub
    idx_s = [i for i in range(r, N - r) if mask_sp[i]]
    idx_m = [i for i in range(r, N - r) if np.asarray(mask_mp)[i]]
    ctrl, tidx = replay_picks(dr, idx_s, idx_m, jp.trials,
                              jp.size_control_set)
    C, T = jp.size_control_set, jp.trials
    draws = (sub, np.pad(ctrl, (0, C - len(ctrl))).astype(np.int32),
             np.arange(C) < len(ctrl),
             np.pad(tidx, (0, T - len(tidx))).astype(np.int32),
             np.arange(T) < len(tidx))
    return M, S, maskM, maskS, jp, tp, draws


@pytest.mark.skipif(not os.path.exists(os.path.join(RANSAC_DIR, "tbest.bin")),
                    reason="golden ransac data missing")
def test_ransac_trace_matches_reference_and_jax(tmp_path):
    M, S, maskM, maskS, jp, tp, draws = _golden_exp()
    _, aux = tr.match_normal(
        None, torch.from_numpy(M), torch.from_numpy(maskM),
        torch.from_numpy(S), torch.from_numpy(maskS), tp,
        inject=tr.RansacInject(*(torch.from_numpy(np.asarray(d))
                                 for d in draws)),
        return_scores=True)
    keep = (aux["prep"].cand_valid & (aux["cnt"] > aux["cnt_thresh"]))
    trace = Trace()
    record_ransac_trace(trace, torch.from_numpy(M), torch.from_numpy(maskM),
                        torch.from_numpy(S), torch.from_numpy(maskS), aux,
                        tp, keep, aux["err_sum"])
    out = str(tmp_path / "port")
    trace.serialize(out)

    _, jaux = jr.match_normal(
        jax.random.PRNGKey(0), jnp.asarray(M), jnp.asarray(maskM),
        jnp.asarray(S), jnp.asarray(maskS), jp,
        inject=jr.RansacInject(*(jnp.asarray(d) for d in draws)),
        return_scores=True)
    jkeep = (np.asarray(jaux["prep"].cand_valid)
             & (np.asarray(jaux["cnt"]) > int(jaux["cnt_thresh"])))
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    jtrace = JTrace()
    j_record(jtrace, jnp.asarray(M), jnp.asarray(maskM), jnp.asarray(S),
             jnp.asarray(maskS), jaux, jp, jkeep,
             np.asarray(jaux["err_sum"]))
    jout = str(tmp_path / "jax")
    jtrace.serialize(jout)

    got, want = _files(out), _files(jout)
    assert set(got) == set(want)
    for name in got:
        if name.endswith(".gpi"):
            assert got[name] == want[name], name
            continue
        a = np.loadtxt(os.path.join(out, name), ndmin=2)
        b = np.loadtxt(os.path.join(jout, name), ndmin=2)
        np.testing.assert_allclose(a, b, rtol=0, atol=1.5e-6, err_msg=name)

    ref_dir = os.path.join(RANSAC_DIR, "exp")
    prefixes = ("scene_", "pairs_", "score_")
    assert ({f for f in got if f.startswith(prefixes)}
            == {f for f in os.listdir(ref_dir) if f.startswith(prefixes)})
    ref_rows = load_score3d(os.path.join(ref_dir, "score3D.dat"))
    got_rows = load_score3d(os.path.join(out, "score3D.dat"))
    ref_sorted = ref_rows[np.lexsort(ref_rows[:, 2::-1].T)]
    got_sorted = got_rows[np.lexsort(got_rows[:, 2::-1].T)]
    np.testing.assert_array_equal(ref_sorted[:, :3], got_sorted[:, :3])
    np.testing.assert_allclose(got_sorted[:, 3], ref_sorted[:, 3],
                               rtol=1e-6, atol=1e-9)


def test_icp_history_is_recorded(tmp_path):
    """add_icp_history on the port's IcpResult: one record an iteration
    that ran (no pairs: the ICP ran without IcpParams.record_pairs)."""
    from ohm_tsd_slam_tpu_torch.registration.icp import IcpParams, icp

    rng = np.random.default_rng(0)
    model = torch.from_numpy(rng.uniform(0, 4, (120, 2)))
    scene = model + torch.tensor([0.01, -0.015], dtype=torch.float64)
    ones = torch.ones(120, dtype=torch.bool)
    res = icp(model, ones, scene, ones,
              IcpParams(iterations=8, dist_max=1.0, dist_min=0.2))
    trace = Trace()
    trace.set_model(model)
    trace.set_scene(scene)
    trace.add_icp_history(scene, res)
    ran = int(torch.isfinite(res.rms_history).sum())
    assert 0 < ran == len(trace._scenes)
    trace.serialize(str(tmp_path / "icp"))
    assert os.path.exists(str(tmp_path / "icp" / "scene_000.dat"))
    assert os.path.getsize(tmp_path / "icp" / "pairs_000.dat") == 0


def test_trace_records_pair_assignments(tmp_path):
    """tests/test_aux.py::test_trace_records_pair_assignments for the port:
    IcpParams.record_pairs gives add_icp_history the per-iteration pair
    assignments, and the folder equals the one the JAX package's Trace
    writes for its own ICP on the same inputs (float64), byte for byte."""
    import dataclasses

    from ohm_tsd_slam_tpu.registration.icp import IcpParams as JIcpParams
    from ohm_tsd_slam_tpu.registration.icp import icp as jicp
    from ohm_tsd_slam_tpu_torch.registration.icp import IcpParams, icp

    rng = np.random.RandomState(0)
    model = rng.uniform(0, 4, (120, 2))
    scene = model + np.array([0.01, -0.015])
    params = IcpParams(iterations=8, dist_max=1.0, dist_min=0.2,
                       record_pairs=True)
    ones = torch.ones(120, dtype=torch.bool)
    res = icp(torch.from_numpy(model), ones, torch.from_numpy(scene), ones,
              params)
    assert res.pair_idx_history.shape == (8, 120)
    jres = jicp(jnp.asarray(model), jnp.ones(120, bool), jnp.asarray(scene),
                jnp.ones(120, bool), JIcpParams(**dataclasses.asdict(params)))
    folders = []
    for name, trace, r in (("port", Trace(), res), ("jax", JTrace(), jres)):
        trace.set_model(model)
        trace.set_scene(scene)
        trace.add_icp_history(scene, r)
        out = str(tmp_path / name)
        trace.serialize(out)
        folders.append(_files(out))
    pair_files = sorted(f for f in folders[0] if f.startswith("pairs_"))
    assert pair_files
    first = np.loadtxt(os.path.join(tmp_path / "port", pair_files[0]),
                       ndmin=2)
    assert first.shape[1] == 2 and first.shape[0] > 50
    assert folders[0] == folders[1]
