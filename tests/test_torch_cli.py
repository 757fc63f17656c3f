"""The port's command line (python -m ohm_tsd_slam_tpu_torch) against the
JAX package's (python -m ohm_tsd_slam_tpu), on the CPU.

`simulate` writes the same scan log as the JAX package's, array for array.
`run --device cpu` over a short log (a loop in a 10 m room, 271 beams,
ICP mode) writes every output file, and with both nodes in float64 the
trajectory is the JAX package's within the float64 node parity tests'
1e-6 (tests/test_torch_slam.py::POSE_TOL, plus the csv's last printed
digit), the grid checkpoint within 1e-9 and NaN for NaN.  `launch multi`
runs both robots of configs/double-laser.yaml; `ros` without rclpy returns
1; without --device the node wants the card and says so where there is
none.  On the card (`cuda`): `simulate` and `run` of
configs/single-laser.yaml at 1081 beams as subprocesses, as users start
them (this case imports no JAX: the card's machine has none)."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from ohm_tsd_slam_tpu_torch.__main__ import main
from ohm_tsd_slam_tpu_torch.grid.checkpoint import load_npz, load_text
from ohm_tsd_slam_tpu_torch.utils.testing import limit_cpu_threads

limit_cpu_threads()

PROFILE = """
slam_node:
  ros__parameters:
    map_size: 8
    cellsize: 0.04
    registration_mode: 0
    icp_iterations: 20
    max_range: 8.0
    min_range: 0.01
"""
STEPS, BEAMS = 80, 271
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# 240 scans of `simulate` move the robot 8 cm and 1.5 deg a scan around a
# 3.1 m circle; 60 would move it 32 cm a scan, beyond the yaml's 0.25 m
# registration gate (both packages lose that loop)
CARD_STEPS = 240


def jmain(argv):
    """The JAX package's command line (imported here: the card's machine,
    which runs this file's `cuda` case, has no JAX)."""
    from ohm_tsd_slam_tpu.__main__ import main as jax_main

    return jax_main(argv)
OUTPUTS = ("trajectory.csv", "map.pgm", "map_color.ppm", "grid.npz",
           "grid_store.txt")


@pytest.fixture(scope="module")
def log(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    cfg = str(d / "profile.yaml")
    with open(cfg, "w") as f:
        f.write(PROFILE)
    scans, jscans = str(d / "scans.npz"), str(d / "jscans.npz")
    args = ["--steps", str(STEPS), "--beams", str(BEAMS), "--config", cfg]
    assert main(["simulate", "--out", scans, *args]) == 0
    assert jmain(["simulate", "--out", jscans, *args]) == 0
    return d, cfg, scans, jscans


def _float64_nodes(monkeypatch):
    """Both packages' SlamNode in float64 (the CLI builds it with the
    package's default, float32)."""
    import jax.numpy as jnp

    import ohm_tsd_slam_tpu.slam.node as jnode
    import ohm_tsd_slam_tpu_torch.slam.node as tnode

    class T64(tnode.SlamNode):
        def __init__(self, config, dtype=None, **kw):
            super().__init__(config, dtype=torch.float64, **kw)

    class J64(jnode.SlamNode):
        def __init__(self, config, dtype=None, **kw):
            super().__init__(config, dtype=jnp.float64, **kw)

    monkeypatch.setattr(tnode, "SlamNode", T64)
    monkeypatch.setattr(jnode, "SlamNode", J64)


def test_simulate_writes_the_jax_log(log):
    _, _, scans, jscans = log
    with np.load(scans) as a, np.load(jscans) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["ranges"].shape == (STEPS, BEAMS)


def test_run_matches_jax(log, monkeypatch, capsys):
    d, cfg, scans, _ = log
    _float64_nodes(monkeypatch)
    out, jout = str(d / "out"), str(d / "jout")
    assert main(["run", scans, "--config", cfg, "--out", out,
                 "--store-text", "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert jmain(["run", scans, "--config", cfg, "--out", jout,
                  "--store-text"]) == 0
    for name in OUTPUTS:
        assert os.path.exists(os.path.join(out, name)), name

    got = np.loadtxt(os.path.join(out, "trajectory.csv"), delimiter=",",
                     skiprows=1)
    want = np.loadtxt(os.path.join(jout, "trajectory.csv"), delimiter=",",
                      skiprows=1)
    assert got.shape == want.shape == (STEPS - 1, 4)
    assert np.isfinite(got).all()
    # POSE_TOL, and one unit of the sixth decimal the csv rounds to
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 + 1e-6)

    g = load_npz(os.path.join(out, "grid.npz"), dtype=torch.float64,
                 device="cpu")
    jg = load_npz(os.path.join(jout, "grid.npz"), dtype=torch.float64,
                  device="cpu")
    assert torch.equal(g.tsd.isnan(), jg.tsd.isnan())
    ok = ~g.tsd.isnan()
    np.testing.assert_allclose(g.tsd[ok].numpy(), jg.tsd[ok].numpy(),
                               rtol=0, atol=1e-9)
    assert torch.equal(g.tile_init, jg.tile_init)
    # the text checkpoint reads back to the grid's shape
    assert load_text(os.path.join(out, "grid_store.txt"),
                     device="cpu").tsd.shape == \
        g.tsd.shape
    for name in ("map.pgm", "map_color.ppm"):
        with open(os.path.join(out, name), "rb") as a, \
                open(os.path.join(jout, name), "rb") as b:
            assert a.read(32) == b.read(32), name   # same header
    # tracks the simulated loop (2.5 cells, tests/test_slam_e2e.py:91)
    line = [ln for ln in printed.splitlines()
            if ln.startswith("trajectory error")][0]
    assert float(line.split("max ")[1].split(" m")[0]) < 2.5 * 0.04, line
    assert "process_scan on cpu: median" in printed


def test_launch_multi_runs_both_robots(tmp_path):
    out = str(tmp_path / "launch")
    assert main(["launch", "multi", "--out", out, "--steps", "3",
                 "--beams", "181", "--device", "cpu"]) == 0
    for name in ("trajectory_r0.csv", "trajectory_r1.csv", "map.pgm",
                 "scans_r0.npz", "scans_r1.npz"):
        assert os.path.exists(os.path.join(out, name)), name


def test_ros_without_rclpy_returns_1(capsys):
    from ohm_tsd_slam_tpu_torch import ros_bridge

    if ros_bridge.HAVE_ROS:  # pragma: no cover
        pytest.skip("rclpy is installed")
    assert main(["ros"]) == 1
    assert "rclpy not available" in capsys.readouterr().out


def test_run_wants_the_card_by_default(log, tmp_path):
    _, cfg, scans, _ = log
    if torch.cuda.is_available():  # pragma: no cover
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device"):
        main(["run", scans, "--config", cfg, "--out", str(tmp_path)])


@pytest.mark.cuda
def test_simulate_and_run_on_the_card(tmp_path):
    """`simulate` then `run` on the card, each a subprocess: every output
    file, the printed trajectory error within 2.5 cells, one row a
    localized scan, and grid.npz equal to the reference-format text
    checkpoint of the same grid (--store-text), value for value."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = os.path.join(REPO, "configs", "single-laser.yaml")
    scans, out = str(tmp_path / "scans.npz"), str(tmp_path / "out")
    printed = []
    for args in (["simulate", "--config", cfg, "--beams", "1081",
                  "--steps", str(CARD_STEPS), "--out", scans],
                 ["run", scans, "--config", cfg, "--out", out,
                  "--store-text"]):
        proc = subprocess.run(
            [sys.executable, "-m", "ohm_tsd_slam_tpu_torch", *args],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, (args[0], proc.stderr[-2000:])
        printed.append(proc.stdout)
    for name in OUTPUTS:
        assert os.path.exists(os.path.join(out, name)), name
    err = re.search(r"trajectory error vs ground truth: mean (\S+) m, "
                    r"max (\S+) m", printed[1])
    assert float(err.group(2)) < 2.5 * 0.025, printed[1]
    assert re.search(r"process_scan on cuda\S*: median", printed[1])
    with open(os.path.join(out, "trajectory.csv")) as f:
        assert f.read().count("\n") - 1 == CARD_STEPS - 1
    g = load_npz(os.path.join(out, "grid.npz"), device="cpu")
    t = load_text(os.path.join(out, "grid_store.txt"), device="cpu")
    for f in ("tsd", "weight", "tile_init"):
        a, b = getattr(g, f), getattr(t, f)
        assert torch.equal(a.isnan(), b.isnan()), f
        assert torch.equal(a.nan_to_num(), b.nan_to_num()), f
    # the text stores a tile's emptiness weight only while it has no
    # cells, and its reader clamps it at the maximum weight
    # (TsdGrid.cpp:84-85)
    empty = ~g.tile_init
    assert torch.equal(g.tile_initw[empty].clamp(max=t.max_weight),
                       t.tile_initw[empty])
    assert int(g.tile_init.sum()) > 100
