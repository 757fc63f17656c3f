"""The scan generator: its ranges are utils/testing.py::simulate_scan's,
every circuit stays inside the room, and every robot of both deployments
starts on every circuit."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from ohm_tsd_slam_tpu_torch.utils.testing import simulate_scan
from slambench import harness
from slambench.traffic import scans

SCENE = scans.load_scene("room")
LOOPS = {k: scans.make_loop(v) for k, v in SCENE["loops"].items()}


def _starts(config: str):
    cfg = harness.load_json(f"{harness.ROOT}/slambench/configs/{config}.json")
    n = int(cfg.get("robot_nbr", 1))
    out = []
    for i in range(n):
        ns = f"robot{i}/" if n > 1 else ""
        out.append((12.8 + cfg.get(ns + "local_offset_x", 0.0),
                    12.8 + cfg.get(ns + "local_offset_y", 0.0),
                    cfg.get(ns + "local_offset_yaw", 0.0),
                    cfg.get(ns + "max_range", 30.0)))
    return out


@pytest.mark.parametrize("config", ["double-laser", "single-laser"])
def test_noise_free_ranges_equal_simulate_scan(config):
    segs, circles = scans.scene_objects(SCENE)
    seg_list = [((a, b), (c, d)) for a, b, c, d in segs]
    circ_list = [((a, b), r) for a, b, r in circles]
    res, phi_min = math.radians(0.25), math.radians(-135.0)
    for x, y, yaw, max_range in _starts(config):
        legs = [scans.enter(LOOPS[c], x, y, yaw) for c in ("south", "north")]
        poses = scans.route(legs, 4000, 0.02)[::797]
        got = scans.simulate(torch.as_tensor(poses), 1081, res, phi_min,
                             max_range, segs, circles).numpy()
        for p, g in zip(poses, got):
            pose = np.array([[math.cos(p[2]), -math.sin(p[2]), p[0]],
                             [math.sin(p[2]), math.cos(p[2]), p[1]],
                             [0.0, 0.0, 1.0]])
            want = simulate_scan(pose, 1081, res, phi_min, max_range,
                                 seg_list, circ_list)
            np.testing.assert_array_equal(np.isinf(g), np.isinf(want))
            fin = np.isfinite(want)
            np.testing.assert_allclose(g[fin], want[fin], rtol=1e-12)


def _seg_dist(px, py, x0, y0, x1, y1):
    dx, dy = x1 - x0, y1 - y0
    t = np.clip(((px - x0) * dx + (py - y0) * dy) / (dx * dx + dy * dy),
                0.0, 1.0)
    return np.hypot(px - (x0 + t * dx), py - (y0 + t * dy))


@pytest.mark.parametrize("loop", sorted(LOOPS))
def test_circuits_stay_inside_the_room(loop):
    x, y, _ = LOOPS[loop].at(np.arange(0.0, LOOPS[loop].total, 0.005))
    x0, y0, x1, y1 = SCENE["rects"][0]
    assert (x > x0).all() and (x < x1).all()
    assert (y > y0).all() and (y < y1).all()
    segs, circles = scans.scene_objects(SCENE)
    clear = min(min(_seg_dist(x, y, *s).min() for s in segs),
                min((np.hypot(x - cx, y - cy) - r).min()
                    for cx, cy, r in circles))
    assert clear >= SCENE["clearance_m"] - 1e-9


@pytest.mark.parametrize("config", ["double-laser", "single-laser"])
def test_every_robot_starts_on_every_circuit(config):
    for x, y, yaw, _ in _starts(config):
        for loop in LOOPS.values():
            leg = scans.enter(loop, x, y, yaw)
            px, py, ph = leg.at(np.zeros(1))
            assert math.hypot(px[0] - x, py[0] - y) < 1e-9
            assert abs(math.remainder(ph[0] - yaw, 2 * math.pi)) < 1e-6


def test_a_robot_moves_its_step_a_scan_and_the_seed_only_reorders():
    starts = [(12.8, 12.8, 0.0)]
    sc = {"beams": 91, "angle_min_deg": -135.0, "increment_deg": 3.0,
          "noise_sigma_m": 0.01, "noise_clip_m": 0.03}
    mix = {"step_m": 0.02}
    a = scans.make_stream(starts, [30.0], sc, "room", ["south", "north"],
                          mix, 200, 1, "cpu")
    b = scans.make_stream(starts, [30.0], sc, "room", ["south", "north"],
                          mix, 200, 1, "cpu")
    np.testing.assert_array_equal(a.ranges[0], b.ranges[0])
    steps = np.hypot(*np.diff(a.truth[0][:, :2], axis=0).T)
    np.testing.assert_allclose(steps, 0.02, atol=1e-9)
    noise = a.ranges[0] - scans.simulate(
        torch.as_tensor(a.truth[0]), 91, math.radians(3.0),
        math.radians(-135.0), 30.0, *scans.scene_objects(SCENE)).numpy()
    assert np.abs(noise).max() <= 0.03 + 1e-12 and noise.std() > 0.005
    orders = {tuple(scans.make_stream(starts, [30.0], sc, "room",
                                      ["south", "north"], mix, 2, s,
                                      "cpu").circuits[0])
              for s in range(12)}
    assert orders == {("south", "north"), ("north", "south")}
