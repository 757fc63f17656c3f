"""The pieces of the double-laser-site cell and the two metrics it adds:

  * the configuration is config/double-laser.yaml's with map_size 12 and
    nothing else changed; both circuits of the hall close, stay inside
    it and keep their clearance, and both robots start on both;
  * metrics/extract_ms.py reads the `extract` interval inside
    `map_update`, and metrics/segment_sweep_roofline.py kernel C's
    launches against the `segments_swept` counts of the sessions' scans,
    each on hand-made records against a value computed by hand; on a
    program without the span or the counter each reads None."""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import pytest

from ohm_tsd_slam_tpu_torch.utils.spans import Record
from slambench import harness
from slambench.tests.test_slambench_spans import M, _records, _session
from slambench.traffic import scans

SITE = scans.load_scene("site")
LOOPS = {k: scans.make_loop(v) for k, v in SITE["loops"].items()}


def test_the_site_is_the_double_laser_deployment_at_map_size_12():
    from ohm_tsd_slam_tpu_torch.config import from_flat_params

    c = harness.load_cell("double-laser-site.site-walk")
    base = harness.load_cell("double-laser.live-walk")
    assert c.config["reduced"] == []
    assert c.params == dict(base.params, map_size=12)
    assert c.assumed["changed"]["map_size"]["published"] == 10
    assert c.assumed["scanner"] == base.assumed["scanner"]
    cfg = from_flat_params(c.params)
    assert cfg.grid.cells_per_side == 4096
    assert [r.sensor.max_range for r in cfg.robots] == [30.0, 20.0]
    assert c.traffic["arrivals"] == "open" and c.traffic["warmup_s"] <= 30
    assert c.limits == base.limits


@pytest.mark.parametrize("loop", sorted(LOOPS))
def test_circuits_stay_inside_the_hall_and_clear(loop):
    x, y, _ = LOOPS[loop].at(np.arange(0.0, LOOPS[loop].total, 0.005))
    x0, y0, x1, y1 = SITE["rects"][0]
    assert (x > x0).all() and (x < x1).all()
    assert (y > y0).all() and (y < y1).all()
    segs, circles = scans.scene_objects(SITE)
    clear = math.inf
    for ax, ay, bx, by in segs:
        dx, dy = bx - ax, by - ay
        t = np.clip(((x - ax) * dx + (y - ay) * dy) / (dx * dx + dy * dy),
                    0.0, 1.0)
        clear = min(clear, float(np.hypot(x - ax - t * dx,
                                          y - ay - t * dy).min()))
    for cx, cy, r in circles:
        clear = min(clear, float((np.hypot(x - cx, y - cy) - r).min()))
    assert clear >= SITE["clearance_m"] - 1e-9


def test_both_robots_start_on_both_circuits():
    cfg = harness.load_json(
        f"{harness.ROOT}/slambench/configs/double-laser-site.json")
    half = 2 ** cfg["map_size"] * cfg["cellsize"] / 2
    for i in range(cfg["robot_nbr"]):
        x = half + cfg[f"robot{i}/local_offset_x"]
        y = half + cfg[f"robot{i}/local_offset_y"]
        yaw = cfg[f"robot{i}/local_offset_yaw"]
        for loop in LOOPS.values():
            leg = scans.enter(loop, x, y, yaw)
            px, py, ph = leg.at(np.zeros(1))
            assert math.hypot(px[0] - x, py[0] - y) < 1e-9
            assert abs(math.remainder(ph[0] - yaw, 2 * math.pi)) < 1e-6


# ------------------------------------------------------------ the metrics

def _with_extract():
    """spans' hand-made records, with an `extract` span and its 0.3 ms
    interval under scan C's map update and a 9 ms one under scan A's (in
    the profiler session: not read)."""
    out = list(_records())

    def rec(rid, parent, trace, name, b, e, **attrs):
        out.append(Record(rid, parent, trace, name, int(b * M), int(e * M),
                          7, attrs))

    rec(90, 12, (0, 0), "extract", 9.5, 9.8)
    rec(91, 90, (0, 0), "extract", 9.5, 9.8, device_ms=9.0)
    rec(92, 52, (0, 1), "extract", 58.3, 58.8)
    rec(93, 92, (0, 1), "extract", 58.3, 58.8, device_ms=0.3)
    return out


class _Recorder:
    def __init__(self, events):
        self.events = events

    def count_events(self):
        return self.events


def test_extract_ms_reads_the_interval_inside_map_update():
    mod = harness.reader("extract_ms")
    run = SimpleNamespace(sessions=[_session(True)],
                          span_records=(_with_extract(), {}))
    assert mod.read(run) == pytest.approx(0.3, abs=1e-12)
    # a program without the span (the map update's own interval is not
    # read), and one without records
    assert mod.read(SimpleNamespace(sessions=[_session(True)],
                                    span_records=(_records(), {}))) is None
    assert mod.read(SimpleNamespace(sessions=[_session(True)],
                                    span_records=([], {}))) is None


def test_segment_sweep_roofline_reads_the_hand_computed_share():
    mod = harness.reader("segment_sweep_roofline")
    s = _session(True)
    s.device = s.device + [("void (anonymous namespace)::segment_min_kernel("
                            "float const*, int)", 3 * M, 3 * M + t)
                           for t in (200_000, 100_000, 120_000)]
    # swept counts: two in the session's scans, one outside it
    events = [("segments_swept", 5 * M, 40_000, (0, 0)),
              ("segments", 5 * M, 90_000, (0, 0)),
              ("segments_swept", 25 * M, 20_000, (1, 0)),
              ("segments_swept", 55 * M, 90_000, (0, 1))]
    run = SimpleNamespace(sessions=[s], span_recorder=_Recorder(events),
                          cell=SimpleNamespace(assumed={"scanner": {
                              "beams": 1081}}))
    # median swept 30,000: 1081 x 30,000 x 20 operations at 67e12 a
    # second (the pack's bytes bound nothing), over the median 0.12 ms
    want = 100.0 * (1081 * 30_000 * 20 / 67e12 * 1e3) / 0.12
    assert mod.read(run) == pytest.approx(want, rel=1e-12)
    assert 0.0 < want < 100.0
    # a program without the counter, or without the recorder
    run.span_recorder = _Recorder([e for e in events
                                   if e[0] != "segments_swept"])
    assert mod.read(run) is None
    del run.span_recorder
    assert mod.read(run) is None
