"""The pieces of the single-laser-exp cell and the two metrics it adds:

  * the configuration is config/single-laser.yaml's with
    registration_mode 1 and nothing else changed, under single-laser's
    limits;
  * on the CPU, at tiny.cell's size with the draws cut as
    test_slambench_modes.py cuts them, the reference equals the node over
    a short stream of the cell's traffic;
  * metrics/ransac_ms.py reads each session scan's device busy time
    from the render's last kernel to ICP's first, and
    metrics/match_normal_roofline.py the kernel's launches against the
    `ransac_pairs` counts of the sessions' scans, each on hand-made
    records against a value computed by hand; on a program without the
    kernels or the counter each reads None."""

from __future__ import annotations

import math
from types import SimpleNamespace

import pytest

from slambench import check, harness
from slambench.tests import tiny
from slambench.tracing import Session

CELL = "single-laser-exp.replay-walk"
M = 1_000_000       # 1 ms in ns


def test_the_cell_is_single_laser_in_mode_1():
    c = harness.load_cell(CELL)
    base = harness.load_cell("single-laser.replay-walk")
    assert c.config["reduced"] == []
    assert c.params == dict(base.params, registration_mode=1)
    assert c.assumed == base.assumed
    assert c.traffic == base.traffic and c.limits == base.limits
    names = [m["name"] for m in c.per_layer]
    assert names[-2:] == ["ransac_ms", "match_normal_roofline"]
    assert "ransac_ms" not in [m["name"] for m in base.per_layer]


def test_reference_equals_the_cpu_node():
    c = tiny.cell(CELL)
    c.config = dict(c.config, trials=10, sizeControlSet=40)
    run = tiny.run(c, seed=2_800_000_017, seconds=3.0)
    ev = run.evidence
    assert len(ev.scans) == 16
    assert any(s.grid_after is not None for s in ev.scans)
    values = check.readings(ev, run.device)
    assert {k: values[k] for k in check.NAMES} == dict.fromkeys(
        check.NAMES, 0)
    assert check.verdict(values, c.limits)


def _ops(*ops):
    return [(name, int(b * M), int(e * M)) for name, b, e in ops]


ROUNDS = "void (anonymous namespace)::window_rounds_kernel(float*, int)"
ROWS = "void (anonymous namespace)::assign_rows_kernel<float>(float*)"
NEAREST = ("void (anonymous namespace)::nearest_model_kernel<float, 6>("
           "float const*)")


def _session() -> Session:
    """Three scans: A's seed from 2.0 to 2.9 ms, busy 0.5 ms of it (two
    overlapping operations among idle time), B's from 22.0 to 22.5, busy
    0.3 ms, and C with no render (nothing read)."""
    dev = _ops(("segment_min_kernel", 1.0, 1.2), (ROUNDS, 1.8, 2.0),
               (NEAREST, 2.3, 2.5), ("elementwise", 2.5, 2.8),
               ("elementwise", 2.6, 2.7),
               (ROWS, 2.9, 3.0), (ROWS, 3.1, 3.2),
               (ROUNDS, 21.5, 22.0), (NEAREST, 22.1, 22.4),
               (ROWS, 22.5, 22.6),
               (ROWS, 41.0, 41.1))
    return Session(device=dev, host=[],
                   scans=[(0, 10 * M), (20 * M, 30 * M), (40 * M, 50 * M)])


def test_ransac_ms_reads_the_seed_between_render_and_icp():
    mod = harness.reader("ransac_ms")
    run = SimpleNamespace(sessions=[_session()])
    assert mod.read(run) == pytest.approx((0.5 + 0.3) / 2, abs=1e-12)
    # a program whose replay shows neither kernel by these names
    bare = Session(device=_ops(("kernel", 1.0, 9.0)), host=[],
                   scans=[(0, 10 * M)])
    assert mod.read(SimpleNamespace(sessions=[bare])) is None


class _Recorder:
    def __init__(self, events):
        self.events = events

    def count_events(self):
        return self.events


def test_match_normal_roofline_reads_the_hand_computed_share():
    mod = harness.reader("match_normal_roofline")
    c = harness.load_cell(CELL)
    from ohm_tsd_slam_tpu_torch.config import from_flat_params

    # pairs: two counts inside the session's scans, one outside
    events = [("ransac_pairs", 5 * M, 400_000_000, (0, 0)),
              ("ransac_candidates", 5 * M, 2_500, (0, 0)),
              ("ransac_pairs", 25 * M, 500_000_000, (0, 1)),
              ("ransac_pairs", 65 * M, 900_000_000, (0, 2))]
    run = SimpleNamespace(sessions=[_session()],
                          span_recorder=_Recorder(events), cell=c,
                          config=from_flat_params(c.params))
    # 100 trials x 238 offsets x 180 control points; the median pairs
    # 450e6 x 8 operations at 67e12 a second (the 28 bytes a query at
    # 3.35e12 take less), over the median launch of 0.25 ms
    queries = 100 * 238 * 180
    assert mod.queries(run) == queries
    ops_ms = 450e6 * 8 / 67e12 * 1e3
    assert ops_ms > queries * 28 / 3.35e12 * 1e3
    want = 100.0 * ops_ms / 0.25
    assert mod.read(run) == pytest.approx(want, rel=1e-12)
    assert 0.0 < want < 50.0
    # a program without the counter, the recorder or the kernel
    run.span_recorder = _Recorder(events[1:2])
    assert mod.read(run) is None
    del run.span_recorder
    assert mod.read(run) is None
    run.span_recorder = _Recorder(events)
    run.sessions = [Session(device=_ops((ROUNDS, 1.0, 2.0)), host=[],
                            scans=[(0, 10 * M)])]
    assert mod.read(run) is None
    assert math.isclose(mod.nearest_model_ms(0, queries),
                        queries * 28 / 3.35e12 * 1e3)
