"""The readers of the program's spans and counters (slambench/spans.py and
metrics/{scan_host_ms, replay_host_ms, localize_replay_ms,
scan_idle_host_ms, map_update_ms, icp_useful_pct}.py), each on a
hand-made profiler session and record list against a value computed by
hand; the profiler's own host work inside a span is taken out; with no
records, or a program without the recorder, every reader gives None."""

from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest

from ohm_tsd_slam_tpu_torch.utils import spans as program_spans
from ohm_tsd_slam_tpu_torch.utils.spans import Record
from slambench import harness
from slambench import spans
from slambench.tracing import Session

READERS = ("scan_host_ms", "replay_host_ms", "localize_replay_ms",
           "scan_idle_host_ms", "map_update_ms", "icp_useful_pct")
M = 1_000_000       # 1 ms in ns


def _records():
    """Scans A (robot 0, maps) and B (robot 1) inside the profiler
    session; C (maps) and D recorded with no profiler.  Times in ms."""
    out = []

    def rec(rid, parent, trace, name, b, e, **attrs):
        out.append(Record(rid, parent, trace, name, int(b * M), int(e * M),
                          7, attrs))

    def step(rid, root, trace, b, e, replay, device_ms, key=0.05):
        rec(rid, root, trace, "localize_step_jit", b, e)
        rec(rid + 1, rid, trace, "key", b, b + key)
        rec(rid + 2, rid, trace, "copy_in", b + key, replay[0])
        rec(rid + 3, rid, trace, "replay", *replay)
        rec(rid + 4, rid + 3, trace, "replay", *replay, device_ms=device_ms)
        rec(rid + 5, rid, trace, "clone_out", replay[1], e)

    a = (0, 0)
    rec(1, None, a, "process_scan", 0, 10, robot=0, scan=0)
    rec(2, 1, a, "preprocess", 0, 1)
    rec(3, 1, a, "segments", 1, 1.5)
    step(4, 1, a, 1.5, 4, (2, 2.5), 100.0, key=0.2)
    rec(10, 1, a, "read_gates", 4, 9)
    rec(11, 1, a, "read_pose", 9, 9.2)
    rec(12, 1, a, "map_update", 9.2, 9.8)
    rec(13, 12, a, "map_update", 9.2, 9.8, device_ms=100.0)
    rec(14, 12, a, "push", 9.2, 9.5)
    rec(15, 1, a, "callbacks", 9.8, 10)
    b = (1, 0)
    rec(21, None, b, "process_scan", 20, 30, robot=1, scan=0)
    rec(22, 21, b, "preprocess", 20, 21)
    rec(23, 21, b, "segments", 21, 21.2)
    step(24, 21, b, 21.2, 23, (21.5, 22), 100.0, key=0.1)
    rec(30, 21, b, "read_gates", 23, 29)
    rec(31, 21, b, "read_pose", 29, 29.5)
    rec(32, 21, b, "callbacks", 29.5, 30)
    c = (0, 1)
    rec(41, None, c, "process_scan", 50, 59, robot=0, scan=1)
    rec(42, 41, c, "preprocess", 50, 50.2)
    rec(43, 41, c, "segments", 50.2, 50.3)
    step(44, 41, c, 50.3, 50.8, (50.45, 50.55), 7.5)
    rec(50, 41, c, "read_gates", 50.8, 58)
    rec(51, 41, c, "read_pose", 58, 58.1)
    rec(52, 41, c, "map_update", 58.1, 58.8)
    rec(53, 52, c, "map_update", 58.1, 58.8, device_ms=0.4)
    rec(54, 52, c, "push", 58.1, 58.3)
    rec(55, 41, c, "callbacks", 58.8, 59)
    d = (1, 1)
    rec(61, None, d, "process_scan", 70, 78, robot=1, scan=1)
    rec(62, 61, d, "preprocess", 70, 70.3)
    rec(63, 61, d, "segments", 70.3, 70.4)
    step(64, 61, d, 70.4, 71, (70.5, 70.6), 7.7)
    rec(70, 61, d, "read_gates", 71, 77.5)
    rec(71, 61, d, "read_pose", 77.5, 77.6)
    rec(72, 61, d, "callbacks", 77.6, 78)
    return out


def _session(host: bool) -> Session:
    """The session of scans A and B; with or without its host records
    (the runtime's calls and the profiler's own buffer work)."""
    ms = lambda name, b, e: (name, int(b * M), int(e * M))  # noqa: E731
    records = [ms("cudaMemcpyAsync", 0.2, 0.6),
               ms("cudaGraphLaunch", 2.0, 2.4), ms("Buffer Flush", 3, 3.5),
               ms("Activity Buffer Request", 20.5, 21),
               ms("cudaGraphLaunch", 21.5, 21.9)]
    return Session(device=[ms("kernel", 2.2, 9.5), ms("kernel", 22, 29.2)],
                   host=records if host else [],
                   scans=[(int(-0.1 * M), int(10.1 * M)),
                          (int(19.9 * M), int(30.1 * M))])


def _run(host: bool = True, records=None, counters=None):
    return SimpleNamespace(
        sessions=[_session(host)],
        span_records=(_records() if records is None else records,
                      {"icp_iterations_run": 50,
                       "icp_iterations_useful": 20}
                      if counters is None else counters))


# by hand (ms), from scans C and D (no profiler): 9 - (7.2 + 0.1) and
# 8 - (6.5 + 0.1) of host time; steps of 0.5 and 0.6; replay intervals
# 7.5 and 7.7; C's map update 0.4.  From the session's A and B: idle
# under a leaf, A [0, 2.2] and [9.8, 10], B [20, 22] and [29.5, 30],
# less the host records in them, A [0.2, 0.6] and [2.0, 2.2], B [20.5,
# 21] and [21.5, 21.9].  20 of 50 iterations.
WANT = {"scan_host_ms": (1.7 + 1.4) / 2, "replay_host_ms": (0.5 + 0.6) / 2,
        "localize_replay_ms": 7.6, "scan_idle_host_ms": (1.8 + 1.6) / 2,
        "map_update_ms": 0.4, "icp_useful_pct": 40.0}


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_the_hand_computed_value(name):
    got = harness.reader(name).read(_run())
    assert got == pytest.approx(WANT[name], abs=1e-9)


def test_the_sessions_host_records_are_taken_out():
    """Idle time under the runtime's calls (a graph launch, a copy) and
    the profiler's buffer flush or request is not the program's: taken
    out, A and B read 2.4 and 2.5 without them."""
    mod = harness.reader("scan_idle_host_ms")
    assert mod.read(_run(host=False)) == pytest.approx((2.4 + 2.5) / 2,
                                                       abs=1e-9)
    assert mod.read(_run()) == pytest.approx(WANT["scan_idle_host_ms"],
                                             abs=1e-9)


def test_profiled_scans_are_kept_apart():
    """The host and device readers take the scans recorded with no
    profiler only (the session's read 100 ms replays), the idle reader
    the session's only."""
    run = _run()
    assert [sc.root.trace for sc in spans.scans(run, profiled=True)] == [
        (0, 0), (1, 0)]
    assert [sc.root.trace for sc in spans.scans(run, profiled=False)] == [
        (0, 1), (1, 1)]


@pytest.mark.parametrize("name", READERS)
def test_no_records_read_none(name):
    mod = harness.reader(name)
    assert mod.read(_run(records=[], counters={})) is None
    assert mod.read(SimpleNamespace(sessions=[_session(True)])) is None


@pytest.mark.parametrize("name", ["double-laser.replay-walk",
                                  "single-laser.live-walk"])
def test_start_records_the_window_start_again(name, monkeypatch):
    """On the CPU at the tiny size: the probe drives a second node to the
    window's start and records the window's first scans on it, which
    return the window's poses in every bit; the first node is left as it
    was, and a second probe neither drives nor resets."""
    import torch

    from ohm_tsd_slam_tpu_torch.slam.node import SlamNode
    from slambench.tests import tiny

    monkeypatch.setattr(spans, "RECORDED_SCANS", 4)
    run = tiny.run(tiny.cell(name), seed=3000000019, seconds=0.25)
    run.sessions = []
    main, counts = run.node, [loc.scan_count for loc in run.node.localizers]
    drive, outs = run._scan, []

    def scan(r, k, sample=True):
        outs.append((r, k, drive(r, k, sample)))
        return outs[-1][2]

    run._scan = scan
    try:
        harness.reader("scan_host_ms").probe(run)
        assert program_spans.enabled()
        harness.reader("icp_useful_pct").probe(run)
        assert len(outs) == 4
        recs, counters = spans.taken(run)
    finally:
        program_spans.disable()
        program_spans.reset()
    assert run.node is main
    assert [loc.scan_count for loc in main.localizers] == counts
    # the same scans on a fresh node, and those of them the window ran
    # (a closed-loop window on a busy CPU may run fewer than four)
    ref = SlamNode(run.config, dtype=torch.float32, device="cpu",
                   seed=run.seed)
    first = len(run.config.robots) * (1 + run.warmup)
    for r, k in run.order[:first]:
        ref.process_scan(r, run.msgs[r][k])
    window = {(r, k): out for r, k, out in run.window.poses}
    assert (outs[0][0], outs[0][1]) in window
    for r, k, out in outs:
        want = [ref.process_scan(r, run.msgs[r][k])]
        want += [window[r, k]] if (r, k) in window else []
        for w in want:
            assert (out.x, out.y, out.theta) == (w.x, w.y, w.theta)
    roots = [x for x in recs if x.name == "process_scan"]
    assert [x.trace[0] for x in roots] == [r for r, _, _ in outs]
    assert counters["icp_iterations_run"] > 0
    assert len(spans.scans(run, profiled=False)) == 4


def test_a_program_without_the_recorder_reads_none(monkeypatch):
    """The parent program has no utils/spans.py: the probes pass and every
    reader gives None."""
    monkeypatch.setitem(sys.modules, "ohm_tsd_slam_tpu_torch.utils.spans",
                        None)
    monkeypatch.delattr(sys.modules["ohm_tsd_slam_tpu_torch.utils"],
                        "spans")
    run = SimpleNamespace(sessions=[_session(True)])
    for name in READERS:
        mod = harness.reader(name)
        assert mod.probe(run) is None
        assert mod.read(run) is None
    assert not program_spans.enabled()
