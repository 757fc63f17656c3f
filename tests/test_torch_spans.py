"""The span recorder (utils/spans.py) and the spans and counters of the
node and the compiled entry points.

This file imports torch and numpy only: the `cuda`-marked cases run on
the card with `python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_spans.py` (they skip without one).  Asserted on the CPU,
on a small float32 room (map_size 8, 0.04 m cells, 361 beams, ICP):
  * off, 10 scans record nothing, and `span()` gives one shared null
    object;
  * on, each scan is one `process_scan` root of trace (robot, scan
    counter) whose children come in order, each inside its parent;
    `map_update` (with a `push`) appears on exactly the scans that
    mapped, and `pushes` counts them; a compiled entry point is one
    eager span on the CPU; `icp_iterations_useful` is the sum of the
    steps' `icp_iterations`, `icp_iterations_run` 30 a scan (1 useful a
    scan where an RMS exit stops ICP at once), and each grid version's
    segments count once;
  * the poses and the grid of 20 scans equal, in every bit, those of the
    same 20 scans with the recorder off;
  * a span brackets the `record_function` event of a profiler session
    around it (the shared clock), spans of two threads keep their own
    parents and traces, and the Chrome trace has one complete event a
    span.
On the card: each `replay` span brackets its `cudaGraphLaunch` in a
profiler session and its device interval resolves, and the recorder
adds no host read to `process_scan`.
"""

import contextlib
import dataclasses
import json
import math
import threading

import pytest
import torch

from ohm_tsd_slam_tpu_torch import config as tcfg
from ohm_tsd_slam_tpu_torch.core import se2
from ohm_tsd_slam_tpu_torch.slam import node as tnode
from ohm_tsd_slam_tpu_torch.slam.messages import LaserScan
from ohm_tsd_slam_tpu_torch.utils import spans
from ohm_tsd_slam_tpu_torch.utils.testing import (
    limit_cpu_threads,
    rect_walls,
    simulate_scan,
)

limit_cpu_threads()

BEAMS, RES, PHI0, RMAX = 361, math.radians(0.75), math.radians(-135), 9.0
CFG = tcfg.SlamConfig(
    grid=tcfg.GridConfig(map_size=8, cellsize=0.04),
    robots=[tcfg.RobotConfig(
        local_offset_yaw=0.2,
        sensor=tcfg.SensorConfig(max_range=RMAX, min_range=0.01,
                                 low_reflectivity_range=1.0),
        registration=tcfg.RegistrationConfig(
            icp=tcfg.IcpConfig(iterations=30, dist_filter_max=0.5,
                               dist_filter_min=0.05)))])
SCANS = 20
# the children of a process_scan span, in the order they run
ORDER = ("preprocess", "segments", "localize_step_jit", "read_gates",
         "read_pose", "map_update", "callbacks")


def _scan(k: int) -> LaserScan:
    pose = se2.make(5.12 + 0.03 * k, 5.12, 0.2, dtype=torch.float64)
    r = simulate_scan(pose.numpy(), BEAMS, RES, PHI0, RMAX,
                      segments=rect_walls(1.5, 1.5, 8.5, 8.5),
                      circles=[((7.0, 7.2), 0.5)])
    return LaserScan(ranges=r, angle_min=PHI0, angle_increment=RES,
                     range_max=RMAX, stamp=float(k))


@contextlib.contextmanager
def _recording():
    """The recorder on and empty inside; off and empty after."""
    spans.enable()
    spans.reset()
    try:
        yield
    finally:
        spans.disable()
        spans.reset()


class _Steps:
    """Stands in for the node's localize_step_jit: calls it and keeps
    each result and the segment cache it was given."""

    def __init__(self):
        self.step = tnode.localize_step_jit
        self.results, self.caches = [], []

    def __call__(self, *args, **kwargs):
        res = self.step(*args, **kwargs)
        self.results.append(res)
        self.caches.append(kwargs.get("segments"))
        return res


def _drive(device, on: bool, n: int = SCANS):
    """n scans after the robot's start, the recorder on or off during
    them: (poses, grid, mapped flags, the steps' results and caches,
    records, counters)."""
    node = tnode.SlamNode(CFG, dtype=torch.float32, device=device, seed=3)
    node.process_scan(0, _scan(0))
    steps = _Steps()
    poses, mapped = [], []
    with (_recording() if on else contextlib.nullcontext()), \
            pytest.MonkeyPatch.context() as m:
        m.setattr(tnode, "localize_step_jit", steps)
        for k in range(1, n + 1):
            before = node.grid
            node.process_scan(0, _scan(k))
            mapped.append(node.grid is not before)
            poses.append(node.localizers[0].pose.clone())
        recs, counts = spans.records(), spans.counters()
    return dict(poses=torch.stack(poses), grid=node.grid, mapped=mapped,
                steps=steps, records=recs, counters=counts)


@pytest.fixture(scope="module")
def runs():
    return _drive("cpu", False), _drive("cpu", True)


def _bits(t) -> bytes:
    return t.detach().contiguous().cpu().numpy().tobytes()


def _children(recs, parent_id):
    return [r for r in recs if r.parent == parent_id]


def test_off_records_nothing():
    assert not spans.enabled()
    node = tnode.SlamNode(CFG, dtype=torch.float32, device="cpu", seed=3)
    for k in range(10):
        node.process_scan(0, _scan(k))
    assert spans.records() == [] and spans.counters() == {}
    null = spans.span("process_scan")
    assert spans.span("replay", trace=(0, 1), robot=0) is null
    assert spans.device_interval("replay", torch.device("cuda")) is null
    with null as s:
        assert s is None


def test_each_scan_is_one_root_with_its_children_in_order(runs):
    _, on = runs
    recs = on["records"]
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["process_scan"] * SCANS
    assert [r.trace for r in roots] == [(0, k) for k in range(SCANS)]
    assert [r.attrs for r in roots] == [{"robot": 0, "scan": k}
                                        for k in range(SCANS)]
    by_id = {r.id: r for r in recs}
    for r in recs:
        if r.parent is not None:
            p = by_id[r.parent]
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
            assert r.trace == p.trace
    for root, mapped in zip(roots, on["mapped"]):
        names = [c.name for c in _children(recs, root.id)]
        want = [n for n in ORDER if mapped or n != "map_update"]
        assert names == want
        kids = _children(recs, root.id)
        assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))
        step = kids[ORDER.index("localize_step_jit")]
        assert step.attrs == {"eager": True}
        assert _children(recs, step.id) == []
        if mapped:
            update = kids[ORDER.index("map_update")]
            assert [c.name for c in _children(recs, update.id)] == [
                "push", "extract_segments_jit"]
    assert sum(on["mapped"]) > 2
    assert on["counters"]["pushes"] == sum(on["mapped"])
    assert on["counters"].get("scans_overflowed", 0) == 0
    assert "device_intervals_dropped" not in on["counters"]


def test_icp_and_segment_counters(runs):
    _, on = runs
    c, steps = on["counters"], on["steps"]
    assert c["icp_iterations_useful"] == sum(
        int(r.icp_iterations) for r in steps.results)
    assert c["icp_iterations_run"] == 30 * SCANS
    caches = list({id(s): s for s in steps.caches}.values())
    assert c["grid_versions"] == len(caches) == sum(on["mapped"][:-1]) + 1
    assert c["segments"] == sum(int(s.count) for s in caches)
    assert c["segments_dropped"] == sum(int(s.n_dropped) for s in caches)


def test_icp_useful_counts_an_early_exit():
    """With an RMS exit every step meets (max_rms above any scan's RMS),
    ICP is done after its first iteration: 1 useful of 30 run a scan.
    (The configs' max_rms 0 and convergence counter of `iterations`
    make an earlier exit impossible, so there the two counters agree.)"""
    rc = CFG.robots[0]
    icp = dataclasses.replace(rc.registration.icp, max_rms=100.0)
    cfg = dataclasses.replace(CFG, robots=[dataclasses.replace(
        rc, registration=dataclasses.replace(rc.registration, icp=icp))])
    node = tnode.SlamNode(cfg, dtype=torch.float32, device="cpu", seed=3)
    node.process_scan(0, _scan(0))
    with _recording():
        for k in range(1, 6):
            node.process_scan(0, _scan(k))
        counts = spans.counters()
    assert counts["icp_iterations_run"] == 30 * 5
    assert counts["icp_iterations_useful"] == 5


def test_recording_leaves_poses_and_grid_bit_equal(runs):
    off, on = runs
    assert off["mapped"] == on["mapped"]
    assert _bits(off["poses"]) == _bits(on["poses"])
    for f in ("tsd", "weight", "tile_init", "tile_initw"):
        assert _bits(getattr(off["grid"], f)) == _bits(getattr(on["grid"],
                                                               f)), f
    assert off["records"] == [] and off["counters"] == {}


def test_spans_share_the_profilers_clock():
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with _recording():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with spans.span("outer"):
                with record_function("inner"):
                    torch.ones(64).sum()
        rec, = spans.records()
    inner = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "inner" and e.device_type() == DeviceType.CPU]
    assert len(inner) == 1
    assert rec.start_ns <= inner[0].start_ns() <= inner[0].end_ns() \
        <= rec.end_ns


def test_threads_keep_their_own_parents_and_traces():
    go = threading.Barrier(2)

    def work(robot):
        with spans.span("process_scan", trace=(robot, 0)):
            go.wait(timeout=10)
            with spans.span("preprocess"):
                spans.count("pushes")
            go.wait(timeout=10)

    with _recording():
        threads = [threading.Thread(target=work, args=(r,))
                   for r in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
        recs, events = spans.records(), spans.count_events()
    by_id = {r.id: r for r in recs}
    kids = [r for r in recs if r.name == "preprocess"]
    assert len(kids) == 2
    for k in kids:
        p = by_id[k.parent]
        assert p.name == "process_scan" and p.thread == k.thread
        assert k.trace == p.trace
    assert {k.trace for k in kids} == {(0, 0), (1, 0)}
    assert sorted(e[3] for e in events) == [(0, 0), (1, 0)]


def test_chrome_trace_has_a_complete_event_a_span(tmp_path):
    with _recording():
        node = tnode.SlamNode(CFG, dtype=torch.float32, device="cpu",
                              seed=3)
        for k in range(3):
            node.process_scan(0, _scan(k))
        spans.count("pushes", 2)
        path = tmp_path / "spans.json"
        spans.write_chrome_trace(str(path))
        recs, counts = spans.records(), spans.counters()
    trace = json.loads(path.read_text())
    complete = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert len(complete) == len(recs) > 0
    base = trace["baseTimeNanoseconds"]
    assert base % (spans.TRACE_BASE_S * 10 ** 9) == 0
    for e, r in zip(complete, recs):
        assert e["name"] == r.name and e["args"]["id"] == r.id
        assert abs(e["ts"] * 1e3 + base - r.start_ns) < 1e3
        assert abs(e["dur"] * 1e3 - (r.end_ns - r.start_ns)) < 1e3
    pushes = [e for e in trace["traceEvents"]
              if e["ph"] == "C" and e["name"] == "pushes"]
    assert pushes[-1]["args"]["pushes"] == counts["pushes"] >= 2


def test_device_interval_records_nothing_on_the_cpu():
    with _recording():
        with spans.span("replay"):
            with spans.device_interval("replay", torch.device("cpu")) as d:
                assert d is None
        assert [r.name for r in spans.records()] == ["replay"]
        assert spans.counters() == {}


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_replay_spans_bracket_their_graph_launch(cuda_device):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    node = tnode.SlamNode(CFG, device=cuda_device, seed=3)
    node.process_scan(0, _scan(0))
    with _recording():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for k in range(1, 9):
                node.process_scan(0, _scan(k))
            torch.cuda.synchronize()
        recs, counts = spans.records(), spans.counters()
    launches = [(e.start_ns(), e.end_ns())
                for e in prof.profiler.kineto_results.events()
                if e.device_type() != DeviceType.CUDA
                and e.name() == "cudaGraphLaunch"]
    by_id = {r.id: r for r in recs}
    replays = [r for r in recs if r.name == "replay"
               and "device_ms" not in r.attrs]
    assert len(replays) >= 8
    for r in replays:
        inside = [b for b, e in launches if r.start_ns <= b and e
                  <= r.end_ns]
        assert len(inside) == 1, r
        assert by_id[r.parent].name in ("localize_step_jit",
                                        "extract_segments_jit")
        interval, = [x for x in recs if x.parent == r.id]
        assert interval.attrs["device_ms"] > 0
    steps = [r for r in recs if r.name == "localize_step_jit"]
    assert len(steps) == 8
    for s in steps:
        assert [c.name for c in recs if c.parent == s.id] == [
            "key", "copy_in", "replay", "clone_out"]
    assert counts.get("captures", 0) == 0


@pytest.mark.cuda
def test_recording_adds_no_host_read(cuda_device):
    """The same 10 scans on two nodes, the recorder off and on: the same
    reads of the card's values by the host, in the same order."""
    names = ("tolist", "cpu", "item", "__bool__", "__int__", "__float__")
    saved = {name: getattr(torch.Tensor, name) for name in names}

    def counted(name, orig, reads):
        def read(self, *args, **kwargs):
            if self.is_cuda:
                reads.append(name)
            return orig(self, *args, **kwargs)
        return read

    got = []
    for on in (False, True):
        node = tnode.SlamNode(CFG, device=cuda_device, seed=3)
        node.process_scan(0, _scan(0))
        reads = []
        with (_recording() if on else contextlib.nullcontext()):
            for name, orig in saved.items():
                setattr(torch.Tensor, name, counted(name, orig, reads))
            try:
                for k in range(1, 11):
                    node.process_scan(0, _scan(k))
            finally:
                for name, orig in saved.items():
                    setattr(torch.Tensor, name, orig)
        got.append(reads)
    assert got[0] == got[1] and got[0].count("tolist") == 10


def test_cli_run_writes_the_spans(tmp_path):
    from ohm_tsd_slam_tpu_torch.__main__ import main

    log, path = str(tmp_path / "s.npz"), str(tmp_path / "spans.json")
    assert main(["simulate", "--out", log, "--steps", "4", "--beams",
                 "121"]) == 0
    assert main(["run", log, "--out", str(tmp_path / "out"), "--device",
                 "cpu", "--spans", path]) == 0
    assert not spans.enabled()
    events = json.loads(open(path).read())["traceEvents"]
    roots = [e["args"]["scan"] for e in events
             if e["name"] == "process_scan"]
    assert roots == [-1, 0, 1, 2]
    assert {"publish_map", "occupancy", "image"} <= {e["name"]
                                                     for e in events}
    assert any(e["ph"] == "C" and e["name"] == "icp_iterations_run"
               for e in events)
    spans.reset()
