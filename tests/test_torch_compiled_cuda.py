"""The compiled entry points on the card (`cuda`-marked: they skip without
one; on the card run them with
`python -m pytest --noconftest -m cuda tests/test_torch_compiled_cuda.py`).

This file imports torch and numpy only: the card's machine has no JAX.
Asserted, on a float32 room (map_size 8, 0.04 m cells, 361 beams):
  * SlamNode's compiled step (localize_step_jit, graph replays) equals the
    eager localize_step on the same inputs in every bit of all ten
    fields over 30 scans that cross grid versions (so the copy of a new
    grid into the graph's buffers runs), in the modes ICP, GN, TSD and
    AMCL; in the modes that draw, the generator is left where the eager
    step leaves it; the node's trace equals the eager node's;
  * two calls' outputs do not alias, and a replay leaves an earlier
    call's result as it was;
  * a change of params or of a shape captures again, and each graph
    equals the eager call (icp_jit, raycast_fast_jit,
    match_gauss_newton_jit, extract_segments_jit; on a map_size 6 grid
    with kernel E in the extraction's graph);
  * two robots with equal params, each in a thread of its own, share one
    graph and each gets its own eager result;
  * a capture that fails (a host read inside the function) raises;
  * a cache that is stale for the grid keys a graph of its own and
    counts every beam as dropped, as the eager caster does;
  * the draws of a replay equal those of a fresh generator of the same
    seed, and the caller's generator is left where the eager call leaves
    it; on a segment overflow the guard inside the node's graph renders
    with the exact march, so the trace equals the exact-march node's,
    with no new capture and no eager step;
  * the kernel wrappers count the calls that launch: the warm-up and the
    capture call them, a replay calls none;
  * a conditional node's body is captured whichever stream torch's pool
    hands out next (one of its 32 is the capture's own);
  * the threaded runtime (SlamNode.start()) with two robots on the
    compiled step, the graphs captured while the other threads run: no
    thread raises, no ray is dropped, both robots track.
"""

import contextlib
import dataclasses
import math
import threading
import time

import pytest
import torch

from ohm_tsd_slam_tpu_torch.config import (
    GridConfig,
    IcpConfig,
    RansacConfig,
    RegistrationConfig,
    RegMode,
    RobotConfig,
    SensorConfig,
    SlamConfig,
)
from ohm_tsd_slam_tpu_torch.core import se2
from ohm_tsd_slam_tpu_torch.grid import raycast_fast as rf
from ohm_tsd_slam_tpu_torch.grid.push import push
from ohm_tsd_slam_tpu_torch.grid.state import create
from ohm_tsd_slam_tpu_torch.ops.segment_min_cuda import segment_min
from ohm_tsd_slam_tpu_torch.registration.gauss_newton import (
    GnParams,
    match_gauss_newton,
    match_gauss_newton_jit,
)
from ohm_tsd_slam_tpu_torch.registration.icp import IcpParams, icp, icp_jit
from ohm_tsd_slam_tpu_torch.sensor import polar2d
from ohm_tsd_slam_tpu_torch.slam import localize as tlocalize
from ohm_tsd_slam_tpu_torch.slam import node as tnode
from ohm_tsd_slam_tpu_torch.slam.localize import (
    LocalizeParams,
    LocalizeResult,
    localize_step,
    localize_step_jit,
)
from ohm_tsd_slam_tpu_torch.slam.messages import LaserScan
from ohm_tsd_slam_tpu_torch.utils.compiled import compiled, when
from ohm_tsd_slam_tpu_torch.utils.testing import (
    limit_cpu_threads,
    rect_walls,
    simulate_scan,
)

limit_cpu_threads()

CFG = GridConfig(map_size=8, cellsize=0.04)
BEAMS, RES, PHI0, RMAX = 361, math.radians(0.75), math.radians(-135), 9.0
GEOM = polar2d.SensorPolar2D(size=BEAMS, angular_res=RES, phi_min=PHI0,
                             max_range=RMAX, min_range=0.01,
                             low_reflectivity_range=1.0)
SCANS = 30


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _ranges(xyt, geom=GEOM):
    pose = se2.make(*xyt, dtype=torch.float64).numpy()
    return simulate_scan(pose, geom.size, geom.angular_res, geom.phi_min,
                         geom.max_range,
                         segments=rect_walls(1.51, 1.53, 8.47, 8.49),
                         circles=[((7.0, 7.2), 0.5)])


def _bits(t):
    return t.detach().contiguous().cpu().numpy().tobytes()


def _same(a, b) -> bool:
    """Equal in every bit (NaN included), or both None."""
    if a is None or b is None:
        return a is None and b is None
    return (a.shape == b.shape and a.dtype == b.dtype
            and _bits(a) == _bits(b))


def _node_cfg(mode: int) -> SlamConfig:
    return SlamConfig(
        grid=CFG,
        robots=[RobotConfig(
            local_offset_yaw=0.2,
            sensor=SensorConfig(max_range=RMAX, min_range=0.01,
                                low_reflectivity_range=1.0),
            registration=RegistrationConfig(
                mode=RegMode(mode),
                icp=IcpConfig(iterations=30, dist_filter_max=0.5,
                              dist_filter_min=0.05),
                ransac=RansacConfig(trials=40, size_control_set=60)))])


class StepCheck:
    """Stands in for the node's localize_step_jit: runs it, then the
    eager step on the same inputs with a generator of the same state, and
    asserts every field and the generator's state after equal in every
    bit."""

    def __init__(self):
        self.calls = 0

    def __call__(self, grid, pose, last_pose, data, mask, params,
                 T_prereg=None, generator=None, odom_state=None,
                 segments=None):
        twin = None
        if generator is not None:
            twin = torch.Generator(device=generator.device)
            twin.set_state(generator.get_state())
        got = localize_step_jit(grid, pose, last_pose, data, mask, params,
                                T_prereg, generator, odom_state, segments)
        want = localize_step(grid, pose, last_pose, data, mask, params,
                             T_prereg, twin, odom_state, segments)
        for f in LocalizeResult._fields:
            assert _same(getattr(got, f), getattr(want, f)), (self.calls, f)
        if generator is not None:
            assert torch.equal(generator.get_state(), twin.get_state())
        self.calls += 1
        return got


@contextlib.contextmanager
def _eager_step(monkeypatch):
    """The node's step and extraction eager on the card (the reference
    the compiled node is held against), and no priming."""
    with monkeypatch.context() as m:
        m.setattr(tnode, "localize_step_jit", localize_step)
        m.setattr(tnode, "extract_segments_jit", rf.extract_segments)
        m.setattr(tnode.SlamNode, "_prime_step", lambda *args: None)
        yield


def _drive(node, n=SCANS):
    poses, updates = [], 0
    for k in range(n):
        xyt = (5.12 + 0.03 * k, 5.12, 0.2)
        before = node.grid.tsd
        node.process_scan(0, LaserScan(ranges=_ranges(xyt), angle_min=PHI0,
                                       angle_increment=RES, range_max=RMAX,
                                       stamp=float(k)))
        updates += node.grid.tsd is not before
        poses.append(node.localizers[0].pose.clone())
    return torch.stack(poses), updates


def _drive_from(node, k0, n):
    """_drive's scans k0 .. n - 1."""
    poses = []
    for k in range(k0, n):
        xyt = (5.12 + 0.03 * k, 5.12, 0.2)
        node.process_scan(0, LaserScan(ranges=_ranges(xyt), angle_min=PHI0,
                                       angle_increment=RES, range_max=RMAX,
                                       stamp=float(k)))
        poses.append(node.localizers[0].pose.clone())
    return torch.stack(poses)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [RegMode.ICP, RegMode.GN, RegMode.TSD,
                                  RegMode.AMCL])
def test_node_replays_equal_the_eager_step(cuda_device, mode, monkeypatch):
    cfg = _node_cfg(int(mode))
    with _eager_step(monkeypatch):
        eager, _ = _drive(tnode.SlamNode(cfg, device=cuda_device, seed=4))
    check = StepCheck()
    monkeypatch.setattr(tnode, "localize_step_jit", check)
    graph = localize_step_jit.compiled
    captures = graph.captures
    got, updates = _drive(tnode.SlamNode(cfg, device=cuda_device, seed=4))
    assert updates >= 5                     # the grid copy ran
    assert check.calls == SCANS             # the priming call and 29 scans
    assert graph.captures == captures + 1
    assert _same(got, eager)
    if mode != RegMode.GN:
        # GN loses this room in both steps alike (it loses track on the
        # turning trajectory of utils/testing.py's room too, as the JAX
        # package does: tools/gn_trajectory.py); the others track it
        err = math.hypot(float(got[-1, 0, 2]) - (5.12 + 0.03 * (SCANS - 1)),
                         float(got[-1, 1, 2]) - 5.12)
        assert err < 2.5 * CFG.cellsize


def _room(device):
    g = create(CFG, dtype=torch.float32, device=device)
    for xyt in ((5.12, 5.12, 0.2), (5.4, 4.9, -0.3), (5.0, 5.3, 0.6)):
        data, mask = polar2d.standard_mask(
            GEOM, torch.from_numpy(_ranges(xyt)).float().to(device))
        g = push(g, GEOM, se2.make(*xyt, device=device), data, mask)
    return g


def _scene(device, xyt=(5.15, 5.1, 0.21)):
    data, mask = polar2d.standard_mask(
        GEOM, torch.from_numpy(_ranges(xyt)).float().to(device))
    return data, mask


@pytest.mark.cuda
def test_outputs_do_not_alias(cuda_device):
    grid = _room(cuda_device)
    seg = rf.extract_segments_jit(grid)
    params = LocalizeParams(geom=GEOM, icp=IcpParams(iterations=20))
    pose = se2.make(5.12, 5.12, 0.2, device=cuda_device)
    a_data, a_mask = _scene(cuda_device)
    b_data, b_mask = _scene(cuda_device, (5.0, 5.25, 0.15))
    a = localize_step_jit(grid, pose, pose, a_data, a_mask, params,
                          segments=seg)
    keep = [t.clone() for t in a]
    b = localize_step_jit(grid, pose, pose, b_data, b_mask, params,
                          segments=seg)
    for ta, tb, tk in zip(a, b, keep):
        assert ta.data_ptr() != tb.data_ptr()
        assert _same(ta, tk)
    assert not _same(a.pose, b.pose)
    want = localize_step(grid, pose, pose, b_data, b_mask, params,
                         segments=seg)
    assert all(_same(x, y) for x, y in zip(b, want))


@pytest.mark.cuda
def test_new_params_or_shape_capture_again(cuda_device):
    grid = _room(cuda_device)
    pose = se2.make(5.12, 5.12, 0.2, device=cuda_device)
    model = rf.raycast_fast_jit(grid, GEOM, pose)
    assert all(_same(x, y) for x, y in zip(
        model, rf.raycast_fast(grid, GEOM, pose)))
    data, mask = _scene(cuda_device)
    scene, smask = polar2d.data_to_cartesian(GEOM, data, mask)
    args = (model.coords, model.mask, scene, smask)
    n0 = icp_jit.captures
    for it, beams in ((20, BEAMS), (25, BEAMS), (20, BEAMS), (20, 200)):
        p = IcpParams(iterations=it, record_T=it == 25)
        a = tuple(t[:beams] for t in args)
        got = icp_jit(*a, p, sensor_pose=pose)
        want = icp(*a, p, sensor_pose=pose)
        for f in got._fields:
            assert _same(getattr(got, f), getattr(want, f)), (it, beams, f)
    assert icp_jit.captures == n0 + 3            # (20, 361) seen twice
    gp = GnParams(iterations=12)
    for p in (gp, dataclasses.replace(gp, iterations=8)):
        got = match_gauss_newton_jit(grid, pose, scene, smask, p)
        want = match_gauss_newton(grid, pose, scene, smask, p)
        assert all(_same(x, y) for x, y in zip(got, want))
    seg = rf.extract_segments_jit(grid)
    ref = rf.extract_segments(grid)
    assert seg.tsd is grid.tsd and seg.version == grid.tsd._version
    for f in ("p0", "p1", "valid", "n_dropped", "pack", "count", "origin"):
        assert _same(getattr(seg, f), getattr(ref, f)), f


@pytest.mark.cuda
def test_two_robots_with_equal_params_share_a_graph(cuda_device):
    grid = _room(cuda_device)
    seg = rf.extract_segments_jit(grid)
    params = LocalizeParams(geom=GEOM, icp=IcpParams(iterations=22))
    inputs = [(se2.make(5.12 + 0.05 * r, 5.12, 0.2, device=cuda_device),
               *_scene(cuda_device, (5.15 + 0.05 * r, 5.1, 0.21)))
              for r in range(2)]
    want = [localize_step(grid, p, p, d, m, params, segments=seg)
            for p, d, m in inputs]
    captures = localize_step_jit.compiled.captures
    p0, d0, m0 = inputs[0]
    localize_step_jit(grid, p0, p0, d0, m0, params, segments=seg)
    assert localize_step_jit.compiled.captures == captures + 1
    bad = []

    def robot(r):
        p, d, m = inputs[r]
        for _ in range(40):
            got = localize_step_jit(grid, p, p, d, m, params, segments=seg)
            if not all(_same(x, y) for x, y in zip(got, want[r])):
                bad.append(r)

    threads = [threading.Thread(target=robot, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert not bad
    assert localize_step_jit.compiled.captures == captures + 1


@pytest.mark.cuda
def test_a_failed_capture_raises(cuda_device):
    def reads_back(x):
        return x * float(x.sum())           # a host read: no capture

    f = compiled(reads_back)
    x = torch.ones(8, device=cuda_device)
    assert torch.equal(f(x.cpu()), reads_back(x.cpu()))
    with pytest.raises(RuntimeError):
        f(x)
    assert f.captures == 0


@pytest.mark.cuda
def test_a_stale_cache_keys_its_own_graph(cuda_device):
    grid = _room(cuda_device)
    seg = rf.extract_segments(grid)
    newer = dataclasses.replace(grid, tsd=grid.tsd.clone())
    pose = se2.make(5.12, 5.12, 0.2, device=cuda_device)
    fresh = rf.raycast_fast_jit(grid, GEOM, pose, segments=seg)
    stale = rf.raycast_fast_jit(newer, GEOM, pose, segments=seg)
    assert int(fresh.n_dropped) == 0 and int(stale.n_dropped) == BEAMS
    for got, g in ((fresh, grid), (stale, newer)):
        want = rf.raycast_fast(g, GEOM, pose, segments=seg)
        assert all(_same(x, y) for x, y in zip(got, want))


@pytest.mark.cuda
def test_a_replay_calls_no_wrapper(cuda_device):
    grid = _room(cuda_device)
    seg = rf.extract_segments(grid)
    geom = dataclasses.replace(GEOM, max_range=8.5)   # a key of its own
    pose = se2.make(5.12, 5.12, 0.2, device=cuda_device)
    n0 = segment_min.launches
    rf.raycast_fast_jit(grid, geom, pose, segments=seg)
    assert segment_min.launches == n0 + 2     # the warm-up, the capture
    for _ in range(5):
        rf.raycast_fast_jit(grid, geom, pose, segments=seg)
    assert segment_min.launches == n0 + 2


@pytest.mark.cuda
def test_draws_equal_a_fresh_generators(cuda_device):
    def noisy(x, generator):
        return x + torch.rand(x.shape, generator=generator,
                              device=x.device) * torch.randn(
            (), generator=generator, device=x.device)

    f = compiled(noisy)
    x = torch.linspace(0.0, 1.0, 1000, device=cuda_device)
    for seed in (1, 2, 1, 77):
        gen = torch.Generator(device=cuda_device)
        gen.manual_seed(seed)
        fresh = torch.Generator(device=cuda_device)
        fresh.manual_seed(seed)
        assert _same(f(x, gen), noisy(x, fresh))
        assert torch.equal(gen.get_state(), fresh.get_state())
    assert f.captures == 1 and f.replays == 4


@pytest.mark.cuda
def test_node_overflow_guard_runs_in_the_graph(cuda_device, monkeypatch):
    """A segment overflow on every scan: the compiled step's guard renders
    each scan with the exact march inside the graph (a conditional node),
    so the node's trace equals that of a node on the exact march, bit for
    bit, with no new capture after the priming one and no eager step."""
    monkeypatch.setattr(rf, "MAX_SEGMENTS", 128)
    cfg = _node_cfg(int(RegMode.ICP))
    from_config = LocalizeParams.from_config
    with _eager_step(monkeypatch), monkeypatch.context() as m:
        m.setattr(LocalizeParams, "from_config", staticmethod(
            lambda *a, **k: dataclasses.replace(from_config(*a, **k),
                                                fast_raycast=False)))
        want, _ = _drive(tnode.SlamNode(cfg, device=cuda_device), 6)
    graph = localize_step_jit.compiled
    node = tnode.SlamNode(cfg, device=cuda_device)
    first, _ = _drive(node, 1)          # initialises, primes the step
    captures = graph.captures
    eager = []
    with monkeypatch.context() as m:
        m.setattr(tlocalize, "localize_step",
                  lambda *a, **k: eager.append(1) or localize_step(*a, **k))
        rest = _drive_from(node, 1, 6)
    assert node.localizers[0].rays_dropped > 0
    assert graph.captures == captures and not eager
    assert _same(torch.cat([first, rest]), want)


@pytest.mark.cuda
def test_general_extraction_replays_kernel_e(cuda_device):
    """A grid under 128 cells wide (map_size 6) takes the dense layers and
    kernel E inside extract_segments_jit's graph, bit for bit."""
    from ohm_tsd_slam_tpu_torch.ops.compact_channels_cuda import (
        compact_channels,
    )

    cfg = GridConfig(map_size=6, cellsize=0.1)
    geom = dataclasses.replace(GEOM, max_range=5.0)
    g = create(cfg, dtype=torch.float32, device=cuda_device)
    for xyt in ((3.2, 3.2, 0.2), (3.0, 3.4, -0.4)):
        pose = se2.make(*xyt, dtype=torch.float64).numpy()
        r = simulate_scan(pose, geom.size, geom.angular_res, geom.phi_min,
                          geom.max_range, segments=rect_walls(0.73, 0.71,
                                                              5.67, 5.69))
        data, mask = polar2d.standard_mask(
            geom, torch.from_numpy(r).float().to(cuda_device))
        g = push(g, geom, se2.make(*xyt, device=cuda_device), data, mask)
        assert not rf.fused_extraction(g)
        n0 = compact_channels.launches
        captures = rf.extract_segments_jit.compiled.captures
        seg = rf.extract_segments_jit(g)
        ref = rf.extract_segments(g)
        new = rf.extract_segments_jit.compiled.captures - captures
        # the eager call, and a capture's warm-up and capture
        assert compact_channels.launches - n0 == 1 + 2 * new
        for f in ("p0", "p1", "valid", "n_dropped", "pack", "count",
                  "origin"):
            assert _same(getattr(seg, f), getattr(ref, f)), f
        assert int(seg.count) > 50


@pytest.mark.cuda
def test_threaded_runtime_on_the_compiled_step(cuda_device):
    """SlamNode.start() (the mapper, the grid publisher and a localizer
    thread a robot) with two robots of other params on the compiled step,
    both graphs' caches emptied first: robot 0's step is captured before
    the threads have work, robot 1's (it starts four scans later) while
    robot 0's thread replays and the mapper pushes.  No thread raises, no ray is
    dropped, and each robot's last pose is within 2.5 cells of the
    truth."""
    offsets, late = (0.0, 0.3), (0, 4)       # each robot's y, first scan
    cfg = dataclasses.replace(_node_cfg(int(RegMode.ICP)), robots=[
        dataclasses.replace(_node_cfg(int(RegMode.ICP)).robots[0],
                            local_offset_y=dy,
                            registration=dataclasses.replace(
                                _node_cfg(int(RegMode.ICP)).robots[0]
                                .registration,
                                icp=IcpConfig(iterations=30 - 5 * r,
                                              dist_filter_max=0.5,
                                              dist_filter_min=0.05)))
        for r, dy in enumerate(offsets)])
    graphs = (localize_step_jit.compiled, rf.extract_segments_jit.compiled)
    for g in graphs:
        g.clear_cache()
    captures = localize_step_jit.compiled.captures
    raised = []
    hook = threading.excepthook
    threading.excepthook = raised.append
    node = tnode.SlamNode(cfg, device=cuda_device, seed=4)
    node.start()
    try:
        for k in range(SCANS + late[1]):
            for r, dy in enumerate(offsets):
                j = k - late[r]               # the robot's own scan index
                if 0 <= j < SCANS:
                    node.on_scan(r, LaserScan(
                        ranges=_ranges((5.12 + 0.03 * j, 5.12 + dy, 0.2)),
                        angle_min=PHI0, angle_increment=RES,
                        range_max=RMAX, stamp=float(j)))
            time.sleep(0.025)
        deadline = time.monotonic() + 60.0
        while not raised and any(
                loc.last_result is None or loc.last_result.stamp != SCANS - 1
                for loc in node.localizers):
            assert time.monotonic() < deadline
            time.sleep(0.01)
    finally:
        node.stop()
        threading.excepthook = hook
    assert not raised, [repr(a.exc_value) for a in raised]
    assert localize_step_jit.compiled.captures == captures + 2
    for loc, dy in zip(node.localizers, offsets):
        assert loc.rays_dropped == 0
        pose = loc.pose.cpu()
        err = math.hypot(float(pose[0, 2]) - (5.12 + 0.03 * (SCANS - 1)),
                         float(pose[1, 2]) - (5.12 + dy))
        assert err < 2.5 * CFG.cellsize, err


@pytest.mark.cuda
def test_a_conditional_body_never_takes_the_capture_stream(cuda_device):
    """torch's pool hands out its 32 streams in turn and torch.cuda.graph
    captures on one of them: whichever stream the pool would hand the IF
    node's body next, the capture succeeds and replays both branches."""
    def f(x):
        y = x + 1.0
        return when(x.sum() > 0, lambda: y * 2.0, y)

    pos = torch.arange(4.0, device=cuda_device)
    for skip in range(33):
        _ = [torch.cuda.Stream(cuda_device) for _ in range(skip)]
        g = compiled(f)
        assert torch.equal(g(pos), (pos + 1.0) * 2.0), skip
        assert torch.equal(g(-pos - 1.0), -pos), skip
        assert g.captures == 1, skip
