"""The port's last compiled entry points and the overflow guard on the CPU,
in float64, against the JAX package.

raycast_checked_jit (both branches), raycast_jit, push_jit,
push_tree_jit, occupancy_grid_jit, grid_to_color_image_jit and
render_ranges_jit (ranges and both gradients against `jax.grad`) are each
held against the JAX package's `*_jit` on the same inputs: the room of
tests/test_torch_parallel.py's case (one JAX push, 181 beams, 283
segments) for the casters, tests/test_torch_push_tree.py's room for the
pushes and the publication, tests/test_torch_render.py's scene for the
render.  On CPU tensors each entry point runs its eager function and
builds no graph, so each also equals the eager function in every bit.
The guard (utils/compiled.py::when) branches on the host here: fn's
result where the predicate holds, `out` itself otherwise.  The node on a
segment overflow runs one step a scan and reads the host twice
(tests/test_torch_parallel_overflow.py holds the multi-robot step on an
overflow).
Tolerances are those of the parity tests of the same stages: 1e-9 for
poses, coordinates, ranges and gradients, 1e-12 for the pushed grids,
every flag, count, mask and image equal.  The replays themselves are
tested on the card (tests/test_torch_compiled_cuda.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ohm_tsd_slam_tpu.core import se2 as jse2
from ohm_tsd_slam_tpu.grid import raycast_fast as jrf
from ohm_tsd_slam_tpu.grid.axis_aligned import (
    occupancy_grid_jit as j_occupancy_jit,
)
from ohm_tsd_slam_tpu.grid.color import (
    grid_to_color_image_jit as j_color_jit,
)
from ohm_tsd_slam_tpu.grid.push import push_jit as j_push_jit
from ohm_tsd_slam_tpu.grid.push import push_tree_jit as j_push_tree_jit
from ohm_tsd_slam_tpu.grid.raycast import raycast_jit as j_raycast_jit
from ohm_tsd_slam_tpu.grid.render import render_ranges_jit as j_render_jit
from ohm_tsd_slam_tpu_torch import grid as tgrid
from ohm_tsd_slam_tpu_torch.core import se2
from ohm_tsd_slam_tpu_torch.grid import raycast_fast as rf
from ohm_tsd_slam_tpu_torch.grid.axis_aligned import (
    occupancy_grid,
    occupancy_grid_jit,
)
from ohm_tsd_slam_tpu_torch.grid.color import (
    grid_to_color_image,
    grid_to_color_image_jit,
)
from ohm_tsd_slam_tpu_torch.grid.push import (
    push,
    push_jit,
    push_tree,
    push_tree_jit,
)
from ohm_tsd_slam_tpu_torch.grid.raycast import raycast, raycast_jit
from ohm_tsd_slam_tpu_torch.grid.render import (
    render_ranges,
    render_ranges_jit,
)
from ohm_tsd_slam_tpu_torch.slam import localize as tlocalize
from ohm_tsd_slam_tpu_torch.utils import compiled as tcompiled
from ohm_tsd_slam_tpu_torch.utils.compiled import when
from ohm_tsd_slam_tpu_torch.utils.testing import limit_cpu_threads
from test_torch_compiled import _close, _equal, _inputs, no_graphs  # noqa
from test_torch_parallel import MODES, _params
from test_torch_push_tree import (
    _assert_grids_equal,
    _assert_same_bits,
    _push_seq,
)
from test_torch_render import F64, X0, scene  # noqa: F401
from test_torch_slam import ROOM_CFG, _cpu_node, _room_scan

limit_cpu_threads()

TOL = 1e-9
OVERFLOW = 128               # a capacity below the case grid's segments


def _assert_render_close(got, want):
    m = got.mask.numpy()
    _equal(got.mask, want.mask)
    assert m.sum() > 100
    for f in ("coords", "normals", "ranges"):
        np.testing.assert_allclose(getattr(got, f).numpy()[m],
                                   np.asarray(getattr(want, f))[m],
                                   rtol=0, atol=TOL)


@pytest.mark.parametrize("branch", ["fast", "exact"])
def test_raycast_checked_jit_matches_jax(branch, no_graphs):
    """Without an overflow the fast caster's result, untouched; with one
    the exact march's, n_dropped the fast caster's count; as JAX's."""
    c, (pose, _, _), (jpose, _, _) = _inputs()
    jparams, tparams = _params(MODES["icp"])
    cap = OVERFLOW if branch == "exact" else None
    seg = rf.extract_segments(c["grid"], max_segments=cap)
    jseg = jrf.extract_segments(c["jgrid"], max_segments=cap)
    got = rf.raycast_checked_jit(c["grid"], tparams.geom, pose, segments=seg)
    want = jrf.raycast_checked_jit(c["jgrid"], jparams.geom, jpose,
                                   segments=jseg)
    assert int(got.n_dropped) == int(want.n_dropped)
    assert (int(got.n_dropped) > 0) == (branch == "exact")
    _assert_render_close(got, want)
    ref = (raycast(c["grid"], tparams.geom, pose) if branch == "exact"
           else rf.raycast_fast(c["grid"], tparams.geom, pose, segments=seg))
    for f in ("coords", "normals", "mask", "ranges"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    assert torch.equal(got.n_dropped, seg.n_dropped)


def test_raycast_jit_matches_jax(no_graphs):
    c, (pose, _, _), (jpose, _, _) = _inputs()
    jparams, tparams = _params(MODES["icp"])
    got = raycast_jit(c["grid"], tparams.geom, pose)
    _assert_render_close(got, j_raycast_jit(c["jgrid"], jparams.geom, jpose))
    assert int(got.n_dropped) == 0
    for a, b in zip(got, raycast(c["grid"], tparams.geom, pose)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["push", "push_tree"])
def test_push_jits_match_jax(name, no_graphs):
    """The room's three pushes through push_jit or push_tree_jit against
    the JAX package's, and against the eager push in every bit."""
    fn, jfn = {"push": (push_jit, j_push_jit),
               "push_tree": (push_tree_jit, j_push_tree_jit)}[name]
    g, jgrid = _push_seq(fn, jfn)
    _assert_grids_equal(g, jgrid, 1e-12)
    _assert_same_bits(g, _push_seq(push, jfn)[0])
    assert int(g.tile_init.sum()) > 10


def test_publication_jits_match_jax(no_graphs):
    """occupancy_grid_jit (with and without inflation) and
    grid_to_color_image_jit (full size and 64 x 48) on the room's grid."""
    g, jgrid = _push_seq(push, j_push_jit)
    for infl in (False, True):
        got = occupancy_grid_jit(g, use_inflation=infl, inflation_factor=2)
        want = j_occupancy_jit(jgrid, use_inflation=infl,
                               inflation_factor=2)
        _equal(got.occupancy, want.occupancy)
        assert int(got.n_surface) == int(want.n_surface) > 0
        eager = occupancy_grid(g, use_inflation=infl, inflation_factor=2)
        assert torch.equal(got.occupancy, eager.occupancy)
    for size in ({}, {"width": 64, "height": 48}):
        got = grid_to_color_image_jit(g, **size)
        _equal(got, j_color_jit(jgrid, **size))
        assert torch.equal(got, grid_to_color_image(g, **size))
    assert (occupancy_grid_jit(g).occupancy == 100).sum() > 20


@pytest.mark.parametrize("use_fast", [False, True])
def test_render_ranges_jit_matches_jax_grad(scene, use_fast, no_graphs):
    """Ranges, hits, and the gradients of Σ w·ranges into the pose (x, y,
    θ) and the cells against jax.grad of the JAX package's
    render_ranges_jit, and against eager render_ranges in every bit."""
    w = torch.from_numpy(scene["w"])

    def port(fn):
        x = torch.tensor(X0, dtype=F64, requires_grad=True)
        tsd = scene["grid"].tsd.clone().requires_grad_(True)
        g = dataclasses.replace(scene["grid"], tsd=tsd)
        ranges, hit, _ = fn(g, scene["geom"], se2.make(x[0], x[1], x[2],
                                                       dtype=F64),
                            use_fast=use_fast)
        (w * ranges).sum().backward()
        return ranges.detach(), hit, x.grad, tsd.grad

    def loss(xyt, t):
        jg = dataclasses.replace(scene["jgrid"], tsd=t)
        pose = jse2.make(xyt[0], xyt[1], xyt[2], dtype=jnp.float64)
        r, _, _ = j_render_jit(jg, scene["jgeom"], pose, use_fast=use_fast)
        return jnp.sum(jnp.asarray(scene["w"]) * r)

    ranges, hit, dpose, dtsd = port(render_ranges_jit)
    jpose = jse2.make(*X0, dtype=jnp.float64)
    jranges, jhit, _ = j_render_jit(scene["jgrid"], scene["jgeom"], jpose,
                                    use_fast=use_fast)
    _equal(hit, jhit)
    _close(ranges, jranges)
    want_pose, want_tsd = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        jnp.asarray(X0), scene["jgrid"].tsd)
    _close(dpose, want_pose)
    want_tsd = np.asarray(want_tsd)
    assert (dtsd.numpy() != 0).sum() > 50
    np.testing.assert_array_equal(dtsd.numpy() != 0, want_tsd != 0)
    _close(dtsd, want_tsd)
    for a, b in zip((ranges, hit, dpose, dtsd), port(render_ranges)):
        assert torch.equal(a, b)


def test_when_branches_on_the_host():
    """fn's result where the predicate holds, `out` itself otherwise; a
    capture's warm-up runs fn either way."""
    out = (torch.zeros(3), torch.ones(2))
    calls = []

    def fn():
        calls.append(1)
        return torch.full((3,), 2.0), out[1]

    assert when(torch.tensor(False), fn, out) is out and not calls
    got = when(torch.tensor(True), fn, out)
    assert torch.equal(got[0], torch.full((3,), 2.0)) and got[1] is out[1]
    assert torch.equal(out[0], torch.zeros(3)) and len(calls) == 1
    tcompiled._local.warming = True
    try:
        assert when(torch.tensor(False), fn, out) is out
    finally:
        tcompiled._local.warming = False
    assert len(calls) == 2


def test_node_steps_once_and_reads_twice_on_an_overflow(monkeypatch):
    """Every scan overflows the segment capacity: the node runs one step
    a scan (localize_step reached through localize_step_jit only, never a
    second time for the exact march) and reads the host twice (the gate
    flags with the drop count, then the pose)."""
    monkeypatch.setattr(rf, "MAX_SEGMENTS", OVERFLOW)
    steps, reads = [], []
    step = tlocalize.localize_step
    monkeypatch.setattr(tlocalize, "localize_step",
                        lambda *a, **k: steps.append(1) or step(*a, **k))
    node = _cpu_node(ROOM_CFG)
    node.process_scan(0, _room_scan(5.12, 0.0))
    for name in ("tolist", "cpu"):
        orig = getattr(torch.Tensor, name)
        monkeypatch.setattr(
            torch.Tensor, name,
            lambda self, *a, _o=orig, _n=name, **k: reads.append(_n)
            or _o(self, *a, **k))
    for k in range(1, 5):
        steps.clear()
        reads.clear()
        out = node.process_scan(0, _room_scan(5.12 + 0.03 * k, float(k)))
        assert out is not None and not out.is_nan, k
        assert node.localizers[0].rays_dropped > 0, k
        assert len(steps) == 1 and reads == ["tolist", "cpu"], (steps, reads)


def test_cpu_entry_points_build_no_graph(scene, no_graphs):
    c, (pose, _, _), _ = _inputs()
    _, tparams = _params(MODES["icp"])
    geom = tparams.geom
    rf.raycast_checked_jit(c["grid"], geom, pose)
    raycast_jit(c["grid"], geom, pose)
    g = push_jit(c["grid"], geom, pose, c["data"][0], c["mask"][0])
    push_tree_jit(g, geom, pose, c["data"][0], c["mask"][0])
    occupancy_grid_jit(g)
    grid_to_color_image_jit(g)
    x = torch.tensor(X0, dtype=F64, requires_grad=True)
    ranges, _, _ = render_ranges_jit(scene["grid"], scene["geom"],
                                     se2.make(x[0], x[1], x[2], dtype=F64))
    ranges.sum().backward()
    assert x.grad is not None
    for fn in (rf.raycast_checked_jit, raycast_jit, tgrid.push_jit,
               tgrid.push_tree_jit, occupancy_grid_jit,
               grid_to_color_image_jit):
        assert fn.compiled.graphs() == [] and fn.compiled.captures == 0
    assert all(f.graphs() == [] for f in render_ranges_jit.compiled)
    assert tgrid.render_ranges_jit is render_ranges_jit
    assert tgrid.raycast_jit is raycast_jit and push_tree is tgrid.push_tree
