"""ICP's iteration in few, wide ops (registration/icp.py and
estimators.py::closed_form_2d_paired) against the formulation it
replaced, kept here as the reference: the estimator's eight separate
masked sums, the scene transformed by T and then again by the sensor
pose for the bounds test, and the freeze on separate 0-d tensors.

On the CPU the two agree in every bit, in float64 and in float32: each
masked sum of the new form is a contiguous row, summed in the order of a
lone 1-D sum.  The benchmark's plain reference (slambench/reference/,
held to the CPU node in every bit by
slambench/tests/test_slambench_reference.py) sums as the old form does.

And the count of the torch ops one iteration dispatches, held to a bound
so that it cannot creep back: each is a kernel that a CUDA graph replays
in a couple of microseconds whatever its size.
"""

import importlib

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ohm_tsd_slam_tpu_torch.core import se2
from ohm_tsd_slam_tpu_torch.registration import filters as flt
from ohm_tsd_slam_tpu_torch.registration.estimators import (
    closed_form_2d_paired,
)
from ohm_tsd_slam_tpu_torch.registration.icp import IcpParams, IcpState
from ohm_tsd_slam_tpu_torch.registration.nn import assign_pairs_plain
from ohm_tsd_slam_tpu_torch.utils.testing import limit_cpu_threads

limit_cpu_threads()

# the package's `icp` is the function: the module by its name
icp_mod = importlib.import_module("ohm_tsd_slam_tpu_torch.registration.icp")

# non-view aten ops an ICP iteration dispatches (closed form, bounds, the
# gate and the reciprocal rule; the assignment counted as one call): 121
# before the iteration was written in wide ops (13 of them host-side
# scalar wraps), 55 after (2 scalar wraps and the assignment's call)
ICP_OPS_PER_ITERATION = 55
S = 541
BOUNDS = (0.0, 9.0, 0.0, 9.5)
POSE = ((0.8, -0.6, 0.5), (0.6, 0.8, 0.5), (0.0, 0.0, 1.0))


def closed_form_reference(pm, scene, pair_mask):
    """The closed-form estimate as eight masked sums, each by itself."""
    n = pair_mask.sum().clamp(min=1).to(pm.dtype)

    def mean(x):
        return torch.sum(torch.where(pair_mask, x, 0.0)) / n

    rms = mean(torch.sum((pm - scene) ** 2, dim=1))
    cmx, cmy = mean(pm[:, 0]), mean(pm[:, 1])
    csx, csy = mean(scene[:, 0]), mean(scene[:, 1])
    xf, yf = pm[:, 0] - cmx, pm[:, 1] - cmy
    xs, ys = scene[:, 0] - csx, scene[:, 1] - csy
    nom = torch.sum(torch.where(pair_mask, yf * xs - xf * ys, 0.0))
    den = torch.sum(torch.where(pair_mask, xf * xs + yf * ys, 0.0))
    dtheta = torch.atan2(nom, den)
    c, s = torch.cos(dtheta), torch.sin(dtheta)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    T = torch.stack([torch.stack([c, -s, cmx - (c * csx - s * csy)]),
                     torch.stack([s, c, cmy - (c * csy + s * csx)]),
                     torch.stack([zero, zero, one])])
    return T, rms, pair_mask.sum()


def icp_reference(model, model_mask, scene, scene_mask, params, pose):
    """ICP (fused assignment, closed form) with the scene transformed
    twice an iteration and the freeze on separate 0-d tensors."""
    dtype = scene.dtype
    thresh2 = flt.distance_threshold_schedule(
        params.dist_max, params.dist_min, params.dist_iterations,
        length=params.iterations, dtype=dtype)
    T = torch.eye(3, dtype=dtype)
    rms_prev = torch.full((), 10e12, dtype=dtype)
    conv = torch.zeros((), dtype=torch.int32)
    done = torch.zeros((), dtype=torch.bool)
    state = torch.full((), int(IcpState.PROCESSING), dtype=torch.int32)
    rms_h, pair_h, ran = [], [], []
    for it in range(params.iterations):
        cur = se2.transform_points(T, scene)
        smask = flt.out_of_bounds_filter_2d(cur, scene_mask, pose,
                                            *params.bounds)
        _, _, pmask, pm = assign_pairs_plain(model, model_mask, cur, smask,
                                             model, thresh2[it], True)
        T_last, rms, npairs = closed_form_reference(pm, cur, pmask)
        matchable = npairs > 2
        T_new = torch.where(matchable, T_last @ T, T)
        rms = torch.where(matchable, rms, rms_prev)
        plateau = (rms - rms_prev).abs() < params.conv_eps
        conv_new = torch.where(plateau, conv + 1, 0).to(torch.int32)
        success = matchable & ((rms <= params.max_rms)
                               | (conv_new >= params.convergence_count))
        last = (IcpState.MAXITERATIONS if it + 1 >= params.iterations
                else IcpState.PROCESSING)
        new_state = torch.where(
            ~matchable, int(IcpState.NOTMATCHABLE),
            torch.where(success, int(IcpState.SUCCESS),
                        int(last))).to(torch.int32)
        rms_h.append(torch.where(done, torch.nan, rms))
        pair_h.append(torch.where(done, 0, npairs))
        ran.append(~done)
        T = torch.where(done, T, T_new)
        conv = torch.where(done, conv, conv_new)
        state = torch.where(done, state, new_state)
        rms_prev = torch.where(done, rms_prev, rms)
        done = done | ~matchable | success
    pair_h = torch.stack(pair_h)
    iters = torch.stack(ran).sum()
    return icp_mod.IcpResult(
        T=T, rms=rms_prev, pairs=pair_h[max(int(iters) - 1, 0)],
        iterations=iters, state=state, rms_history=torch.stack(rms_h),
        pair_history=pair_h)


def clouds(seed, dtype, noise=0.02, p_scene=0.9):
    """Model points in a 10 m square, the scene a shifted noisy copy whose
    masked-out rows are NaN."""
    g = torch.Generator().manual_seed(seed)
    model = torch.rand(S, 2, generator=g, dtype=torch.float64) * 10.0
    scene = (model + noise * torch.randn(S, 2, generator=g,
                                         dtype=torch.float64) + 0.05)
    model_mask = torch.rand(S, generator=g) < 0.95
    scene_mask = torch.rand(S, generator=g) < p_scene
    scene[~scene_mask] = torch.nan
    return model.to(dtype), model_mask, scene.to(dtype), scene_mask


def same_bits(a, b) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.numpy().tobytes() == b.numpy().tobytes())


# estimator cases: pair mask
PAIRS = {"random": lambda g: torch.rand(S, generator=g) < 0.6,
         "few_pairs": lambda g: torch.arange(S) < 2,
         "no_pairs": lambda g: torch.zeros(S, dtype=torch.bool),
         "nan_rows": lambda g: torch.rand(S, generator=g) < 0.6}
# icp cases: (IcpParams fields, noise, scene share, the exit state)
EXITS = {"plateau": (dict(max_rms=0.0, convergence_count=5), 0.0, 0.9,
                     IcpState.SUCCESS),
         "max_rms": (dict(max_rms=1e-3, convergence_count=25), 0.02, 0.9,
                     IcpState.SUCCESS),
         "max_iterations": (dict(max_rms=0.0, convergence_count=25), 0.02,
                            0.9, IcpState.MAXITERATIONS),
         "unmatchable": (dict(max_rms=0.0, convergence_count=5), 0.02,
                         0.003, IcpState.NOTMATCHABLE)}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", [*PAIRS, *EXITS])
def test_iteration_matches_the_reference(case, dtype):
    """The estimator on one pair set, or the whole loop to one of its
    exits, in every bit of every output; after an exit the histories read
    NaN and 0."""
    if case in PAIRS:
        g = torch.Generator().manual_seed(len(case))
        pm, _, scene, scene_mask = clouds(3, dtype)
        mask = PAIRS[case](g)
        if case == "nan_rows":        # NaN only where no pair is
            mask = mask & scene_mask
        else:
            scene = torch.nan_to_num(scene)
        pm = torch.where(mask[:, None], pm, 0.0)   # the assignment's zeros
        T, rms, n = closed_form_2d_paired(pm, scene, mask)
        T_ref, rms_ref, n_ref = closed_form_reference(pm, scene, mask)
        assert same_bits(T, T_ref) and same_bits(rms, rms_ref)
        assert n.dtype == dtype and int(n) == int(n_ref) == int(mask.sum())
        assert torch.isfinite(T).all()
        return
    fields, noise, p_scene, exit_state = EXITS[case]
    params = IcpParams(iterations=25, dist_iterations=15, bounds=BOUNDS,
                       **fields)
    model, model_mask, scene, scene_mask = clouds(5, dtype, noise, p_scene)
    pose = torch.tensor(POSE, dtype=dtype)
    got = icp_mod.icp(model, model_mask, scene, scene_mask, params,
                      sensor_pose=pose)
    want = icp_reference(model, model_mask, scene, scene_mask, params, pose)
    for f in ("T", "rms", "pairs", "iterations", "state", "rms_history",
              "pair_history"):
        assert same_bits(getattr(got, f), getattr(want, f)), f
    n = int(got.iterations)
    assert int(got.state) == exit_state
    assert (n == 25) == (exit_state == IcpState.MAXITERATIONS), n
    assert torch.isnan(got.rms_history[n:]).all()
    assert not torch.isnan(got.rms_history[:n]).any()
    assert (got.pair_history[n:] == 0).all()


class _Ops(TorchDispatchMode):
    """Counts the non-view aten ops dispatched while `counting`."""

    def __init__(self):
        super().__init__()
        self.n = 0
        self.counting = True

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.counting and not func.is_view:
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_icp_iteration_op_count(monkeypatch):
    """The non-view aten ops of one ICP iteration with the node's
    parameters (bounds, the distance gate and the reciprocal rule on, the
    closed-form estimator), as the difference between a 2-iteration and a
    1-iteration call, the pair assignment (one kernel's call on the card)
    counted as one: 121 before the iteration was written in wide ops, 55
    now (ICP_OPS_PER_ITERATION)."""
    mode = _Ops()

    def assign(*args, **kwargs):
        mode.counting = False
        out = assign_pairs_plain(*args, **kwargs)
        mode.counting = True
        mode.n += 1
        return out

    monkeypatch.setattr(icp_mod, "assign_pairs_fused", assign)
    model, model_mask, scene, scene_mask = clouds(7, torch.float32)
    pose = torch.tensor(POSE)
    counts = []
    for iterations in (1, 2):
        params = IcpParams(iterations=iterations, dist_iterations=15,
                           convergence_count=25, bounds=BOUNDS)
        mode.n = 0
        with mode:
            icp_mod.icp(model, model_mask, scene, scene_mask, params,
                        sensor_pose=pose)
        counts.append(mode.n)
    assert counts[1] - counts[0] <= ICP_OPS_PER_ITERATION, counts
