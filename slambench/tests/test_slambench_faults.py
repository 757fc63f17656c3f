"""The check catches the faults a cell can have: the timed path broken
underneath a run (on the CPU, at a tiny size), and `correct` comes out
false.  A cell on one card has no exchange between chips to leave out."""

from __future__ import annotations

import pytest
import torch

import ohm_tsd_slam_tpu_torch.slam.node as node_mod
from slambench import check, harness
from slambench.tests import tiny

REAL_STEP = node_mod.localize_step_jit


def _unchanged(*args, **kwargs):
    """A step that returns the robot's state unchanged."""
    res = REAL_STEP(*args, **kwargs)
    return res._replace(pose=args[1], significant=torch.zeros_like(
        res.significant))


def _altered(*args, **kwargs):
    """The pose altered by 1 mm where the step produces it."""
    res = REAL_STEP(*args, **kwargs)
    pose = res.pose.clone()
    pose[0, 2] += 1e-3
    return res._replace(pose=pose)


def _half_push(run):
    """Half of the scan's beams left out of the map update."""
    push = run.node.mapper._push_fn

    def half(grid, geom, pose, data, mask):
        keep = torch.zeros_like(mask)
        keep[::2] = True
        return push(grid, geom, pose, data, mask & keep)
    run.node.mapper._push_fn = half


@pytest.mark.parametrize("fault", ["unchanged", "altered", "half_push"])
@pytest.mark.parametrize("name", ["double-laser.live-walk",
                                  "single-laser.live-walk"])
def test_a_broken_step_is_not_correct(monkeypatch, name, fault):
    c = tiny.cell(name)
    torch.set_num_threads(2)
    run = harness.Run(c, 1_234_567_891, 0.5, trace=False, device="cpu")
    run.setup()
    if fault == "half_push":
        _half_push(run)
    else:
        monkeypatch.setattr(node_mod, "localize_step_jit",
                            {"unchanged": _unchanged,
                             "altered": _altered}[fault])
    run.run_window()
    values = check.readings(run.evidence, run.device)
    assert not check.verdict(values, c.limits), values
