"""The check in upstream's RANSAC modes EXP (1) and PDF (2), which the
plain reference runs though no cell does yet: single-laser with its
registration_mode changed, no new configuration file.

On the CPU, at tiny.cell's size with the RANSAC draws cut further (10
trials, 40 control points: the CPU scores each candidate against every
model beam), the reference equals the node in every bit over a short
stream, and each fault of test_slambench_faults.py makes `correct` false.
On the card (`cuda`), at published widths through a 4.5-s window, the
program passes the check under single-laser's limits and bfloat16 fails
it.
"""

from __future__ import annotations

import pytest
import torch

import ohm_tsd_slam_tpu_torch.slam.node as node_mod
from slambench import check, harness
from slambench.reference import slam as R
from slambench.tests import test_slambench_faults as faults
from slambench.tests import tiny

MODES = {"exp": 1, "pdf": 2}
SEED = 1_234_567_891


def mode_cell(mode: int, cpu: bool) -> harness.Cell:
    """single-laser.live-walk in registration mode `mode`; on the CPU cut
    to tiny.cell's size and 10 trials of 40 control points."""
    name = "single-laser.live-walk"
    c = tiny.cell(name) if cpu else harness.load_cell(name)
    c.config = dict(c.config, registration_mode=mode)
    if cpu:
        c.config.update(trials=10, sizeControlSet=40)
    return c


def test_the_reference_runs_modes_0_to_3():
    for mode in (0, 1, 2, 3):
        assert R.deployment({"registration_mode": mode}).robots[0].mode == mode
    for mode in (-1, 4, 5):
        with pytest.raises(ValueError, match="registration_mode"):
            R.deployment({"registration_mode": mode})


@pytest.mark.parametrize("mode", list(MODES.values()), ids=list(MODES))
def test_reference_equals_the_cpu_node(monkeypatch, mode):
    c = mode_cell(mode, cpu=True)
    run = tiny.run(c, seed=3_000_000_019, seconds=1.0)
    ev = run.evidence
    assert len(ev.scans) == 16
    assert any(s.grid_after is not None for s in ev.scans)
    # the robot's own matcher seeds every sampled step, and moves some
    name = {1: "match_normal", 2: "match_pdf"}[mode]
    seeds = []
    matcher = getattr(R, name)

    def spy(*args, **kwargs):
        seeds.append(matcher(*args, **kwargs))
        return seeds[-1]
    monkeypatch.setattr(R, name, spy)
    values = check.readings(ev, run.device)
    assert len(seeds) == 16
    assert any(not torch.equal(T, torch.eye(3)) for T in seeds)
    assert {k: values[k] for k in check.NAMES} == dict.fromkeys(
        check.NAMES, 0)
    assert check.verdict(values, c.limits)


@pytest.mark.parametrize("fault", ["unchanged", "altered", "half_push"])
@pytest.mark.parametrize("mode", list(MODES.values()), ids=list(MODES))
def test_a_broken_step_is_not_correct(monkeypatch, mode, fault):
    c = mode_cell(mode, cpu=True)
    torch.set_num_threads(2)
    run = harness.Run(c, SEED, 0.5, trace=False, device="cpu")
    run.setup()
    if fault == "half_push":
        faults._half_push(run)
    else:
        monkeypatch.setattr(node_mod, "localize_step_jit",
                            {"unchanged": faults._unchanged,
                             "altered": faults._altered}[fault])
    run.run_window()
    values = check.readings(run.evidence, run.device)
    assert not check.verdict(values, c.limits), values


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES.values()), ids=list(MODES))
def test_the_check_at_published_widths(mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = mode_cell(mode, cpu=False)
    run = harness.Run(c, 2_700_000_000 + mode, 4.5, trace=False)
    run.setup()
    run.run_window()
    torch.cuda.synchronize()
    run.free_program()
    program = check.readings(run.evidence, run.device)
    assert check.verdict(program, c.limits), program
    bf16 = check.readings(run.evidence, run.device, "bf16")
    assert not check.verdict(bf16, c.limits), bf16
