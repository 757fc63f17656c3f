"""On the card, at each cell's own size and load: the program passes the
check, and the control, the plain reference computed in the nearest lower
precision (TF32 products, where the program keeps TF32 off) put in the
program's place, fails it; so does bfloat16.  The limits were set from
these readings over 12 seeds a cell (PERF.md, "correct")."""

from __future__ import annotations

import pytest

from slambench import check, harness


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["double-laser.live-walk",
                                  "single-laser.live-walk",
                                  "double-laser.replay-walk"])
def test_the_control_fails(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = harness.load_cell(name)
    run = harness.Run(c, 2_900_000_003, 4.5, trace=False)
    run.setup()
    run.run_window()
    torch.cuda.synchronize()
    run.node = None
    program = check.readings(run.evidence, run.device)
    assert check.verdict(program, c.limits), program
    tf32 = check.readings(run.evidence, run.device, "tf32")
    assert tf32["pose_gap_m"] > c.limits["pose_gap_m"], tf32
    bf16 = check.readings(run.evidence, run.device, "bf16")
    assert not check.verdict(bf16, c.limits), bf16
