"""The plain reference against the port's CPU node: over a short stream
of each deployment the check's numbers are all 0, the start, the sampled
steps, the pushes and the publications equal in every bit."""

from __future__ import annotations

import pytest

from slambench import check
from slambench.tests import tiny


@pytest.mark.parametrize("name", ["double-laser.live-walk",
                                  "single-laser.live-walk",
                                  "double-laser.replay-walk"])
def test_reference_equals_the_cpu_node(name):
    c = tiny.cell(name)
    run = tiny.run(c, seed=3_000_000_019, seconds=2.1)
    ev = run.evidence
    assert len(ev.scans) == 16
    assert any(s.grid_after is not None for s in ev.scans)
    assert len(ev.publishes) == (1 if "live" in name else 0)
    values = check.readings(ev, run.device)
    assert {k: values[k] for k in check.NAMES} == dict.fromkeys(
        check.NAMES, 0)
    assert check.verdict(values, c.limits)
