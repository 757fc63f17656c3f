"""Device ms of the RANSAC seed inside each localize_step_jit replay of
the traced run's profiler sessions: the device's busy time (the union of
its operations) from the end of the render's last kernel (kernel D's
rounds, window_rounds_kernel) to the start of ICP's first pair assignment
(assign_rows_kernel) after it, the median over the sessions' scans.  A
replay runs its kernels in a fixed order, render, matcher, ICP, so the
interval holds the matcher's work, and besides ICP's set-up before its
first assignment (registration/icp.py: its constant fills, the distance
schedule, the homogeneous scene and the first iteration's transform),
and the exact march's on a scan whose fast render overflowed (none so
far).  Idle time inside the interval is not counted: under the profiler
the device idles 6-9 ms a replay (H100) after the caster's conditional
graph node sets its flag (utils/compiled.py::when), which a replay
without the profiler does not.
None where no scan shows both kernels."""

from __future__ import annotations

import re
import statistics

RENDER_LAST = "window_rounds_kernel"
ICP_FIRST = "assign_rows_kernel"


def _named(symbol: str):
    return re.compile(rf"(?<!\w){re.escape(symbol)}(?!\w)")


def seed_ms(session) -> list:
    """Each scan's device busy ms from its first RENDER_LAST launch's end
    to the start of the first ICP_FIRST launch after it."""
    from slambench import tracing

    render, icp = _named(RENDER_LAST), _named(ICP_FIRST)
    out = []
    for lo, hi in session.scans:
        ops = [(n, b, e) for n, b, e in session.device if lo <= b <= hi]
        end = next((e for n, _, e in ops if render.search(n)), None)
        if end is None:
            continue
        start = next((b for n, b, _ in ops if b >= end and icp.search(n)),
                     None)
        if start is not None:
            busy = tracing.union(ops, end, start)
            out.append(sum(e - b for b, e in busy) * 1e-6)
    return out


def read(run):
    times = [t for s in run.sessions for t in seed_ms(s)]
    return statistics.median(times) if times else None
