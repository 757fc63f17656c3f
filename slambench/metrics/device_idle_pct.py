"""The device's idle share in the window, in %: 100 × (1 − the device's
busy ms a scan × the window's scans a second).  The busy ms a scan is the
union of the device's operation intervals over the scans of the traced
run's profiler sessions; the rate is the same run's untraced window's.
Inside a session the profiler's own buffer flushes hold the host for
10-20 ms at a time, so the sessions' own span would count them as idle
device time (PERF.md, §3)."""

from __future__ import annotations


def read(run):
    from slambench import tracing

    scans = sum(len(s.scans) for s in run.sessions)
    busy = sum(tracing.busy_ns(s) for s in run.sessions)
    w = run.window
    if not scans or not busy or not w.span:
        return None
    return 100.0 * (1.0 - busy * 1e-9 / scans * w.attempted / w.span)
