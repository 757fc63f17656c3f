"""Device ms a scan: the union of the device's operation intervals over
the scans of the traced run's profiler sessions (from each session's
first scan start to its last return), divided by their scans."""

from __future__ import annotations


def read(run):
    from slambench import tracing

    scans = sum(len(s.scans) for s in run.sessions)
    if not scans:
        return None
    busy = sum(tracing.busy_ns(s) for s in run.sessions)
    return busy * 1e-6 / scans if busy else None
