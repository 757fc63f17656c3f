"""Device-idle ms a scan that the program's own host code holds: over
the traced run's profiler-session scans, the time inside the
`process_scan` span (ohm_tsd_slam_tpu_torch/utils/spans.py) at which the
profiler saw no device operation, that lies under one of the scan's
innermost spans other than the two host reads, and outside every host
record of the session: the CUDA runtime's calls, whose time the
profiler's instrumentation stretches, and its own buffer work
(slambench/spans.py).  Summed over the scans, divided by their number."""

from __future__ import annotations


def probe(run):
    from slambench import spans

    spans.start(run)


def read(run):
    from slambench import spans

    scans = spans.scans(run, profiled=True)
    if not scans:
        return None
    total = 0
    for sc in scans:
        idle = spans.subtract([(sc.root.start_ns, sc.root.end_ns)],
                              sc.merged(sc.session.device))
        leaves = sc.merged(
            (r.name, r.start_ns, r.end_ns) for r in sc.descendants()
            if not spans.is_device(r) and r.name not in spans.READS
            and all(spans.is_device(c) for c in sc.children(r)))
        total += spans.length(spans.subtract(
            spans.intersect(idle, leaves), sc.merged(sc.session.host)))
    return total * 1e-6 / len(scans)
