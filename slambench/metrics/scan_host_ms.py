"""Host ms of one scan inside SlamNode.process_scan that is the program's
own work: the median, over the scans the traced run records with no
profiler running (slambench/spans.py), of the program's `process_scan`
span (ohm_tsd_slam_tpu_torch/utils/spans.py) less its `read_gates` and
`read_pose` children, the two host reads in which the host waits for
the card."""

from __future__ import annotations


def probe(run):
    from slambench import spans

    spans.start(run)


def read(run):
    from slambench import spans

    scans = spans.scans(run, profiled=False)
    if not scans:
        return None
    return spans.median(
        (sc.root.end_ns - sc.root.start_ns
         - sum(r.end_ns - r.start_ns for r in sc.children()
               if r.name in spans.READS)) * 1e-6 for sc in scans)
