"""Host ms of one call of the compiled step inside a scan: the median,
over the scans the traced run records with no profiler running
(slambench/spans.py), of the program's `localize_step_jit` span (the
cache key, the copy into the graph's buffers, the generator's state, the
graph's launch and the clones of its outputs;
ohm_tsd_slam_tpu_torch/utils/compiled.py)."""

from __future__ import annotations


def probe(run):
    from slambench import spans

    spans.start(run)


def read(run):
    from slambench import spans

    scans = spans.scans(run, profiled=False)
    if not scans:
        return None
    return spans.median((s.end_ns - s.start_ns) * 1e-6 for sc in scans
                        for s in sc.children(name="localize_step_jit"))
