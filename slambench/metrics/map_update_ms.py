"""Device ms of one map update: the median, over the scans that pushed
among those the traced run records with no profiler running
(slambench/spans.py), of the CUDA-event interval around SlamNode's
`map_update` span (the queued push and the new grid's segment
extraction; ohm_tsd_slam_tpu_torch/utils/spans.py)."""

from __future__ import annotations


def probe(run):
    from slambench import spans

    spans.start(run)


def read(run):
    from slambench import spans

    scans = spans.scans(run, profiled=False)
    if not scans:
        return None
    return spans.median(ms for sc in scans
                        for ms in spans.device_ms(sc, ("map_update",)))
