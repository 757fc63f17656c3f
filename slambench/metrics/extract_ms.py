"""Device ms of one re-extraction of the fast caster's segments: the
median, over the scans that pushed among those the traced run records
with no profiler running (slambench/spans.py), of the CUDA-event
interval of SlamNode's `extract` span inside `map_update` (kernels A and
B, or the dense layers and E, and the candidate pack, for the new grid
version; ohm_tsd_slam_tpu_torch/slam/node.py::_segments_for).  None on a
program without that span."""

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
                        for ms in spans.device_ms(sc, ("map_update",
                                                       "extract")))
