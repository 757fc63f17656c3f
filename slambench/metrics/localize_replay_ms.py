"""Device ms of the compiled step inside the window's own scans: the
median, over the scans the traced run records with no profiler running
(slambench/spans.py), of the CUDA-event interval around
`localize_step_jit`'s graph replay (its `replay` span's device interval,
ohm_tsd_slam_tpu_torch/utils/spans.py), each on the node's state of that
scan.  localize_step_ms replays robot 0's last scan 20 times after the
window instead."""

from __future__ import annotations


def probe(run):
    from slambench import spans

    spans.start(run)


def read(run):
    from slambench import spans

    scans = spans.scans(run, profiled=False)
    if not scans:
        return None
    return spans.median(ms for sc in scans for ms in spans.device_ms(
        sc, ("localize_step_jit", "replay")))
