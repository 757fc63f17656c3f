"""Kernel A's (csrc/segment_layers.cu, segment_layers_kernel) share of
its roofline in %: the bound for the field read and the 4-layer mask and
row counts written (rooflines.segment_layers_ms) over the median device
time of its launches in the traced run's profiler sessions."""

from __future__ import annotations

import statistics


def read(run):
    from slambench import rooflines, tracing

    times = tracing.kernel_ms(run.sessions, "segment_layers_kernel")
    if not times:
        return None
    bound = rooflines.segment_layers_ms(run.config.grid.cells_per_side)
    return 100.0 * bound / statistics.median(times)
