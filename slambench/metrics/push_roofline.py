"""The push kernel's (csrc/push.cu, tsd_push_kernel) share of its
roofline in %: the bound for the whole grid read and written once
(rooflines.push_ms) over the median device time of its launches in the
traced run's profiler sessions."""

from __future__ import annotations

import statistics


def read(run):
    from slambench import rooflines, tracing

    times = tracing.kernel_ms(run.sessions, "tsd_push_kernel")
    if not times:
        return None
    cfg = run.config
    bound = rooflines.push_ms(cfg.grid.cells_per_side,
                              run.cell.assumed["scanner"]["beams"],
                              cfg.grid.tile_dim)
    return 100.0 * bound / statistics.median(times)
