"""The window's 95th-percentile scan latency (host clock, due to return),
as a per-layer reading for a cell whose open-loop rate lies near its
knee: at 80 scans/s the double-laser node runs at 75-93% of what it
sustains, so each 2-s publication queues scans behind it and the tail
swings from run to run (PERF.md §2); it has no bound there."""

from __future__ import annotations

import numpy as np


def read(run):
    lat = run.window.latency
    return float(np.percentile(np.asarray(lat) * 1e3, 95)) if lat else None
