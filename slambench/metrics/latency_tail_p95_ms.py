"""The window's 95th-percentile scan latency (host clock, due to return),
as a per-layer reading for a live cell whose tail swings from run to run
more than any bound can hold (PERF.md §2).  Double laser: at 80 scans/s
the node runs at 75-93% of what it sustains, so each 2-s publication
queues scans behind it.  Single laser: the tail is a few scans, those
behind a publication and those queued behind a host stall of 20-60 ms,
and it follows the process's device mode with the median; its two sets
of six runs spread by about a fifth.  It has no bound in either."""

from __future__ import annotations

import numpy as np


def read(run):
    lat = run.window.latency
    return float(np.percentile(np.asarray(lat) * 1e3, 95)) if lat else None
