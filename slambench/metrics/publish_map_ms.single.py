"""Host ms of one SlamNode.publish_map in the single-laser live window
(the occupancy grid and the colour image, each read back to the host, so
each call ends synchronised): the median of the window's calls."""

from __future__ import annotations

import statistics


def read(run):
    times = run.window.publish
    return statistics.median(times) * 1e3 if times else None
