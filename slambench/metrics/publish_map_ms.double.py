"""Host ms of one SlamNode.publish_map in the double-laser live window
(the occupancy grid and the colour image, each read back to the host, so
each call ends synchronised): the median of the window's calls.  Apart
from publish_map_ms.single because this cell reports no bounded tail."""

from __future__ import annotations

import statistics


def read(run):
    times = run.window.publish
    return statistics.median(times) * 1e3 if times else None
