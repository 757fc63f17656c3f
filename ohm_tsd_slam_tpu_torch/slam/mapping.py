"""Map-update worker (port of ohm_tsd_slam_tpu/slam/mapping.py).

ThreadMapping (src/ThreadMapping.cpp): grid writes serialized behind a
lock-guarded queue drained newest-first (ThreadMapping.cpp:43-63).  The
reference deep-copies the sensor on queuePush (:65-76); the queued
tensors are never written in place, so holding them is the snapshot.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable

from ohm_tsd_slam_tpu_torch.grid.push import push
from ohm_tsd_slam_tpu_torch.grid.state import TsdGrid
from ohm_tsd_slam_tpu_torch.sensor.polar2d import SensorPolar2D
from ohm_tsd_slam_tpu_torch.utils import spans

INIT_PSHS = 1  # initial pushes on first scan (SlamNode.h:30)


class Mapper:
    def __init__(self, push_fn: Callable = push):
        self._queue: deque = deque()
        self._lock = threading.Lock()
        self._initialized = False
        self._push_fn = push_fn

    def initialized(self) -> bool:
        """ThreadMapping::initialized (lock-free read, as in the
        reference, ThreadLocalize.cpp:257)."""
        return self._initialized

    def init_push(self, grid: TsdGrid, geom: SensorPolar2D, pose, data,
                  mask) -> TsdGrid:
        """ThreadMapping::initPush (ThreadMapping.cpp:32-41): push the
        first sensor INIT_PSHS times synchronously."""
        for _ in range(INIT_PSHS):
            grid = self._push(grid, geom, pose, data, mask)
        self._initialized = True
        return grid

    def queue_push(self, geom: SensorPolar2D, pose, data, mask) -> None:
        """ThreadMapping::queuePush: enqueue a snapshot."""
        with self._lock:
            self._queue.append((geom, pose, data, mask))
        self._initialized = True

    def pending(self) -> int:
        with self._lock:
            return len(self._queue)

    def drain(self, grid: TsdGrid) -> TsdGrid:
        """Process the queue newest-first until empty
        (ThreadMapping.cpp:49-56 pops from the back)."""
        while True:
            with self._lock:
                if not self._queue:
                    return grid
                geom, pose, data, mask = self._queue.pop()
            grid = self._push(grid, geom, pose, data, mask)

    def _push(self, grid: TsdGrid, geom: SensorPolar2D, pose, data,
              mask) -> TsdGrid:
        """One push: a span `push` and the counter `pushes` with the span
        recorder on (utils/spans.py)."""
        spans.count("pushes")
        with spans.span("push"):
            return self._push_fn(grid, geom, pose, data, mask)
