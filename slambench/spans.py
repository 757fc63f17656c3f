"""The program's own spans and counters in a traced run
(ohm_tsd_slam_tpu_torch/utils/spans.py), and what the readers of
metrics/ share to read them.

`start(run)` is the readers' probe.  The harness runs the probes in
BENCHMARK.json's order after the window and right before the profiler
sessions; these readers come last there.  Once a run, it

  * drives a second node through the stream as set-up and the window
    drove the first, so that it reaches the window's start in the same
    state, and records the window's first RECORDED_SCANS scans on it,
    at the window's arrivals, with no profiler running: inside a
    profiler session the CUDA runtime's calls are instrumented, and a
    replay's one graph launch there held the host 12-19 ms against
    0.1 ms without (PERF.md §6), so a host span timed there measures
    the profiler;
  * leaves the recorder on for the sessions, whose device records say
    when the card was idle under which span.

The untraced window runs before any probe, with the recorder off.  On a
program without the recorder every number read from it is None.

A session's host records are the CUDA runtime's calls, which the
profiler's instrumentation stretches, and the profiler's own buffer work
(`Buffer Flush`, `Activity Buffer Request`), which stalls the host for
10-20 ms at a time inside a session and is no work of the program.
"""

from __future__ import annotations

import gc
import statistics
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from slambench import tracing

# children of process_scan in which the host waits for the card
READS = ("read_gates", "read_pose")
RECORDED_SCANS = 90     # scans recorded with no profiler, a run

Intervals = List[Tuple[int, int]]


def start(run) -> None:
    """Once a run: the recorded scans with no profiler, then the
    recorder left on for the sessions (see the module docstring)."""
    try:
        from ohm_tsd_slam_tpu_torch.utils import spans
    except ImportError:         # a program without the recorder
        return None
    if getattr(run, "span_recorder", None) is None:
        run.span_recorder = spans
        _record_window_start(run, spans)
    return None


def _record_window_start(run, spans) -> None:
    """The window's first RECORDED_SCANS scans again on a second node,
    recorded: the node is started and warmed up from the stream's first
    scans as set-up did (the program is a function of the seed and its
    inputs, so it reaches the state the window started from; the step's
    graphs are the first node's, keyed alike), then driven through the
    scans at the window's arrivals, without publication.  The first node
    is left as it was."""
    import torch

    from ohm_tsd_slam_tpu_torch.slam.node import SlamNode

    first = len(run.config.robots) * (1 + run.warmup)
    scans = run.order[first:first + RECORDED_SCANS]
    main = run.node
    run.node = node = SlamNode(run.config, dtype=torch.float32,
                               device=run.device, seed=run.seed)
    try:
        for r, k in run.order[:first]:
            node.process_scan(r, run.msgs[r][k])
        run._sync()
        spans.enable()
        spans.reset()
        if run.open_loop:
            run._paced(run._events(scans, publish=False), record=False)
        else:
            for r, k in scans:
                run._scan(r, k, sample=False)
        run._sync()
    finally:
        run.node = main
    del node
    gc.collect()


def taken(run) -> Optional[tuple]:
    """(records, counters) the recorder took since `start`, read once a
    run; None where it never started."""
    got = getattr(run, "span_records", None)
    if got is None:
        rec = getattr(run, "span_recorder", None)
        if rec is None:
            return None
        got = run.span_records = (rec.records(), rec.counters())
    return got


class Scan:
    """One recorded scan: its `process_scan` span, every record under it,
    and the profiler session it ran in (None for the scans recorded with
    no profiler)."""

    def __init__(self, root, children: Dict[int, list], session):
        self.root, self.session = root, session
        self._children = children

    def children(self, record=None, name: Optional[str] = None) -> list:
        """The records right under `record` (the root by default), those
        named `name` only where given."""
        rid = (record or self.root).id
        return [r for r in self._children.get(rid, ())
                if name is None or r.name == name]

    def descendants(self) -> list:
        out, todo = [], [self.root]
        while todo:
            kids = self.children(todo.pop())
            out += kids
            todo += kids
        return out

    def merged(self, records) -> Intervals:
        """The union of (name, start, end) `records` inside the scan."""
        return tracing.union(records, self.root.start_ns, self.root.end_ns)


def scans(run, profiled: bool) -> Optional[List[Scan]]:
    """The recorded scans in order: those of the profiler sessions
    (`profiled`) or those recorded with no profiler; None without
    records."""
    got = taken(run)
    if got is None or not got[0]:
        return None
    recs = got[0]
    children: Dict[int, list] = defaultdict(list)
    for r in recs:
        if r.parent is not None:
            children[r.parent].append(r)
    out = []
    for r in recs:
        if r.name != "process_scan" or r.parent is not None:
            continue
        session = next((s for s in run.sessions if s.scans
                        and s.span[0] <= r.start_ns
                        and r.end_ns <= s.span[1]), None)
        if (session is not None) == profiled:
            out.append(Scan(r, children, session))
    return out


def is_device(record) -> bool:
    return "device_ms" in record.attrs


def device_ms(scan: Scan, path: Tuple[str, ...]) -> List[float]:
    """Device ms of the intervals at `path` below the scan's root: span
    names down to the span that holds the interval, e.g.
    ("localize_step_jit", "replay")."""
    level = [scan.root]
    for name in path:
        level = [c for r in level for c in scan.children(r, name)
                 if not is_device(c)]
    return [c.attrs["device_ms"] for r in level for c in scan.children(r)
            if is_device(c) and c.attrs["device_ms"] is not None]


def median(values) -> Optional[float]:
    values = list(values)
    return statistics.median(values) if values else None


# --------------------------------------------------------------------------
# intervals: sorted, disjoint (start ns, end ns), as tracing.union gives
# --------------------------------------------------------------------------

def length(a: Intervals) -> int:
    return sum(e - b for b, e in a)


def intersect(a: Intervals, b: Intervals) -> Intervals:
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if lo < hi:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(a: Intervals, b: Intervals) -> Intervals:
    """The parts of `a` outside `b`."""
    if not a:
        return []
    gaps = [(x, y) for x, y in zip([a[0][0]] + [e for _, e in b],
                                   [s for s, _ in b] + [a[-1][1]]) if x < y]
    return intersect(a, gaps)
