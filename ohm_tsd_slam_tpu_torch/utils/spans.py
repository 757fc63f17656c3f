"""The port's span recorder: where a scan's host time goes, on the
profiler's clock.

Off by default; `enable()` turns it on for the process, `disable()` off,
`reset()` drops what it holds.  Nothing in the program turns it on: the
benchmark's traced run does (slambench/spans.py), as do
`python -m ohm_tsd_slam_tpu_torch run --spans PATH` and the tests.

    with spans.span("preprocess"):
        ...
    with spans.span("replay"), spans.device_interval("replay", device):
        graph.replay()
    spans.count("pushes")

A span records (id, parent id, trace id, name, start, end, thread id,
attrs).  Its parent is the innermost span open on the same thread; its
trace id is the one given to the outermost span (SlamNode.process_scan
gives (robot, scan counter)) and is inherited by every span under it,
those of the compiled entry points among them.  Start and end are
`time.time_ns()`: Unix epoch ns, the clock torch.profiler stamps its
host and device events in, so a span can be laid over a profiler
session's records.  The thread id is the native one, as the profiler's.
Each thread appends to lists of its own (the threaded runtime localizes
in several threads); `records()` merges them by start.

`device_interval(name, device)` puts a pair of timing CUDA events on the
device's current stream around a region.  The events come from a pool
made in `enable()`: making an event, or recording one the first time,
inside a scan would put that cost into what is measured.  They resolve
to device ms only in `records()`, after a synchronize.  When the pool
runs out, `count("device_intervals_dropped")` counts the interval not
recorded.  A device interval is a record of its own under the span it
sits in, with `attrs["device_ms"]`; its start and end are the host times
at which its two events were enqueued.  For a device that is not CUDA it
records nothing.

`count(name, n)` adds to a host counter; each call is kept with its time
and trace id, and `counters()` gives the totals.

Off, `span()` and `device_interval()` return one shared null context and
`count()` returns at once: each reads one global and records nothing.

`write_chrome_trace(path)` writes the spans as complete events and the
counters as counter events in the Chrome trace format, timed as
torch.profiler's `export_chrome_trace` times its events (µs from
libkineto's base time, the epoch floored to 7,889,238-s intervals), so
the two files line up in Perfetto or chrome://tracing.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch

POOL_EVENTS = 4096            # timing events made by enable()
# libkineto's ChromeTraceBaseTime interval (torch/profiler/
# _chrome_trace_export.py::_trimester_base_ns)
TRACE_BASE_S = 7889238


class Record(NamedTuple):
    """One span, or one device interval (attrs["device_ms"])."""

    id: int
    parent: Optional[int]
    trace: Optional[tuple]
    name: str
    start_ns: int
    end_ns: int
    thread: int
    attrs: dict


class _Buffer:
    """What one thread recorded, and its open spans."""

    def __init__(self):
        self.thread = threading.get_native_id()
        self.stack: list = []       # (id, trace id) of the open spans
        self.records: List[Record] = []
        self.counts: list = []      # (name, ns, n, trace id)
        self.pending: list = []     # (attrs, start event, end event)


_NULL = contextlib.nullcontext()
_on = False
_ids = itertools.count(1)
_lock = threading.Lock()
_buffers: List[_Buffer] = []
_local = threading.local()
_pool: list = []                    # free timing events
_pool_device: Optional[torch.device] = None


def _buffer() -> _Buffer:
    buf = getattr(_local, "buf", None)
    if buf is None:
        buf = _local.buf = _Buffer()
        with _lock:
            _buffers.append(buf)
    return buf


def _top(buf: _Buffer) -> tuple:
    return buf.stack[-1] if buf.stack else (None, None)


# --------------------------------------------------------------------------
# the switch
# --------------------------------------------------------------------------

def enable() -> None:
    """Record from now on.  Where there is a CUDA card, the first call
    makes the pool of timing events on the current device and records
    each once, so that none is made inside a scan."""
    global _on, _pool_device
    if _pool_device is None and torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
        stream = torch.cuda.current_stream(dev)
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(POOL_EVENTS)]
        for e in events:
            e.record(stream)
        stream.synchronize()
        with _lock:
            _pool.extend(events)
        _pool_device = dev
    _on = True


def disable() -> None:
    """Record nothing more; what was recorded stays until `reset()`."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def reset() -> None:
    """Drop every record and count; the events of intervals not yet
    resolved go back to the pool."""
    with _lock:
        bufs = list(_buffers)
    for buf in bufs:
        for _, e0, e1 in buf.pending:
            with _lock:
                _pool.extend((e0, e1))
        buf.pending.clear()
        buf.records.clear()
        buf.counts.clear()


# --------------------------------------------------------------------------
# recording
# --------------------------------------------------------------------------

class _Span:
    __slots__ = ("name", "trace", "attrs", "id", "parent", "start_ns", "buf")

    def __init__(self, name: str, trace, attrs: dict):
        self.name, self.trace, self.attrs = name, trace, attrs

    def __enter__(self) -> "_Span":
        buf = self.buf = _buffer()
        self.parent, trace = _top(buf)
        if self.trace is None:
            self.trace = trace
        self.id = next(_ids)
        buf.stack.append((self.id, self.trace))
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.time_ns()
        buf = self.buf
        buf.stack.pop()
        buf.records.append(Record(self.id, self.parent, self.trace,
                                  self.name, self.start_ns, end, buf.thread,
                                  self.attrs))
        return False


def span(name: str, trace: Optional[tuple] = None, **attrs):
    """A context manager that records a span `name` with `attrs` (its
    `.attrs` may be added to inside).  `trace` names the trace of an
    outermost span; a span under another takes its trace.  Off: the
    shared null context, which gives None to `as`."""
    if not _on:
        return _NULL
    return _Span(name, trace, attrs)


def add(name: str, start_ns: int, **attrs) -> None:
    """Record a span `name` from `start_ns` (a `time.time_ns()` read
    earlier) to now, under the innermost open span: for a step whose
    span is known to be wanted only once it has run."""
    if not _on:
        return
    end = time.time_ns()
    buf = _buffer()
    parent, trace = _top(buf)
    buf.records.append(Record(next(_ids), parent, trace, name, start_ns,
                              end, buf.thread, attrs))


class _Interval:
    __slots__ = ("name", "stream", "events", "start_ns")

    def __init__(self, name: str, stream, events: tuple):
        self.name, self.stream, self.events = name, stream, events

    def __enter__(self) -> None:
        self.start_ns = time.time_ns()
        self.events[0].record(self.stream)

    def __exit__(self, *exc) -> bool:
        self.events[1].record(self.stream)
        end = time.time_ns()
        buf = _buffer()
        parent, trace = _top(buf)
        attrs = {"device_ms": None}
        buf.records.append(Record(next(_ids), parent, trace, self.name,
                                  self.start_ns, end, buf.thread, attrs))
        buf.pending.append((attrs, *self.events))
        return False


def device_interval(name: str, device: torch.device):
    """A context manager that times the device work it encloses on
    `device`'s current stream (see the module docstring); the null
    context when off, for a device that is not CUDA and inside a CUDA
    graph capture (an event recorded there would join the graph)."""
    if (not _on or device.type != "cuda"
            or torch.cuda.is_current_stream_capturing()):
        return _NULL
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    with _lock:
        ok = (_pool_device is not None and index == _pool_device.index
              and len(_pool) >= 2)
        events = (_pool.pop(), _pool.pop()) if ok else None
    if events is None:
        count("device_intervals_dropped")
        return _NULL
    return _Interval(name, torch.cuda.current_stream(device), events)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name`."""
    if not _on:
        return
    buf = _buffer()
    buf.counts.append((name, time.time_ns(), n, _top(buf)[1]))


# --------------------------------------------------------------------------
# export
# --------------------------------------------------------------------------

def _resolve() -> None:
    """Device ms of every interval recorded so far (one synchronize);
    their events go back to the pool."""
    with _lock:
        bufs = list(_buffers)
    pending = [p for buf in bufs for p in buf.pending]
    if not pending:
        return
    torch.cuda.synchronize(_pool_device)
    for buf in bufs:
        for attrs, e0, e1 in buf.pending:
            attrs["device_ms"] = e0.elapsed_time(e1)
            with _lock:
                _pool.extend((e0, e1))
        buf.pending.clear()


def records() -> List[Record]:
    """Every span and device interval recorded since the last `reset()`,
    by start (device ms resolved)."""
    _resolve()
    with _lock:
        bufs = list(_buffers)
    out = [r for buf in bufs for r in list(buf.records)]
    out.sort(key=lambda r: (r.start_ns, r.id))
    return out


def count_events() -> list:
    """Every `count()` call since the last `reset()`, as (name, ns, n,
    trace id), by time."""
    with _lock:
        bufs = list(_buffers)
    return sorted((c for buf in bufs for c in list(buf.counts)),
                  key=lambda c: c[1])


def counters() -> Dict[str, int]:
    """The total of each counter since the last `reset()`."""
    out: Dict[str, int] = {}
    for name, _, n, _ in count_events():
        out[name] = out.get(name, 0) + n
    return out


def write_chrome_trace(path: str) -> None:
    """The records and counters as a Chrome trace (JSON) at `path`: a
    complete event a span or device interval (its attrs, id, parent and
    trace id in `args`), a counter event a `count()` with the running
    total.  Timed as torch.profiler's Chrome traces (module docstring)."""
    recs, counts = records(), count_events()
    first = min([r.start_ns for r in recs] + [c[1] for c in counts]
                + [time.time_ns()])
    base = first // 10 ** 9 // TRACE_BASE_S * TRACE_BASE_S * 10 ** 9
    pid = os.getpid()

    def us(ns: int) -> float:
        return (ns - base) / 1e3

    events = []
    for r in recs:
        args = dict(r.attrs, id=r.id, parent=r.parent,
                    trace=None if r.trace is None else list(r.trace))
        events.append({"name": r.name, "ph": "X",
                       "cat": "device" if "device_ms" in r.attrs else "span",
                       "ts": us(r.start_ns), "dur": (r.end_ns - r.start_ns)
                       / 1e3, "pid": pid, "tid": r.thread, "args": args})
    totals: Dict[str, int] = {}
    for name, ns, n, _ in counts:
        totals[name] = totals.get(name, 0) + n
        events.append({"name": name, "ph": "C", "ts": us(ns), "pid": pid,
                       "args": {name: totals[name]}})
    with open(path, "w") as f:
        json.dump({"displayTimeUnit": "ms", "baseTimeNanoseconds": base,
                   "traceEvents": events}, f)
