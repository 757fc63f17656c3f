"""Profiler sessions of a traced run, and what is read from them.

A session is torch.profiler over a few scans (device activity, with the
CUDA runtime calls and the profiler's own buffer handling on the host
side), with idle host time at both ends: the profiler drops device records that
its clock places outside the session, and sessions of more than some 15
scans lost records on this card.  The harness marks each scan's start and
return with the host's wall clock, the profiler's own time base.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

PAD_S = 0.05
NAME_CHARS = 160         # a device operation's name is cut to this length


@dataclass
class Session:
    device: List[Tuple[str, int, int]]          # (name, start ns, end ns)
    host: List[Tuple[str, int, int]]
    scans: List[Tuple[int, int]] = field(default_factory=list)

    @property
    def span(self) -> Tuple[int, int]:
        """From the first scan's start to the last one's return."""
        return self.scans[0][0], self.scans[-1][1]


def session(drive: Callable) -> Session:
    """drive(mark) under the profiler; drive calls mark(robot) as a scan
    starts and mark(None) as it returns."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    scans: List[list] = []

    def mark(robot: Optional[int]) -> None:
        t = time.time_ns()
        if robot is not None:
            scans.append([t, t])
        elif scans:
            scans[-1][1] = t

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PAD_S)
        drive(mark)
        torch.cuda.synchronize()
        time.sleep(PAD_S)
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        rec = (e.name(), e.start_ns(), e.end_ns())
        (dev if e.device_type() == DeviceType.CUDA else host).append(rec)
    dev.sort(key=lambda x: x[1])
    return Session(dev, host, [tuple(s) for s in scans])


def union(intervals, lo: int, hi: int) -> List[Tuple[int, int]]:
    """The merged intervals, clipped to [lo, hi]."""
    out: List[list] = []
    for _, s, e in sorted(intervals, key=lambda x: x[1]):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def busy_ns(s: Session) -> int:
    lo, hi = s.span
    return sum(e - b for b, e in union(s.device, lo, hi))


def span_ns(s: Session) -> int:
    lo, hi = s.span
    return hi - lo


def kernel_ms(sessions: List[Session], symbol: str) -> List[float]:
    """Device time of each launch of the kernel named `symbol`, in ms."""
    pat = re.compile(rf"(?<!\w){re.escape(symbol)}(?!\w)")
    return [(e - b) * 1e-6 for s in sessions for name, b, e in s.device
            if pat.search(name)]


def _label(s: Session, t: int) -> str:
    """What the host was doing at t: the innermost host event around it,
    under the scan it belongs to."""
    inner = None
    for name, b, e in s.host:
        if b <= t < e and (inner is None or b >= inner[1]):
            inner = (name, b)
    in_scan = any(b <= t < e for b, e in s.scans)
    where = "in process_scan" if in_scan else "between scans"
    return f"{where}: {inner[0]}" if inner else where


def breakdown(sessions: List[Session], top: int = 10) -> dict:
    """The device operations that took most time, summed by name, and the
    longest idle gaps inside the sessions' spans with what the host did."""
    by_name: dict = {}
    gaps = []
    for s in sessions:
        lo, hi = s.span
        for name, b, e in s.device:
            b, e = max(b, lo), min(e, hi)
            if e > b:
                by_name[name] = by_name.get(name, 0) + (e - b)
        busy = union(s.device, lo, hi)
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        for b, e in zip(edges[0::2], edges[1::2]):
            if e > b:
                gaps.append((e - b, (b + e) // 2, s))
    ops = sorted(by_name.items(), key=lambda x: -x[1])[:top]
    gaps.sort(key=lambda x: -x[0])
    return {"device_ops": [[n[:NAME_CHARS], ns * 1e-9] for n, ns in ops],
            "idle_gaps": [[_label(s, mid), ns * 1e-9]
                          for ns, mid, s in gaps[:top]]}
