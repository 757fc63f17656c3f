"""Kernel C's (csrc/segment_min.cu, segment_min_kernel) share of its
roofline in %: the bound for the pairs it tests (segment_sweep_ms) over
the median device time of its launches in the traced run's profiler
sessions.  A scan's pairs are its beams times the segments C swept: the
program's counter `segments_swept` (each step's
LocalizeResult.segments_swept, brought back by the gates' read: the
reach cull's count where the step culls, else the cache's), the median
over the sessions' scans.  None on a program without that counter."""

from __future__ import annotations

import statistics

# operations a (beam, segment) pair: two cross products against the
# sensor, the two divisions and the compares of the candidate test
# (PERF.md's kernel table, row 4)
OPS_PER_PAIR = 20


def segment_sweep_ms(beams: int, segments: float) -> float:
    """The least time of level 0 of kernel C for `beams` beams over
    `segments` segments: its operations over the float32 rate (the pack
    it reads, 28 bytes a segment, is read once a launch and bounds
    nothing)."""
    from slambench import rooflines

    return rooflines.bound_ms(segments * 28 + beams * 28,
                              beams * segments * OPS_PER_PAIR)


def probe(run):
    from slambench import spans

    spans.start(run)


def read(run):
    from slambench import tracing

    times = tracing.kernel_ms(run.sessions, "segment_min_kernel")
    rec = getattr(run, "span_recorder", None)
    if not times or rec is None:
        return None
    spans_ = [s.span for s in run.sessions if s.scans]
    swept = [n for name, t, n, _ in rec.count_events()
             if name == "segments_swept"
             and any(lo <= t <= hi for lo, hi in spans_)]
    if not swept:
        return None
    bound = segment_sweep_ms(run.cell.assumed["scanner"]["beams"],
                             statistics.median(swept))
    return 100.0 * bound / statistics.median(times)
