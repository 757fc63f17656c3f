"""The nearest-model-point kernel's (csrc/nearest_model.cu,
nearest_model_kernel) share of its roofline in %: the bound for the pairs
it tests (nearest_model_ms) over the median device time of its launches
in the traced run's profiler sessions.  A scan's pairs are the program's
counter `ransac_pairs` (each mode-1 step's LocalizeResult.ransac_pairs,
brought back by the gates' read: Σ over the candidates that pass
cand_valid of their control points in the model's view, times the valid
model points), the median over the sessions' scans.  None on a program
without that counter or kernel."""

from __future__ import annotations

import math
import statistics

# operations a (control point, model point) pair, from the kernel's inner
# loop: two products, two sums, one fused multiply-add (the doubled cross
# term subtracted), the compare and two selects.  Built with -fmad=false,
# each issues on its own, where the float32 rate counts a fused
# multiply-add as two operations: about 50% is this share's ceiling.
OPS_PER_PAIR = 8


def nearest_model_ms(pairs: float, queries: int) -> float:
    """The least time of the kernel for `pairs` pairs over `queries`
    (candidate, control point) queries: the larger of the pairs'
    operations over the float32 rate and the bytes of the queries (st and
    q2 read, d2min, idx and the payload's two values written: 28 bytes a
    query in float32) over the HBM rate."""
    from slambench import rooflines

    return rooflines.bound_ms(queries * 28, pairs * OPS_PER_PAIR)


def queries(run) -> int:
    """Candidates × control points of the cell's matcher: trials × the
    2·span scene beams of each (span: phi_max over the scan's increment,
    registration/ransac.py::RansacParams.span) × the control set."""
    rc = run.config.robots[0].registration.ransac
    inc = math.radians(run.cell.assumed["scanner"]["increment_deg"])
    phi = min(math.radians(rc.phi_max_deg), math.pi * 0.5)
    span = max(1, int(math.floor(phi / inc)))
    return rc.trials * 2 * span * rc.size_control_set


def probe(run):
    from slambench import spans

    spans.start(run)


def read(run):
    from slambench import tracing

    times = tracing.kernel_ms(run.sessions, "nearest_model_kernel")
    rec = getattr(run, "span_recorder", None)
    if not times or rec is None:
        return None
    spans_ = [s.span for s in run.sessions if s.scans]
    pairs = [n for name, t, n, _ in rec.count_events()
             if name == "ransac_pairs"
             and any(lo <= t <= hi for lo, hi in spans_)]
    if not pairs:
        return None
    bound = nearest_model_ms(statistics.median(pairs), queries(run))
    return 100.0 * bound / statistics.median(times)
