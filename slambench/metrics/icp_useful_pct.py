"""The share of ICP's iterations that did work, in %: 100 × the
program's counter `icp_iterations_useful` (each step's
LocalizeResult.icp_iterations, brought back by the gates' read) over
`icp_iterations_run` (the iterations each such step ran: all of
params.icp.iterations, in a graph with a frozen carry;
ohm_tsd_slam_tpu_torch/slam/node.py), over every scan the traced run
records (slambench/spans.py)."""

from __future__ import annotations


def probe(run):
    from slambench import spans

    spans.start(run)


def read(run):
    from slambench import spans

    got = spans.taken(run)
    if got is None:
        return None
    counters = got[1]
    ran = counters.get("icp_iterations_run", 0)
    if not ran:
        return None
    return 100.0 * counters.get("icp_iterations_useful", 0) / ran
