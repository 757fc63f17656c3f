"""Seconds the node's compiled entry points spent capturing their CUDA
graphs in set-up: the sum of `capture_s` over the graphs of
localize_step_jit and extract_segments_jit (utils/compiled.py's own
counter).  Read before any probe captures more."""

from __future__ import annotations


def probe(run):
    from ohm_tsd_slam_tpu_torch.grid.raycast_fast import extract_segments_jit
    from ohm_tsd_slam_tpu_torch.slam.localize import localize_step_jit

    return sum(sum(fn.compiled.capture_s)
               for fn in (localize_step_jit, extract_segments_jit))


def read(run):
    return run.probes.get("graph_capture_s")
