"""A cell cut down to a size the CPU runs in seconds: 0.1 m cells over
the same 25.6 m (map_size 8) and 271 beams of 1 degree.  The tests that
drive the harness on the CPU use it; the chip runs the real cells."""

from __future__ import annotations

import copy

import torch

from slambench import harness


def cell(name: str, root: str = harness.ROOT) -> harness.Cell:
    c = harness.load_cell(name, root)
    cfg = copy.deepcopy(c.config)
    cfg["map_size"], cfg["cellsize"] = 8, 0.1
    cfg["assumed"]["scanner"].update(beams=271, increment_deg=1.0)
    c.config = cfg
    c.traffic = dict(c.traffic, warmup_s=0.1)
    return c


def run(c: harness.Cell, seed: int, seconds: float) -> harness.Run:
    """Set-up and window of `c` on the CPU."""
    torch.set_num_threads(2)
    r = harness.Run(c, seed, seconds, trace=False, device="cpu")
    r.setup()
    r.run_window()
    return r
