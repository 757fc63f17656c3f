"""Times of the PyTorch port's segment pack (kernel B) and candidate sweep
(kernel C) on one CUDA card, through the wrappers' signatures alone, so the
same file measures any checkout of the port that is given it.  Run it from
the root of the checkout:

    python3 tools/torch_sweep_times.py

It takes the timers and the room of that checkout's chip_smoke.py.  Inputs:
three scans of the room pushed into a 1024^2 grid of 0.025 m cells (a few
thousand segments), 1081 beams, and the pack of a noise field cut to 8192,
16384 and all 32768 segments.

Kernel B: the wrapper's time between CUDA events and its device work (the
wrapper replayed from a CUDA graph; it only allocates and launches).
Kernel C, at each segment count: the device work of a sweep of K = 1 from
the march's start, of K = ROUNDS-1 from t_after for the beams that round 1
left unresolved, and of K = ROUNDS from the start; then, between CUDA
events on the host's clock, the two ways a scan can get its candidates:
K = 1, the three ops that build t_after, K = ROUNDS-1 (the JAX package's
pattern), against one sweep of K = ROUNDS.  The two must give the
unresolved beams the same later candidates, which is asserted.  Beside
them, on the room and the host's clock, the two stages the kernels serve:
`extract_segments` and `raycast_fast`.  Every line ends with the card's
name and power limit.
"""

from __future__ import annotations

import math
import os
import statistics
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from ohm_tsd_slam_tpu_torch.config import GridConfig  # noqa: E402
from ohm_tsd_slam_tpu_torch.core import se2  # noqa: E402
from ohm_tsd_slam_tpu_torch.grid import raycast_fast as rf  # noqa: E402
from ohm_tsd_slam_tpu_torch.grid.state import create, from_arrays  # noqa: E402
from ohm_tsd_slam_tpu_torch.ops.push_cuda import push_cuda  # noqa: E402
from ohm_tsd_slam_tpu_torch.sensor.polar2d import standard_mask  # noqa: E402
from ohm_tsd_slam_tpu_torch.utils.testing import (  # noqa: E402
    field_arrays,
    noise_field,
)

POSE = (12.8, 12.8, 0.1)


def room(dev, geom):
    grid = create(GridConfig(map_size=10, cellsize=0.025), device=dev)
    for xyt in [(12.8, 12.8, 0.0), (13.1, 12.9, 0.3), (12.4, 13.2, -0.4)]:
        data, mask = standard_mask(geom, torch.as_tensor(
            cs.scan_ranges(xyt, geom.max_range), dtype=torch.float32,
            device=dev))
        grid = push_cuda(grid, geom, se2.make(*xyt, device=dev), data, mask)
    return grid


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_sweep_times: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    label = cs.card_label()
    ks = rf.cuda_kernels()
    geom = cs.geom_1081()
    S = rf.MAX_SEGMENTS

    def report(name, ms):
        q1, _, q3 = statistics.quantiles(ms, n=4)
        print(f"{name}: median {statistics.median(ms):.4f} ms, quartiles "
              f"{q1:.4f}-{q3:.4f} ms, n={len(ms)} [{label}]")

    grids = {"room": room(dev, geom),
             "noise": from_arrays(field_arrays(
                 noise_field(1024, seed=3).astype(np.float32), 0.025),
                 device=dev)}
    mask, rows = ks.segment_layers(grids["room"])
    _, total = ks.pack_rows(grids["room"], mask, rows, S)

    def pack():
        ks.pack_rows(grids["room"], mask, rows, S)

    report(f"B pack_rows wrapper ({int(total)} segments)", cs.time_cuda(pack))
    report(f"B pack_rows device ({int(total)} segments)",
           cs.time_device(pack))
    report("extract_segments, events (room)",
           cs.time_cuda(lambda: rf.extract_segments(grids["room"])))

    for name, counts in (("room", (None,)), ("noise", (8192, 16384, S))):
        grid = grids[name]
        seg = rf.extract_segments(grid)
        pose = se2.make(*POSE, device=dev)
        ray, tr, idx_min, idx_max, feasible = rf.beam_geometry(grid, geom,
                                                               pose)
        lo = (torch.floor(idx_min) - 1.0).clamp(min=0.0)
        hi = torch.ceil(idx_max) + 1.0
        tr_pack = (tr - seg.origin).contiguous()
        if name == "room":
            report("raycast_fast, events (room, cached segments)",
                   cs.time_cuda(lambda: rf.raycast_fast(grid, geom, pose,
                                                        segments=seg)))
        for n in counts:
            count = seg.count if n is None else seg.count.clamp(max=n)
            start = (seg.pack, count, ray, lo, hi, lo, tr_pack)
            t_1 = ks.segment_min(*start)[:, 0]
            has = torch.isfinite(t_1) & feasible
            k_1 = torch.where(has, t_1, 0.0)
            state = ks.window_replay(grid, k_1, ray, idx_min, idx_max, has,
                                     tr.contiguous())
            resolved = (state[:, 1] > 0.0) | ~has

            def two_sweeps():
                first = ks.segment_min(*start)[:, 0]
                t_after = torch.where(
                    resolved, math.inf,
                    torch.maximum(lo, torch.where(has, first, 0.0)
                                  + rf.COVER))
                return ks.segment_min(seg.pack, count, ray, lo, hi, t_after,
                                      tr_pack, rf.ROUNDS - 1, rf.COVER)

            def one_sweep():
                return ks.segment_min(*start, rf.ROUNDS, rf.COVER)[:, 1:]

            assert torch.equal(one_sweep()[~resolved],
                               two_sweeps()[~resolved]), (name, n)
            after = start[:5] + (torch.where(
                resolved, math.inf, torch.maximum(lo, k_1 + rf.COVER)),
                tr_pack)
            tag = (f"{name}, {int(count)} segments, "
                   f"{int((~resolved).sum())} beams unresolved")
            for what, args, levels in (
                    ("K=1 from the start", start, 1),
                    (f"K={rf.ROUNDS - 1} from t_after", after,
                     rf.ROUNDS - 1),
                    (f"K={rf.ROUNDS} from the start", start, rf.ROUNDS)):
                report(f"C segment_min device, {what} ({tag})",
                       cs.time_device(lambda: ks.segment_min(
                           *args, levels, rf.COVER)))
            report(f"C two sweeps and the ops between, events ({tag})",
                   cs.time_cuda(two_sweeps))
            report(f"C one sweep, events ({tag})", cs.time_cuda(one_sweep))
    return 0


if __name__ == "__main__":
    sys.exit(main())
